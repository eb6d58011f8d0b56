"""HTTP/JSON request boundary: the network face of the serving stack.

The JAX package's ``repro.serve.frontend`` on PyTorch, with the same routes,
bodies and status mapping, so a client cannot tell the two apart.
Stdlib-only (``http.server``): a threading HTTP server in front of an
``IndexRegistry``.  Each connection handler thread
does the cheap work (parse, admission) and then blocks on the request's
future while the per-tenant ``SearchService`` dispatchers do the heavy
lifting in fused batches — so the boundary adds a queue hop, not a copy of
the execution engine.

Routes (all JSON bodies/responses):

  ``POST /v1/query``
      ``{"tenant": "...", "q": [...], "task": "knn"|"range", "k"|
      "threshold": ..., "mode"/"dims"/"refine"/"budget": optional,
      "where": optional attribute predicate (``Predicate.to_dict`` form:
      ``{"clauses": [{"attr", "op", "values"}, ...]}``), "filter_mode":
      optional strategy override, "deadline_ms": optional}`` ->
      ``{"ids", "distances", "approx", "degraded", "stats", "elapsed_ms"}``.
      The deadline propagates end to end: admission sheds requests whose
      deadline the queue-wait estimate already breaks (HTTP 429 +
      ``Retry-After``), the service drops it if it expires while queued
      (before wasting a batch slot), and discards the result if it expires
      in flight — both surface as HTTP 504.
  ``POST /v1/tenants/<name>/upsert``
      ``{"rows": [[...], ...], "ids": optional, "attrs": optional
      ``{column: [values]}`` for the tenant's attribute store}`` ->
      ``{"ids", "n_objects", "wal_synced"}``.  The write path of the durable ingest layer: rows
      land in the tenant's WAL before they are applied (``ids`` present =
      replace/insert at those ids; absent = append under fresh ids).
      Writes share the tenant's admission token bucket (429 + Retry-After
      on a burst) and 409 when the tenant's index is immutable.
  ``POST /v1/tenants/<name>/remove``
      ``{"ids": [...]}`` -> ``{"removed", "n_objects"}`` (tombstone rows).
  ``GET /v1/stats``     registry-wide observability snapshot.
  ``GET /v1/tenants``   registered tenant names.
  ``PUT /v1/tenants/<name>``    hot-add from a saved index directory:
      ``{"path": "...", "rate"/"burst"/"budget"/"mode"/"dims"/"refine":
      optional}`` (409 if the name exists).
  ``DELETE /v1/tenants/<name>`` hot-remove (drains queued requests).
  ``GET /v1/healthz``   liveness.

Status mapping: 400 malformed, 404 unknown tenant/route, 409 duplicate
tenant, 429 shed (with ``Retry-After``), 503 closed, 504 deadline
exceeded.

``FrontendClient`` is the matching stdlib (``http.client``) client used by
the tests and ``python -m repro_torch.launch.serve --workload frontend``.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from repro_torch.api.query import Query, QueryOptions
from repro_torch.filter.predicate import Predicate
from repro_torch.launch.service import DeadlineExceeded, ServiceClosed, ServiceOverloaded
from repro_torch.serve.admission import AdmissionRejected
from repro_torch.serve.registry import ImmutableTenant, IndexRegistry, UnknownTenant

__all__ = ["Frontend", "FrontendClient", "FrontendError"]

#: ceiling on how long a handler thread waits on an undeadlined request
DEFAULT_RESULT_TIMEOUT_S = 60.0

#: grace past the client deadline before the handler gives up waiting (the
#: service fails the future at the deadline; this only guards a lost wakeup)
DEADLINE_GRACE_S = 5.0

_QUERY_FIELDS = (
    "task", "k", "threshold", "mode", "dims", "refine", "budget", "filter_mode"
)


class _RequestError(Exception):
    """Internal: maps straight to one HTTP error response."""

    def __init__(self, status: int, message: str, *,
                 retry_after_s: Optional[float] = None, reason: str = ""):
        super().__init__(message)
        self.status = int(status)
        self.message = message
        self.retry_after_s = retry_after_s
        self.reason = reason


def _spec_from_body(body: dict) -> Query:
    kwargs = {k: body[k] for k in _QUERY_FIELDS if body.get(k) is not None}
    if isinstance(kwargs.get("threshold"), list):
        raise _RequestError(400, "threshold must be a scalar (one query per request)")
    where = body.get("where")
    if where is not None:
        # wire form is Predicate.to_dict: {"clauses": [{attr, op, values}...]}
        # — the parsed Predicate is canonicalised and hashable, so equal
        # JSON filters coalesce into the same service batch
        try:
            kwargs["where"] = Predicate.from_dict(where)
        except (TypeError, ValueError) as e:
            raise _RequestError(400, f"bad 'where' predicate: {e}") from None
    try:
        return Query(**kwargs)
    except (TypeError, ValueError) as e:
        raise _RequestError(400, f"bad query spec: {e}") from None


def _result_payload(res, decision, t0: float) -> dict:
    return {
        "ids": [int(i) for i in res.ids],
        "distances": None if res.distances is None else [float(d) for d in res.distances],
        "approx": res.approx,
        "degraded": bool(decision.degraded),
        "stats": {
            "original_calls": int(res.stats.original_calls),
            "surrogate_calls": int(res.stats.surrogate_calls),
            "candidates": int(res.stats.candidates),
            "bound_width": float(res.stats.bound_width),
        },
        "elapsed_ms": (time.perf_counter() - t0) * 1e3,
    }


class _Handler(BaseHTTPRequestHandler):
    # the server instance carries the frontend (set by Frontend.__init__)
    protocol_version = "HTTP/1.1"

    # -- plumbing --------------------------------------------------------------
    def log_message(self, fmt, *args):  # noqa: A003 — silence per-request stderr
        if self.server.frontend.verbose:
            super().log_message(fmt, *args)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            return {}
        raw = self.rfile.read(length)
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise _RequestError(400, f"invalid JSON body: {e}") from None
        if not isinstance(body, dict):
            raise _RequestError(400, "JSON body must be an object")
        return body

    def _send_json(self, status: int, payload: dict,
                   *, retry_after_s: Optional[float] = None) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after_s is not None:
            self.send_header("Retry-After", str(max(1, math.ceil(retry_after_s))))
        self.end_headers()
        self.wfile.write(data)

    def _dispatch(self, handler) -> None:
        try:
            status, payload = handler()
            self._send_json(status, payload)
        except _RequestError as e:
            body = {"error": e.message}
            if e.reason:
                body["reason"] = e.reason
            if e.retry_after_s is not None:
                body["retry_after_s"] = float(e.retry_after_s)
            self._send_json(e.status, body, retry_after_s=e.retry_after_s)
        except Exception as e:  # noqa: BLE001 — a handler bug must not kill the server
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    # -- routes ----------------------------------------------------------------
    def do_GET(self):  # noqa: N802 — http.server naming
        self._dispatch(self._get)

    def do_POST(self):  # noqa: N802
        self._dispatch(self._post)

    def do_PUT(self):  # noqa: N802
        self._dispatch(self._put)

    def do_DELETE(self):  # noqa: N802
        self._dispatch(self._delete)

    def _get(self):
        registry = self.server.frontend.registry
        if self.path == "/v1/healthz":
            return 200, {"status": "ok"}
        if self.path == "/v1/stats":
            return 200, registry.stats()
        if self.path == "/v1/tenants":
            return 200, {"tenants": registry.names()}
        raise _RequestError(404, f"no route {self.path!r}")

    def _post(self):
        if self.path.startswith("/v1/tenants/"):
            if self.path.endswith("/upsert"):
                return self._post_write(remove=False)
            if self.path.endswith("/remove"):
                return self._post_write(remove=True)
        if self.path != "/v1/query":
            raise _RequestError(404, f"no route {self.path!r}")
        body = self._read_body()
        t0 = time.perf_counter()
        tenant = body.get("tenant")
        if not tenant:
            raise _RequestError(400, "missing 'tenant'")
        q = body.get("q")
        if not isinstance(q, list) or not q:
            raise _RequestError(400, "'q' must be a non-empty list of floats")
        spec = _spec_from_body(body)
        deadline_s = None
        if body.get("deadline_ms") is not None:
            deadline_s = float(body["deadline_ms"]) * 1e-3
            if deadline_s <= 0:
                raise _RequestError(400, "deadline_ms must be positive")
        registry = self.server.frontend.registry
        try:
            future, decision = registry.submit(
                tenant, np.asarray(q, dtype=np.float64), spec, deadline_s=deadline_s
            )
        except UnknownTenant:
            raise _RequestError(404, f"unknown tenant {tenant!r}") from None
        except AdmissionRejected as e:
            raise _RequestError(
                429, "request shed by admission control",
                retry_after_s=e.decision.retry_after_s, reason=e.decision.reason,
            ) from None
        except ServiceOverloaded as e:
            raise _RequestError(429, str(e), retry_after_s=0.05,
                                reason="queue_full") from None
        except ServiceClosed as e:
            raise _RequestError(503, str(e)) from None
        timeout = (
            deadline_s + DEADLINE_GRACE_S
            if deadline_s is not None
            else DEFAULT_RESULT_TIMEOUT_S
        )
        try:
            res = future.result(timeout=timeout)
        except DeadlineExceeded as e:
            raise _RequestError(504, str(e), reason="deadline_exceeded") from None
        except ServiceClosed as e:
            raise _RequestError(503, str(e)) from None
        except TimeoutError:
            raise _RequestError(504, "timed out waiting for result") from None
        return 200, _result_payload(res, decision, t0)

    def _post_write(self, *, remove: bool):
        prefix = "/v1/tenants/"
        suffix = "/remove" if remove else "/upsert"
        name = self.path[len(prefix):-len(suffix)]
        if not name:
            raise _RequestError(404, f"no route {self.path!r}")
        body = self._read_body()
        registry = self.server.frontend.registry
        ids = body.get("ids")
        if ids is not None:
            if not isinstance(ids, list) or not all(isinstance(i, int) for i in ids):
                raise _RequestError(400, "'ids' must be a list of integers")
            ids = np.asarray(ids, dtype=np.int64)
        try:
            if remove:
                if ids is None or not len(ids):
                    raise _RequestError(400, "missing 'ids' (rows to remove)")
                registry.remove_rows(name, ids)
                out_ids = ids
            else:
                rows = body.get("rows")
                if not isinstance(rows, list) or not rows:
                    raise _RequestError(400, "'rows' must be a non-empty list of rows")
                try:
                    arr = np.atleast_2d(np.asarray(rows, dtype=np.float64))
                except (TypeError, ValueError) as e:
                    raise _RequestError(400, f"bad rows: {e}") from None
                if arr.ndim != 2:
                    raise _RequestError(400, "'rows' must be rectangular (R, dim)")
                attrs = body.get("attrs")
                if attrs is not None and (
                    not isinstance(attrs, dict)
                    or not all(isinstance(k, str) for k in attrs)
                ):
                    raise _RequestError(
                        400, "'attrs' must be an object mapping column -> values"
                    )
                out_ids = registry.upsert(name, arr, ids=ids, attrs=attrs)
        except UnknownTenant:
            raise _RequestError(404, f"unknown tenant {name!r}") from None
        except AdmissionRejected as e:
            raise _RequestError(
                429, "write shed by admission control",
                retry_after_s=e.decision.retry_after_s, reason=e.decision.reason,
            ) from None
        except ImmutableTenant as e:
            raise _RequestError(409, str(e)) from None
        except (KeyError, ValueError) as e:
            raise _RequestError(400, f"rejected write: {e}") from None
        stats = registry.tenant(name).index.stats()
        payload = {
            "n_objects": int(stats.get("n_objects", 0)),
            "wal_synced": int(stats.get("wal_synced", 0)),
        }
        if remove:
            payload["removed"] = [int(i) for i in out_ids]
        else:
            payload["ids"] = [int(i) for i in out_ids]
        return 200, payload

    def _tenant_from_path(self) -> str:
        prefix = "/v1/tenants/"
        if not self.path.startswith(prefix) or not self.path[len(prefix):]:
            raise _RequestError(404, f"no route {self.path!r}")
        return self.path[len(prefix):]

    def _put(self):
        name = self._tenant_from_path()
        body = self._read_body()
        path = body.get("path")
        if not path:
            raise _RequestError(400, "missing 'path' (saved index directory)")
        options = None
        opt_fields = {
            k: body[k] for k in ("mode", "dims", "refine", "budget")
            if body.get(k) is not None
        }
        if opt_fields:
            options = QueryOptions(**opt_fields)
        registry = self.server.frontend.registry
        try:
            tenant = registry.add(
                name, path=path, query_options=options,
                rate=body.get("rate"), burst=body.get("burst"),
            )
        except ValueError as e:
            status = 409 if "already registered" in str(e) else 400
            raise _RequestError(status, str(e)) from None
        except FileNotFoundError as e:
            raise _RequestError(400, f"cannot load index: {e}") from None
        return 201, {"tenant": name, "index": tenant.stats()["index"]}

    def _delete(self):
        name = self._tenant_from_path()
        try:
            self.server.frontend.registry.remove(name)
        except UnknownTenant:
            raise _RequestError(404, f"unknown tenant {name!r}") from None
        return 200, {"removed": name}


class _Server(ThreadingHTTPServer):
    #: connections the listening socket queues before accept: a burst of
    #: clients connecting at once would otherwise overflow socketserver's
    #: default of 5 and be reset
    request_queue_size = 1024
    daemon_threads = True


class Frontend:
    """The HTTP boundary over one ``IndexRegistry``.

    ``port=0`` binds an ephemeral port (tests); read the bound address from
    ``.address`` after construction.  ``start()`` serves on a daemon
    thread; ``close()`` stops the listener and (by default) closes the
    registry, draining every tenant.
    """

    def __init__(self, registry: IndexRegistry, *, host: str = "127.0.0.1",
                 port: int = 0, verbose: bool = False):
        self.registry = registry
        self.verbose = bool(verbose)
        self._httpd = _Server((host, int(port)), _Handler)
        self._httpd.frontend = self
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        """(host, bound port)."""
        return self._httpd.server_address[:2]

    def start(self) -> "Frontend":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-frontend", daemon=True
        )
        self._thread.start()
        return self

    def close(self, *, close_registry: bool = True, drain: bool = True) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if close_registry:
            self.registry.close(drain=drain)

    def __enter__(self) -> "Frontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


class FrontendError(RuntimeError):
    """Non-2xx frontend response; carries status + parsed body."""

    def __init__(self, status: int, body: dict):
        super().__init__(f"HTTP {status}: {body.get('error', body)}")
        self.status = int(status)
        self.body = body

    @property
    def retry_after_s(self) -> Optional[float]:
        v = self.body.get("retry_after_s")
        return float(v) if v is not None else None


class FrontendClient:
    """Minimal stdlib client for the frontend (one connection per call —
    handler threads may block on deadlines, so pooling buys little here)."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 70.0):
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> dict:
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout_s)
        try:
            data = json.dumps(body).encode() if body is not None else None
            headers = {"Content-Type": "application/json"} if data else {}
            conn.request(method, path, body=data, headers=headers)
            resp = conn.getresponse()
            payload = json.loads(resp.read() or b"{}")
            if resp.status >= 400:
                raise FrontendError(resp.status, payload)
            return payload
        finally:
            conn.close()

    def query(self, tenant: str, q, *, task: str = "knn", k: Optional[int] = None,
              threshold: Optional[float] = None, deadline_ms: Optional[float] = None,
              where=None, **spec_fields) -> dict:
        if where is not None and not isinstance(where, dict):
            where = where.to_dict()     # accept a Predicate directly
        body = {
            "tenant": tenant,
            "q": [float(x) for x in np.asarray(q).ravel()],
            "task": task,
            "k": k,
            "threshold": threshold,
            "deadline_ms": deadline_ms,
            "where": where,
            **spec_fields,
        }
        return self._request("POST", "/v1/query", {k: v for k, v in body.items() if v is not None})

    def stats(self) -> dict:
        return self._request("GET", "/v1/stats")

    def tenants(self) -> list:
        return self._request("GET", "/v1/tenants")["tenants"]

    def healthz(self) -> dict:
        return self._request("GET", "/v1/healthz")

    def upsert(self, tenant: str, rows, ids=None, attrs=None) -> dict:
        body = {"rows": [[float(x) for x in r] for r in np.atleast_2d(np.asarray(rows))]}
        if ids is not None:
            body["ids"] = [int(i) for i in np.atleast_1d(ids)]
        if attrs is not None:
            body["attrs"] = {
                str(name): np.asarray(values).reshape(-1).tolist()
                for name, values in attrs.items()
            }
        return self._request("POST", f"/v1/tenants/{tenant}/upsert", body)

    def remove_rows(self, tenant: str, ids) -> dict:
        return self._request(
            "POST", f"/v1/tenants/{tenant}/remove",
            {"ids": [int(i) for i in np.atleast_1d(ids)]},
        )

    def add_tenant(self, name: str, path: str, **fields) -> dict:
        return self._request("PUT", f"/v1/tenants/{name}", {"path": path, **fields})

    def remove_tenant(self, name: str) -> dict:
        return self._request("DELETE", f"/v1/tenants/{name}")
