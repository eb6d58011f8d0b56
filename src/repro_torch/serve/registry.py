"""Multi-tenant index registry: named corpora behind one serving process.

One front end hosts many tenants — each a named corpus with its own fitted
index, query defaults, eval budget, rate limit, and telemetry — while
sharing the process's compute and its card.  The registry owns that
mapping (the JAX package's ``repro.serve.registry`` on PyTorch):

  * ``add(name, index=... | path=...)`` registers a tenant: a protocol
    index (built in-process or hot-loaded from a saved directory via
    ``load_index``), wrapped in its own ``SearchService`` (so coalescing
    happens per tenant — different corpora can never share a fused batch)
    and its own ``AdmissionController`` + ``Telemetry``.
  * Per-tenant ``QueryOptions`` (including the per-tenant eval ``budget``)
    are installed as the index's planner defaults; the attached
    ``Telemetry`` calibrates that tenant's planner from its own measured
    traffic.
  * Every tenant's service shares ONE execute gate (a semaphore of
    ``max_concurrent_batches``): tenant queues are isolated, the worker
    budget is global — a hot tenant cannot starve the process of threads,
    only contend for batch slots.
  * ``remove(name)`` hot-removes a tenant, draining its queue by default;
    ``add`` after ``remove`` (or for a brand-new name) needs no restart.

``submit`` is the one serving entry point: resolve tenant -> admission
verdict (shed raises ``AdmissionRejected``) -> ``SearchService.submit``
with the deadline propagated.

Tenants loaded from a path land on the registry's ``device`` (``"cuda"`` by
default; it raises without a card unless ``device="cpu"`` is passed).  Every
thread that touches a tenant's index enters its device first: each
tenant's dispatcher does, and the write path does around ``add`` /
``upsert`` / ``remove`` (the HTTP handler threads call it).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.factory import load_index
from repro_torch.api.query import Query, QueryOptions
from repro_torch.device import on_device, resolve_device
from repro_torch.launch.service import SearchService
from repro_torch.serve.admission import AdmissionController, AdmissionDecision, AdmissionRejected
from repro_torch.serve.telemetry import Telemetry


class UnknownTenant(KeyError):
    """No tenant registered under this name."""


class ImmutableTenant(TypeError):
    """Write submitted to a tenant whose index has no mutation surface."""


def _load_tenant_index(path, device):
    """Load a tenant index onto ``device`` from a saved index directory OR a
    durable WAL dir (recognised by its ``CURRENT`` checkpoint pointer) — the
    latter is how a tenant recovers after a crash: checkpoint + WAL-tail
    replay."""
    path = os.fspath(path)
    if os.path.exists(os.path.join(path, "CURRENT")):
        from repro_torch.store.durable import open_durable

        return open_durable(path, device=device)
    return load_index(path, device=device)


@dataclass
class Tenant:
    """One registered corpus: index + its serving stack."""

    name: str
    index: object
    service: SearchService
    admission: AdmissionController
    telemetry: Optional[Telemetry]

    def warmup(self, spec: Query, example_q: np.ndarray) -> None:
        """Build the kernels and run one batch of every bucket size for
        ``spec`` before traffic arrives."""
        self.service.warmup(spec, example_q)

    def stats(self) -> dict:
        """Deterministic per-tenant observability snapshot."""
        idx_stats = self.index.stats()
        return {
            "index": {
                "kind": idx_stats.get("kind"),
                "n_objects": int(idx_stats.get("n_objects", 0)),
                "metric": idx_stats.get("metric"),
            },
            "service": self.service.stats(),
            "admission": self.admission.counters(),
            "telemetry": self.telemetry.stage_costs() if self.telemetry else None,
        }


class IndexRegistry:
    """Named tenants -> serving stacks, sharing one worker budget.

    Args:
      max_concurrent_batches: global bound on batches executing at once
        across ALL tenants (None = unbounded).  Tenant dispatcher threads
        stay per-tenant; only batch execution contends on the shared gate.
      max_batch / max_wait_s / max_queue: per-tenant ``SearchService``
        defaults (overridable per ``add`` call).
      device: where tenants added by ``path=`` are loaded ("cuda" by
        default, "cpu" for the host path); tenants added by ``index=`` stay
        where they were built.
    """

    def __init__(self, *, max_concurrent_batches: Optional[int] = 4,
                 max_batch: int = 64, max_wait_s: float = 0.002,
                 max_queue: int = 256, device="cuda"):
        self.device = resolve_device(device)
        self._gate = (
            threading.BoundedSemaphore(int(max_concurrent_batches))
            if max_concurrent_batches is not None
            else None
        )
        self.max_concurrent_batches = max_concurrent_batches
        self._defaults = {
            "max_batch": int(max_batch),
            "max_wait_s": float(max_wait_s),
            "max_queue": int(max_queue),
        }
        self._tenants: Dict[str, Tenant] = {}
        self._lock = threading.Lock()
        self._closed = False

    # -- tenant lifecycle ------------------------------------------------------
    def add(self, name: str, index=None, *, path=None,
            query_options: Optional[QueryOptions] = None,
            rate: Optional[float] = None, burst: Optional[float] = None,
            degrade_at: Optional[float] = None,
            telemetry: bool = True,
            max_batch: Optional[int] = None,
            max_wait_s: Optional[float] = None,
            max_queue: Optional[int] = None) -> Tenant:
        """Register (hot-add) one tenant from a built index or a saved
        index directory.  Per-tenant ``QueryOptions`` become the planner
        defaults (``budget`` included); ``rate``/``burst`` configure the
        tenant's token bucket."""
        if (index is None) == (path is None):
            raise ValueError("pass exactly one of index= or path=")
        if index is None:
            index = _load_tenant_index(path, self.device)
        if query_options is not None:
            index.query_options = query_options
        telem = Telemetry() if telemetry else None
        if telem is not None:
            index.telemetry = telem
        mq = max_queue if max_queue is not None else self._defaults["max_queue"]
        service = SearchService(
            index,
            max_batch=max_batch if max_batch is not None else self._defaults["max_batch"],
            max_wait_s=max_wait_s if max_wait_s is not None else self._defaults["max_wait_s"],
            max_queue=mq,
            execute_gate=self._gate,
        )
        kwargs = {} if degrade_at is None else {"degrade_at": degrade_at}
        admission = AdmissionController(
            service, rate=rate, burst=burst, max_queue=mq,
            index_stats=index.stats, **kwargs,
        )
        tenant = Tenant(
            name=str(name), index=index, service=service,
            admission=admission, telemetry=telem,
        )
        with self._lock:
            if self._closed:
                service.close(drain=False)
                raise RuntimeError("registry is closed")
            if name in self._tenants:
                service.close(drain=False)
                raise ValueError(f"tenant {name!r} already registered")
            self._tenants[str(name)] = tenant
        return tenant

    def remove(self, name: str, *, drain: bool = True) -> None:
        """Hot-remove one tenant; ``drain=True`` flushes its queued requests
        through normal batches first (in-flight futures all resolve)."""
        with self._lock:
            tenant = self._tenants.pop(str(name), None)
        if tenant is None:
            raise UnknownTenant(name)
        tenant.service.close(drain=drain)
        if drain:
            self._flush_tenant(tenant)

    def tenant(self, name: str) -> Tenant:
        with self._lock:
            tenant = self._tenants.get(str(name))
        if tenant is None:
            raise UnknownTenant(name)
        return tenant

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    # -- the serving entry point -----------------------------------------------
    def submit(self, name: str, q: np.ndarray, spec: Query,
               *, deadline_s: Optional[float] = None):
        """Admission-checked submit to one tenant's service.

        Returns ``(future, AdmissionDecision)`` — the decision carries the
        (possibly degraded) spec that will actually execute.  Sheds raise
        ``AdmissionRejected`` with the decision attached.
        """
        tenant = self.tenant(name)
        decision = tenant.admission.admit(spec, deadline_s)
        if not decision.admitted:
            raise AdmissionRejected(decision)
        future = tenant.service.submit(q, decision.spec, deadline_s=deadline_s)
        return future, decision

    # -- the write path --------------------------------------------------------
    def upsert(self, name: str, rows: np.ndarray, ids=None, attrs=None) -> np.ndarray:
        """Admission-checked write-through to one tenant's online index.

        With ``ids=None`` rows are appended under fresh ids (``add``);
        otherwise existing ids are replaced / new ids inserted (``upsert``).
        Returns the row ids.  ``attrs`` (``{column: values}``) rides along
        into the tenant index's attribute store — and, on a durable tenant,
        into the WAL record — so filtered search stays consistent with the
        write.  Writes go through the same per-tenant admission layer as
        queries (shared token bucket), so a write burst is shed with
        ``AdmissionRejected`` exactly like a read burst; on a durable tenant
        the mutation is WAL-logged before it is applied.
        """
        tenant = self.tenant(name)
        index = self._writable_index(tenant)
        rows = np.atleast_2d(np.asarray(rows))
        if not len(rows):
            return np.empty(0, dtype=np.int64)
        decision = tenant.admission.admit_write(len(rows))
        if not decision.admitted:
            raise AdmissionRejected(decision)
        with on_device(index.device):
            if ids is None:
                return index.add(rows, attrs=attrs)
            return index.upsert(
                np.atleast_1d(np.asarray(ids, dtype=np.int64)), rows, attrs=attrs
            )

    def remove_rows(self, name: str, ids) -> None:
        """Admission-checked row removal from one tenant's online index."""
        tenant = self.tenant(name)
        index = self._writable_index(tenant)
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if not len(ids):
            return
        decision = tenant.admission.admit_write(len(ids))
        if not decision.admitted:
            raise AdmissionRejected(decision)
        with on_device(index.device):
            index.remove(ids)

    @staticmethod
    def _writable_index(tenant: Tenant):
        index = tenant.index
        if not (hasattr(index, "upsert") and hasattr(index, "remove")):
            raise ImmutableTenant(
                f"tenant {tenant.name!r} serves an immutable "
                f"{getattr(index, 'kind', type(index).__name__)!r} index; "
                "register it with build_index(mutable=True) or "
                "build_index(durable=True, wal_dir=...) to accept writes"
            )
        return index

    @staticmethod
    def _flush_tenant(tenant: Tenant) -> None:
        """Force-sync a durable tenant's WAL (drain flushes the log)."""
        flush = getattr(tenant.index, "flush", None)
        if callable(flush):
            flush()

    # -- lifecycle / observability ---------------------------------------------
    def stats(self) -> dict:
        """Deterministic (sorted-tenant) snapshot across the registry."""
        with self._lock:
            tenants = dict(self._tenants)
        return {
            "n_tenants": len(tenants),
            "max_concurrent_batches": self.max_concurrent_batches,
            "tenants": {name: tenants[name].stats() for name in sorted(tenants)},
        }

    def close(self, *, drain: bool = True) -> None:
        with self._lock:
            self._closed = True
            tenants = list(self._tenants.values())
            self._tenants.clear()
        for tenant in tenants:
            tenant.service.close(drain=drain)
            if drain:
                self._flush_tenant(tenant)

    def __enter__(self) -> "IndexRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = [
    "IndexRegistry",
    "ImmutableTenant",
    "Tenant",
    "UnknownTenant",
    "AdmissionDecision",
    "AdmissionRejected",
]
