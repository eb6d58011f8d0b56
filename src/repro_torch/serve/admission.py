"""Admission control: decide BEFORE queueing, shed instead of degrading tail.

The micro-batching runtime (``repro_torch.launch.service``) queues any
arrival rate, and under overload every request then waits behind the
queue.  A front end admits only what it can serve within the caller's
deadline and sheds the rest cheaply (an HTTP 429 costs microseconds; a
queued-then-expired request costs a batch slot and everyone behind it).
The JAX package's ``repro.serve.admission``, copied: host code over queue
depths, wait estimates and a token bucket, so both packages decide alike
for the same inputs and clock.

Policy, applied in order per request:

  1. **Token-bucket rate limit** (per tenant): burst-tolerant long-term
     rate cap; over-rate requests are rejected with the exact time until
     the next token (``Retry-After``).
  2. **Bounded queue**: when the tenant's service queue is at capacity the
     request is rejected outright (backpressure, not buffering).
  3. **Deadline feasibility**: a request whose deadline is shorter than the
     service's EWMA-estimated queue wait is degraded to the truncated-apex
     path (planned at half the wait, ``DEGRADE_WAIT_FACTOR``) when that rescues the deadline, and
     rejected immediately otherwise — it would only expire in queue and
     waste the slot.
  4. **Graceful degradation**: under queue pressure (but below shedding),
     ``mode="auto"`` queries are flipped to the truncated-apex approximate
     path (half the pivot distances, bounded refine) — serving *slightly
     worse answers fast* beats serving exact answers late.  Explicit
     ``mode="exact"``/``mode="approx"`` requests are never rewritten.

Decisions are returned as ``AdmissionDecision`` values (also raised inside
``AdmissionRejected`` by the registry/frontend paths) and every outcome is
counted, so shed rate and degrade rate are first-class observables.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Optional

from repro_torch.api.query import Query

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "AdmissionRejected",
    "DEFAULT_DEGRADE_AT",
    "DEFAULT_DEGRADE_REFINE",
    "DEGRADE_WAIT_FACTOR",
    "TokenBucket",
]

#: queue-pressure fraction above which auto-mode queries degrade to the
#: truncated-apex path (pressure = queue_depth / max_queue)
DEFAULT_DEGRADE_AT = 0.25

#: true-metric re-rank budget for degraded queries (small on purpose: the
#: point of degrading is shedding work)
DEFAULT_DEGRADE_REFINE = 32

#: assumed wait shrink when a query degrades to the truncated-apex path
#: (the JAX package's planning value, not measured on the H100): a deadline
#: the exact path's wait estimate breaks is still admitted — degraded —
#: when half the estimate fits it
DEGRADE_WAIT_FACTOR = 0.5


class AdmissionRejected(RuntimeError):
    """Raised (by registry/frontend submit paths) when a request is shed;
    carries the full ``AdmissionDecision`` including ``retry_after_s``."""

    def __init__(self, decision: "AdmissionDecision"):
        super().__init__(f"request shed: {decision.reason} "
                         f"(retry after {decision.retry_after_s:.3f}s)")
        self.decision = decision


@dataclass(frozen=True)
class AdmissionDecision:
    """One admission verdict: admitted (with the possibly-degraded spec to
    actually execute) or shed (with why and when to retry)."""

    admitted: bool
    reason: str                    # "ok" | "rate_limited" | "queue_full" | "deadline_unmeetable"
    spec: Optional[Query] = None   # the spec to execute (admitted only)
    retry_after_s: float = 0.0     # shed only: when capacity is expected
    degraded: bool = False         # admitted via the degradation flip
    estimated_wait_s: float = 0.0  # the wait estimate the verdict used


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` capacity.

    ``try_acquire`` returns 0.0 on success or the seconds until one token
    would be available (the Retry-After hint).  Thread-safe; the clock is
    injectable so tests are deterministic.
    """

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0:
            raise ValueError(f"rate must be positive; got {rate}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1; got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._t_last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return 0.0
            return (n - self._tokens) / self.rate


class AdmissionController:
    """Per-tenant admission policy over one ``SearchService``.

    Args:
      service:        the tenant's ``SearchService`` (supplies
                      ``queue_depth()`` / ``estimated_wait_s()``).
      rate / burst:   token-bucket rate limit in requests/s (None = no
                      rate limit).
      max_queue:      queue depth at which requests are shed (should match
                      the service's own ``max_queue`` bound).
      degrade_at:     queue-pressure fraction above which ``mode="auto"``
                      specs flip to the truncated-apex path (None = never
                      degrade).
      degrade_dims:   truncation dimension for degraded specs (default:
                      the index's ``n_pivots // 2``, resolved lazily from
                      ``index_stats``).
      degrade_refine: re-rank budget for degraded specs.
      index_stats:    callable returning the tenant index's ``stats()``
                      (used to resolve degrade dims and to gate degradation
                      to the truncatable table kinds).
    """

    def __init__(self, service, *, rate: Optional[float] = None,
                 burst: Optional[float] = None, max_queue: int = 256,
                 degrade_at: Optional[float] = DEFAULT_DEGRADE_AT,
                 degrade_dims: Optional[int] = None,
                 degrade_refine: int = DEFAULT_DEGRADE_REFINE,
                 index_stats: Optional[Callable[[], dict]] = None,
                 clock: Callable[[], float] = time.monotonic):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1; got {max_queue}")
        self.service = service
        self.bucket = (
            TokenBucket(rate, burst if burst is not None else max(1.0, rate), clock)
            if rate is not None
            else None
        )
        self.max_queue = int(max_queue)
        self.degrade_at = float(degrade_at) if degrade_at is not None else None
        self.degrade_dims = int(degrade_dims) if degrade_dims is not None else None
        self.degrade_refine = int(degrade_refine)
        self._index_stats = index_stats
        self._lock = threading.Lock()
        self._counters = {
            "admitted": 0,
            "degraded": 0,
            "rejected": 0,
            "rejected_rate_limited": 0,
            "rejected_queue_full": 0,
            "rejected_deadline_unmeetable": 0,
            "writes_admitted": 0,
            "writes_rejected": 0,
        }

    # -- the verdict -----------------------------------------------------------
    def admit(self, spec: Query, deadline_s: Optional[float] = None) -> AdmissionDecision:
        """Admission verdict for one request (does NOT submit it)."""
        if self.bucket is not None:
            wait = self.bucket.try_acquire()
            if wait > 0.0:
                return self._shed("rate_limited", retry_after_s=wait)
        depth = self.service.queue_depth()
        est_wait = self.service.estimated_wait_s()
        if depth >= self.max_queue:
            return self._shed(
                "queue_full", retry_after_s=max(est_wait, 1e-3),
                estimated_wait_s=est_wait,
            )
        if deadline_s is not None and est_wait > float(deadline_s):
            # the exact path would only expire in queue — but the degraded
            # (truncated-apex) path may still make the deadline: degrade as
            # the rescue, shed only when even that cannot fit
            out_spec, degraded = self._maybe_degrade(spec, depth, force=True)
            if not degraded or est_wait * DEGRADE_WAIT_FACTOR > float(deadline_s):
                return self._shed(
                    "deadline_unmeetable",
                    retry_after_s=max(est_wait - float(deadline_s), 1e-3),
                    estimated_wait_s=est_wait,
                )
            with self._lock:
                self._counters["admitted"] += 1
                self._counters["degraded"] += 1
            return AdmissionDecision(
                admitted=True, reason="ok", spec=out_spec, degraded=True,
                estimated_wait_s=est_wait,
            )
        out_spec, degraded = self._maybe_degrade(spec, depth)
        with self._lock:
            self._counters["admitted"] += 1
            if degraded:
                self._counters["degraded"] += 1
        return AdmissionDecision(
            admitted=True, reason="ok", spec=out_spec, degraded=degraded,
            estimated_wait_s=est_wait,
        )

    def admit_write(self, n_rows: int = 1) -> AdmissionDecision:
        """Admission verdict for one mutation batch (upsert / remove).

        Writes draw from the SAME token bucket as reads — one per batch, not
        per row, since the durable write path amortises the WAL append and
        delta insert across the batch — so a write burst is rate-shaped
        against the tenant's one provisioned rate rather than bypassing it.
        Queue-depth and deadline policy don't apply: writes never enter the
        query queue (they go straight through the index's write lock)."""
        if n_rows < 1:
            raise ValueError(f"n_rows must be >= 1; got {n_rows}")
        if self.bucket is not None:
            wait = self.bucket.try_acquire()
            if wait > 0.0:
                with self._lock:
                    self._counters["writes_rejected"] += 1
                return self._shed("rate_limited", retry_after_s=wait)
        with self._lock:
            self._counters["writes_admitted"] += 1
        return AdmissionDecision(admitted=True, reason="ok")

    def _shed(self, reason: str, *, retry_after_s: float,
              estimated_wait_s: float = 0.0) -> AdmissionDecision:
        with self._lock:
            self._counters["rejected"] += 1
            self._counters[f"rejected_{reason}"] += 1
        return AdmissionDecision(
            admitted=False, reason=reason, retry_after_s=retry_after_s,
            estimated_wait_s=estimated_wait_s,
        )

    def _maybe_degrade(self, spec: Query, depth: int, force: bool = False):
        """Flip an auto-mode spec to the truncated-apex path under pressure
        (or unconditionally with ``force=True``, the deadline-rescue path).

        Only ``mode="auto"`` specs are rewritten (an explicit exact/approx
        request is a contract), and only on the table kinds (the tree has no
        truncatable surrogate)."""
        if self.degrade_at is None or spec.mode != "auto":
            return spec, False
        if not force and depth < self.degrade_at * self.max_queue:
            return spec, False
        stats = self._index_stats() if self._index_stats is not None else {}
        n_pivots = stats.get("n_pivots")
        if n_pivots is None:
            return spec, False
        dims = self.degrade_dims
        if dims is None:
            dims = max(2, int(n_pivots) // 2)
        return (
            replace(
                spec,
                mode="approx",
                dims=spec.dims if spec.dims is not None else dims,
                refine=spec.refine if spec.refine is not None else self.degrade_refine,
            ),
            True,
        )

    # -- observability ---------------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        out["shed_fraction"] = (
            out["rejected"] / (out["admitted"] + out["rejected"])
            if (out["admitted"] + out["rejected"])
            else 0.0
        )
        return out
