"""SearchService — a micro-batched serving runtime over the Query plan API.

Single-query arrivals waste the fused scan: one pivot-distance call, one
projection and one bound-scan launch serve a whole block.  The runtime
turns an open stream of independent requests into fused micro-batches:

  * ``submit(q, spec)`` enqueues one request and returns a
    ``concurrent.futures.Future`` resolving to its ``QueryResult``.
  * One dispatcher thread pops the oldest request and keeps the batch open
    until ``max_batch`` compatible (equal-``Query``) requests joined or
    ``max_wait_s`` elapsed since it opened; incompatible arrivals keep
    their FIFO place for the next batch.
  * The batch runs through ``index.query(rows, spec, plan=plan)`` with the
    plan computed once per spec, so per-request results are bit-identical
    to a direct ``knn_batch``/``search_batch`` call under the same plan.
  * Batches are padded to power-of-two buckets (capped at ``max_batch``),
    so the kernels see log2(max_batch) batch shapes; ``warmup()`` builds
    the kernels and runs one batch per bucket before traffic arrives.
    Padded rows are discarded before futures resolve.
  * Per-request deadlines (``deadline_s``) and ``close(drain=...)`` behave
    as in the JAX package's service; ``stats()`` reports latency
    percentiles, throughput, expiries and batch occupancy.
  * Each batch runs under a ``service.batch`` span (``repro_torch.tracing``)
    with one ``service.queue`` span per request under it: the request's wait
    from ``submit`` to the moment the dispatcher took its batch.
  * ``max_queue`` bounds the pending queue: ``submit`` raises
    ``ServiceOverloaded`` (counted as ``rejected``) instead of queueing
    past it; ``queue_depth()`` and ``estimated_wait_s()`` (EWMAs of batch
    time and occupancy) are what admission control sheds on.
  * ``execute_gate`` (an optional semaphore) bounds the batches executing
    at once across services sharing it (the multi-tenant registry passes
    one gate to every tenant).
  * The dispatcher thread enters the index's device before its first
    batch, so kernel launches go to that card.

``run_poisson_open_loop`` drives a service with an open-loop Poisson
client.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch import tracing
from repro_torch.api.planner import plan as make_plan
from repro_torch.api.query import Query
from repro_torch.device import on_device

__all__ = [
    "DeadlineExceeded",
    "SearchService",
    "ServiceClosed",
    "ServiceOverloaded",
    "run_poisson_open_loop",
]


class ServiceClosed(RuntimeError):
    """The service is (being) closed; the request was not executed."""


class ServiceOverloaded(RuntimeError):
    """The bounded request queue is full; retry later (backpressure)."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired before a result could be returned."""


@dataclass
class _Request:
    q: np.ndarray
    spec: Query
    future: Future
    t_enqueue: float
    #: absolute ``time.perf_counter()`` deadline, or None
    t_deadline: Optional[float] = None


#: retention of the latency/occupancy windows behind the percentiles
STATS_WINDOW = 100_000


@dataclass
class _SpecStats:
    n_batches: int = 0
    n_requests: int = 0
    max_occupancy: int = 0


@dataclass
class ServiceStats:
    """Counters the dispatcher owns; snapshot via ``SearchService.stats``."""

    n_requests: int = 0
    n_batches: int = 0
    occupancies: deque = field(default_factory=lambda: deque(maxlen=STATS_WINDOW))
    latencies_s: deque = field(default_factory=lambda: deque(maxlen=STATS_WINDOW))
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    rejected: int = 0              # bounded-queue (ServiceOverloaded) rejections
    expired_queued: int = 0
    expired_in_flight: int = 0
    closed_rejects: int = 0
    ewma_batch_s: float = 0.0      # EWMA batch execution wall time
    ewma_occupancy: float = 0.0    # EWMA batch occupancy
    per_spec: Dict[Query, _SpecStats] = field(default_factory=dict)


#: EWMA smoothing of the batch-time / occupancy estimates behind
#: ``estimated_wait_s``
_EWMA_ALPHA = 0.2


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(p * (len(sorted_vals) - 1))))
    return sorted_vals[i]


class SearchService:
    """Micro-batching request runtime over one index.

    Args:
      index:       a ``repro_torch.api`` index (only ``query``/``stats`` used).
      max_batch:   flush a batch once this many compatible requests joined.
      max_wait_s:  flush an open batch this long after its first request.
      pad_batches: pad fused blocks to power-of-two bucket sizes.
      max_queue:   bound on the pending queue (None = unbounded); ``submit``
                   raises ``ServiceOverloaded`` past it.
      execute_gate: optional ``threading.Semaphore`` acquired around each
                   batch execution.
      fanout_workers: forwarded to a sharded index's ``configure_fanout``
                   (None leaves the index's own policy alone); 0 pins the
                   index to sequential fan-out.
    """

    def __init__(self, index, *, max_batch: int = 64, max_wait_s: float = 0.002,
                 pad_batches: bool = True, max_queue: Optional[int] = None,
                 execute_gate: Optional[threading.Semaphore] = None,
                 fanout_workers: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; got {max_batch}")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError(f"max_queue must be >= 1; got {max_queue}")
        if fanout_workers is not None and hasattr(index, "configure_fanout"):
            index.configure_fanout(int(fanout_workers))
        self.index = index
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.pad_batches = bool(pad_batches)
        self.max_queue = int(max_queue) if max_queue is not None else None
        self._execute_gate = execute_gate
        self._pending: deque[_Request] = deque()
        self._lock = threading.Lock()
        self._arrived = threading.Condition(self._lock)
        self._closing = False
        self._stats = ServiceStats()
        self._plan_cache: dict = {}
        self._worker = threading.Thread(target=self._run, name="search-service-dispatch", daemon=True)
        self._worker.start()

    # -- client side -----------------------------------------------------------
    def submit(self, q: np.ndarray, spec: Query, *, deadline_s: Optional[float] = None) -> Future:
        """Enqueue one single-query request; resolves to its ``QueryResult``.

        ``deadline_s`` is the request's latency budget from now: expiring
        while queued fails it with ``DeadlineExceeded`` before it takes a
        batch slot; expiring while its batch runs discards its result.
        """
        if not isinstance(spec, Query):
            raise TypeError(f"expected a Query; got {type(spec).__name__}")
        q = np.asarray(q)
        if q.ndim != 1:
            raise ValueError(
                f"submit() takes one query vector (1-D); got shape {q.shape} — "
                "the service owns the batching"
            )
        if spec.task == "range" and isinstance(spec.threshold, tuple) and len(spec.threshold) > 1:
            raise ValueError(
                "per-query threshold tuples don't fit single-request "
                "submission; use a scalar-threshold Query"
            )
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(f"deadline_s must be positive; got {deadline_s}")
        now = time.perf_counter()
        fut: Future = Future()
        req = _Request(
            q=q, spec=spec, future=fut, t_enqueue=now,
            t_deadline=(now + float(deadline_s)) if deadline_s is not None else None,
        )
        with self._arrived:
            if self._closing:
                raise ServiceClosed("service is closed")
            if self.max_queue is not None and len(self._pending) >= self.max_queue:
                self._stats.rejected += 1
                raise ServiceOverloaded(
                    f"request queue is full ({len(self._pending)}/{self.max_queue}); retry later"
                )
            self._pending.append(req)
            self._arrived.notify()
        return fut

    def close(self, *, drain: bool = True) -> None:
        """Stop accepting requests; ``drain=True`` runs every queued request,
        ``drain=False`` fails them with ``ServiceClosed``."""
        with self._arrived:
            self._closing = True
            if not drain:
                self._fail_pending_locked()
            self._arrived.notify()
        self._worker.join(timeout=30.0)
        with self._arrived:
            self._fail_pending_locked()

    def _fail_pending_locked(self) -> None:
        while self._pending:
            req = self._pending.popleft()
            self._stats.closed_rejects += 1
            req.future.set_exception(ServiceClosed("service closed before this request was executed"))

    def __enter__(self) -> "SearchService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability ---------------------------------------------------------
    def queue_depth(self) -> int:
        """Requests currently queued (not yet pulled into a batch)."""
        with self._lock:
            return len(self._pending)

    def estimated_wait_s(self) -> float:
        """EWMA estimate of how long a request submitted now waits until its
        batch completes: the queued requests ahead of it at the observed
        per-request batch cost, plus one batch.  0.0 until a batch ran."""
        with self._lock:
            st = self._stats
            if st.ewma_batch_s <= 0.0:
                return 0.0
            per_request_s = st.ewma_batch_s / max(st.ewma_occupancy, 1.0)
            return len(self._pending) * per_request_s + st.ewma_batch_s

    def stats(self) -> dict:
        """Latency percentiles, throughput, queue/expiry counters and batch
        occupancy (overall and per coalescing spec)."""
        with self._lock:
            st = self._stats
            lat = sorted(st.latencies_s)
            occ = list(st.occupancies)
            span = (
                (st.t_last - st.t_first)
                if st.t_first is not None and st.t_last is not None and st.t_last > st.t_first
                else 0.0
            )
            per_spec = {
                json.dumps(spec.to_dict(), sort_keys=True): {
                    "n_batches": ss.n_batches,
                    "n_requests": ss.n_requests,
                    "mean_occupancy": ss.n_requests / ss.n_batches if ss.n_batches else 0.0,
                    "max_occupancy": ss.max_occupancy,
                }
                for spec, ss in st.per_spec.items()
            }
            return {
                "n_requests": st.n_requests,
                "n_batches": st.n_batches,
                "latency_p50_ms": _percentile(lat, 0.50) * 1e3,
                "latency_p99_ms": _percentile(lat, 0.99) * 1e3,
                "qps": (st.n_requests / span) if span > 0 else 0.0,
                "mean_batch_occupancy": float(np.mean(occ)) if occ else 0.0,
                "max_batch_occupancy": int(max(occ)) if occ else 0,
                "queue_depth": len(self._pending),
                "rejected": st.rejected,
                "expired": st.expired_queued + st.expired_in_flight,
                "expired_queued": st.expired_queued,
                "expired_in_flight": st.expired_in_flight,
                "closed_rejects": st.closed_rejects,
                "ewma_batch_ms": st.ewma_batch_s * 1e3,
                "per_spec": per_spec,
            }

    # -- dispatcher ------------------------------------------------------------
    def _expire_locked(self, req: _Request, now: float) -> bool:
        if req.t_deadline is None or now <= req.t_deadline:
            return False
        self._stats.expired_queued += 1
        req.future.set_exception(
            DeadlineExceeded(f"deadline expired after {now - req.t_enqueue:.3f}s in queue")
        )
        return True

    def _take_batch(self) -> Optional[List[_Request]]:
        """Block for the next batch: the oldest live request plus every
        equal-spec request arriving before the flush deadline."""
        with self._arrived:
            while True:
                while not self._pending and not self._closing:
                    self._arrived.wait()
                if not self._pending:
                    return None
                now = time.perf_counter()
                head = self._pending.popleft()
                if self._expire_locked(head, now):
                    continue
                break
            batch = [head]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                kept = deque()
                now = time.perf_counter()
                while self._pending and len(batch) < self.max_batch:
                    r = self._pending.popleft()
                    if self._expire_locked(r, now):
                        continue
                    (batch if r.spec == head.spec else kept).append(r)
                if kept:
                    kept.extend(self._pending)
                    self._pending = kept
                    break
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._closing or len(batch) >= self.max_batch:
                    break
                self._arrived.wait(timeout=remaining)
            return batch

    def _run(self) -> None:
        with on_device(self.index.device):
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                self._execute(batch)

    def _bucket(self, n: int) -> int:
        """Smallest power of two >= n, capped at ``max_batch``."""
        if not self.pad_batches or n >= self.max_batch:
            return n
        return min(1 << (n - 1).bit_length(), self.max_batch)

    def warmup(self, spec: Query, example_q: np.ndarray) -> None:
        """Build the kernels (the first batch does) and run one batch of
        every bucket size for ``spec``."""
        q = np.asarray(example_q)
        plan = self._plan_for(spec)
        sizes = []
        size = 1
        while size < self.max_batch:
            sizes.append(size)
            size *= 2
        sizes.append(self.max_batch)
        if not self.pad_batches:
            sizes = sizes[:1] + sizes[-1:]
        for s in dict.fromkeys(sizes):
            self.index.query(np.repeat(q[None, :], s, axis=0), spec, plan=plan)

    def _plan_for(self, spec: Query):
        """The cached plan for ``spec``, planned again whenever the index's
        mutation ``version`` moved (a mutable index's stats, and with them
        auto-mode decisions, change as rows come and go)."""
        version = getattr(self.index, "version", None)
        with self._lock:
            entry = self._plan_cache.get(spec)
        if entry is not None and entry[0] == version:
            return entry[1]
        plan = make_plan(self.index, spec)
        with self._lock:
            self._plan_cache[spec] = (version, plan)
        return plan

    def _execute(self, batch: List[_Request]) -> None:
        t_start = time.perf_counter()
        padded = self._bucket(len(batch))
        with tracing.span("service.batch", requests=len(batch), padded=padded) as sb:
            if sb:
                for req in batch:
                    tracing.record("service.queue", req.t_enqueue, t_start, parent=sb)
            self._execute_batch(batch, t_start, padded)

    def _execute_batch(self, batch: List[_Request], t_start: float, padded: int) -> None:
        spec = batch[0].spec
        try:
            plan = self._plan_for(spec)
            fused = np.stack([r.q for r in batch])
            if padded > len(batch):
                # pad with copies of the last row: every path is row-independent
                fused = np.concatenate([fused, np.repeat(fused[-1:], padded - len(batch), axis=0)])
            if self._execute_gate is not None:
                with self._execute_gate:
                    result = self.index.query(fused, spec, plan=plan)
            else:
                result = self.index.query(fused, spec, plan=plan)
            t_done = time.perf_counter()
            expired = 0
            for req, res in zip(batch, result.results):
                if req.t_deadline is not None and t_done > req.t_deadline:
                    expired += 1
                    req.future.set_exception(
                        DeadlineExceeded(
                            f"deadline expired mid-batch after {t_done - req.t_enqueue:.3f}s"
                        )
                    )
                else:
                    req.future.set_result(res)
        except Exception as e:  # noqa: BLE001 — the dispatcher must keep serving
            t_done = time.perf_counter()
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            with self._lock:
                self._record(batch, t_done, t_done - t_start)
            return
        with self._lock:
            self._stats.expired_in_flight += expired
            self._record(batch, t_done, t_done - t_start)

    def _record(self, batch: List[_Request], t_done: float, exec_s: float) -> None:
        st = self._stats
        st.n_batches += 1
        st.n_requests += len(batch)
        st.occupancies.append(len(batch))
        a = _EWMA_ALPHA
        st.ewma_batch_s = exec_s if st.ewma_batch_s == 0.0 else (1 - a) * st.ewma_batch_s + a * exec_s
        st.ewma_occupancy = (
            float(len(batch)) if st.ewma_occupancy == 0.0 else (1 - a) * st.ewma_occupancy + a * len(batch)
        )
        ss = st.per_spec.setdefault(batch[0].spec, _SpecStats())
        ss.n_batches += 1
        ss.n_requests += len(batch)
        ss.max_occupancy = max(ss.max_occupancy, len(batch))
        for req in batch:
            st.latencies_s.append(t_done - req.t_enqueue)
            if st.t_first is None or req.t_enqueue < st.t_first:
                st.t_first = req.t_enqueue
        if st.t_last is None or t_done > st.t_last:
            st.t_last = t_done


def run_poisson_open_loop(service: SearchService, queries: np.ndarray, spec: Query, *,
                          arrival_rate: float, seed: int = 0) -> List:
    """Drive ``service`` with a Poisson open-loop client: request ``i`` is
    submitted on an exponential(1/rate) arrival process whatever the
    completions (queueing shows in the latency tail).  Returns the
    ``QueryResult``s in submission order."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / float(arrival_rate), size=len(queries))
    futures = []
    t_next = time.perf_counter()
    for q, gap in zip(queries, gaps):
        t_next += gap
        delay = t_next - time.perf_counter()
        # sleep only for gaps the OS can honour: shorter ones become a burst,
        # which is what a saturating open-loop stream is
        if delay > 0.004:
            time.sleep(delay)
        futures.append(service.submit(q, spec))
    return [f.result(timeout=120.0) for f in futures]
