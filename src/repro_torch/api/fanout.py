"""Async shard fan-out primitives for the sharded composite.

``ShardedIndex`` fans each query block out to its shards.  Executed
sequentially that wastes two resources: idle cores while one shard scans,
and — far more important on expensive metrics — true-distance evaluations
that a later shard spends proving rows are *outside* the global top-k.
This module supplies the two pieces that fix both:

* a process-wide worker pool (:func:`shared_pool`) plus :func:`run_fanout`,
  which submits per-shard thunks and yields results as they complete, so
  shard ``s``'s results merge while shard ``s+1`` is still scanning;
* :class:`TopKMerge`, an incremental tie-stable top-k accumulator whose
  current k-th distance (:meth:`TopKMerge.radius`) is handed to
  still-running shards as a ``radius_hint`` — a sound cap on the distance
  any row they could still contribute may have, shrinking their refinement
  radius and cutting metric calls as results land.

Exactness under concurrency: the hint is always an *upper* bound on the
final global k-th distance (it is the k-th among distances actually
measured so far, and only ever shrinks), so a shard that prunes rows with
``d > hint`` can never drop a true global top-k member; a stale read of the
hint is merely a looser-but-sound cap.  The final selection is the
lexicographic ``(distance, id)`` top-k of everything pushed, which is
commutative and associative — results are bit-identical regardless of
shard completion order.

Host numpy, as in the JAX package's ``repro.api.fanout``; both read the same
``REPRO_FANOUT_WORKERS`` variable, so one setting governs both packages.
The pool threads launch the shards' kernels on the current stream of the
shards' device (``ShardedIndex`` enters that device in each thread).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.index.knn import knn_select

__all__ = ["TopKMerge", "default_fanout_workers", "run_fanout", "shared_pool"]

_pool_lock = threading.Lock()
_shared_pool: Optional[ThreadPoolExecutor] = None


def default_fanout_workers() -> int:
    """Worker count for the shared pool: ``REPRO_FANOUT_WORKERS`` env
    override, else a small multiple of the host's cores (0 disables the
    pool entirely and every fan-out degrades to sequential execution)."""
    env = os.environ.get("REPRO_FANOUT_WORKERS")
    if env is not None:
        return max(0, int(env))
    return max(1, min(8, os.cpu_count() or 1))


def shared_pool() -> Optional[ThreadPoolExecutor]:
    """The process-wide fan-out pool, built lazily on first use.

    Shared by every ``ShardedIndex`` and by ``repro_torch.launch.service.SearchService``
    (whose micro-batcher executes on the same workers), so total scan
    concurrency stays bounded no matter how many indexes a process serves.
    Returns ``None`` when ``REPRO_FANOUT_WORKERS=0``.
    """
    global _shared_pool
    n = default_fanout_workers()
    if n <= 0:
        return None
    with _pool_lock:
        if _shared_pool is None:
            _shared_pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="repro-fanout"
            )
        return _shared_pool


def run_fanout(
    thunks: Sequence[Callable[[], object]],
    pool: Optional[ThreadPoolExecutor],
) -> Iterator[Tuple[int, object]]:
    """Run thunks, yielding ``(index, result)`` as each completes.

    With a pool, thunks run concurrently and completion order is arbitrary;
    without one (``pool=None``) they run inline in submission order.  A
    thunk's exception propagates to the caller either way — but only after
    every in-flight future has finished, so no worker is left mutating
    shared merge state after the caller unwound.
    """
    if pool is None:
        for i, thunk in enumerate(thunks):
            yield i, thunk()
        return
    futures = {pool.submit(thunk): i for i, thunk in enumerate(thunks)}
    pending = set(futures)
    try:
        while pending:
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                yield futures[fut], fut.result()
    finally:
        if pending:
            wait(pending)


class TopKMerge:
    """Incremental tie-stable top-k over (distance, id) streams.

    ``push`` folds one shard's results in; ``radius`` exposes the current
    k-th distance (``+inf`` until k rows have merged) for use as the
    ``radius_hint`` of still-running shards.  ``push`` must be serialised
    by the caller (the fan-out paths hold a lock); ``radius`` is safe to
    read from any thread without it — it is a single monotone-shrinking
    float attribute, and a stale read is a looser-but-sound cap.
    """

    __slots__ = ("k", "_ids", "_d", "_kth")

    def __init__(self, k: int, cap: Optional[float] = None):
        self.k = int(k)
        self._ids = np.empty(0, dtype=np.int64)
        self._d = np.empty(0, dtype=np.float64)
        self._kth = float("inf") if cap is None else float(cap)

    def radius(self) -> float:
        """Current merged k-th distance — a sound pruning cap for any shard
        whose results have not yet been pushed."""
        return self._kth

    def push(self, distances: np.ndarray, ids: np.ndarray) -> None:
        if ids is None or len(ids) == 0:
            return
        distances = np.asarray(distances, dtype=np.float64)
        ids = np.asarray(ids, dtype=np.int64)
        if np.isfinite(self._kth):
            # beyond-cap rows can never enter the final top-k: at the
            # boundary a tie keeps the smaller id, which `keep` includes
            keep = distances <= self._kth
            if not keep.all():
                distances, ids = distances[keep], ids[keep]
            if len(ids) == 0:
                return
        merged_ids, merged_d = knn_select(
            np.concatenate([self._d, distances]),
            np.concatenate([self._ids, ids]),
            self.k,
        )
        self._ids, self._d = merged_ids, merged_d
        if len(merged_ids) == self.k:
            kth = float(merged_d[-1])
            if kth < self._kth:
                self._kth = kth

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, distances) of the merged top-k so far."""
        return self._ids, self._d
