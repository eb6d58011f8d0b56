"""Sharded, deterministic host data pipeline.

Each process produces only its slice of the global batch.  The JAX package
assembles the global array from the processes' slices with
``jax.make_array_from_process_local_data``; the port's device grid is one
process (``repro_torch.sharding``), so the slice is placed on that grid
instead: rows split over the ``data`` axis, replicated across replica
groups (``place_rows``).  The pipeline is process-count agnostic: it derives
its slice from (process_index, process_count) and is reproducible from
(seed, step) alone, which checkpoint-restart and elastic rescaling need (a
restarted job with another process count re-slices the same global stream).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.sharding.rules import DeviceGrid, place_rows

__all__ = ["ShardedBatchPipeline"]


class ShardedBatchPipeline:
    """Deterministic (seed, step) -> per-process batch -> placed tensors.

    ``process_index`` and ``process_count`` default to 0 and 1 (one
    process).  With ``sharding=None`` a call returns the host slice; with
    a ``DeviceGrid`` it returns, per key, the ``place_rows`` slices of the
    host slice (``[r][j]`` on device ``(r, j)``).
    """

    def __init__(
        self,
        global_batch: int,
        make_batch: Callable[[int, int, int], dict],
        *,
        seed: int = 0,
        sharding: Optional[DeviceGrid] = None,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.global_batch = global_batch
        self.make_batch = make_batch
        self.seed = seed
        self.sharding = sharding
        self.process_index = process_index
        self.process_count = process_count
        if global_batch % self.process_count:
            raise ValueError("global_batch must divide evenly across processes")
        self.local_batch = global_batch // self.process_count

    def local_slice(self, step: int) -> dict:
        """The (deterministic) portion of the global batch this process owns."""
        batch_seed = (self.seed * 1_000_003 + step) & 0x7FFFFFFF
        full = self.make_batch(self.global_batch, batch_seed, step)
        lo = self.process_index * self.local_batch
        hi = lo + self.local_batch
        return {k: v[lo:hi] for k, v in full.items()}

    def __call__(self, step: int) -> dict:
        local = self.local_slice(step)
        if self.sharding is None:
            return local
        return {k: place_rows(self.sharding, torch.as_tensor(v)) for k, v in local.items()}
