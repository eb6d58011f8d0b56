"""Sparse embedding infrastructure for RecSys.

One concatenated table holds every categorical field's rows (the "unified
table" layout: field f's id i lives at row offsets[f] + i).  Lookups are
row gathers; multi-hot bags reduce with ``index_add_`` (the JAX package's
``segment_sum``; on the card it adds with atomics, so a bag's summation
order, and its last bits, vary between runs).  ``sharded_lookup`` reads a
table whose rows are split over the device grid (``place_rows``): a masked
take on each device, then a sum.  ``rank_lookup`` is the same read on a
rank of a ``ProcessMesh`` whose table rows split over ``model`` (the
reference's ``sharded_lookup`` body): a masked take of the rows this rank
owns, summed over the ``model`` group, the gradient reaching only them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.models.params import generator_for, model_device, normal

__all__ = [
    "EmbeddingSpec",
    "ROW_PAD",
    "embedding_bag",
    "embedding_init",
    "flat_ids",
    "lookup",
    "padded_rows",
    "rank_lookup",
    "sharded_lookup",
]


@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    vocab_sizes: tuple          # rows per categorical field
    dim: int

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int64)

    @property
    def total_rows(self) -> int:
        return int(np.sum(self.vocab_sizes))


#: tables (and their row-aligned side arrays) pad to this row multiple so
#: the row split of any device grid divides them exactly
ROW_PAD = 1024


def padded_rows(spec: EmbeddingSpec, pad_to: int = ROW_PAD) -> int:
    return ((spec.total_rows + pad_to - 1) // pad_to) * pad_to


def embedding_init(generator, spec: EmbeddingSpec, dtype=torch.float32, pad_to: int = ROW_PAD, device="cuda"):
    dev = model_device(device)
    return normal(generator_for(generator, dev), (padded_rows(spec, pad_to), spec.dim), dtype, 0.05, dev)


def flat_ids(spec: EmbeddingSpec, sparse_ids):
    """(B, n_fields) per-field ids -> (B, n_fields) unified-table row ids."""
    offsets = torch.as_tensor(spec.offsets, dtype=sparse_ids.dtype, device=sparse_ids.device)
    return sparse_ids + offsets[None, :]


def rank_lookup(table_local, rows, tp=None, reduce: bool = True):
    """``table[rows]`` for ``rows`` of any shape (global row ids).  Without
    ``tp`` ``table_local`` is the whole table.  With ``tp`` (a
    ``layers.TensorParallel`` over ``model``) it is this rank's chunk of a
    table whose leading dim splits over ``model``: the rows it owns are
    taken, the others read as zeros, and the ranks' parts are summed over
    the group (``tp.reduce``: the gradient passes through to the owned
    rows only); ``reduce=False`` returns this rank's part unsummed."""
    if tp is None:
        return table_local[rows.long()]
    n = table_local.shape[0]
    local = rows.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    vecs = table_local[torch.clamp(local, 0, n - 1)]
    mine = mine.reshape(tuple(mine.shape) + (1,) * (vecs.ndim - mine.ndim))
    part = torch.where(mine, vecs, torch.zeros((), dtype=vecs.dtype, device=vecs.device))
    return tp.reduce(part) if reduce else part


def lookup(table, spec: EmbeddingSpec, sparse_ids, tp=None):
    """(B, n_fields) -> (B, n_fields, dim); ``tp``: ``rank_lookup``'s."""
    return rank_lookup(table, flat_ids(spec, sparse_ids), tp)


def embedding_bag(table, spec: EmbeddingSpec, ids, bag_ids, n_bags, mode="sum"):
    """Ragged multi-hot bag reduce: EmbeddingBag(sum|mean) from first
    principles.  ids: (nnz,) unified row ids; bag_ids: (nnz,) which bag
    each id belongs to."""
    vecs = table[ids.long()]                                     # (nnz, dim)
    bag_ids = bag_ids.long()
    summed = vecs.new_zeros((n_bags, vecs.shape[1])).index_add_(0, bag_ids, vecs)
    if mode == "sum":
        return summed
    counts = table.new_zeros((n_bags,)).index_add_(0, bag_ids, torch.ones_like(bag_ids, dtype=table.dtype))
    return summed / torch.clamp_min(counts, 1.0)[:, None]


def sharded_lookup(table_shards: Sequence[torch.Tensor], spec: EmbeddingSpec, sparse_ids):
    """Row-sharded table lookup: ``table_shards[s]`` holds rows
    [s·rows_local, (s+1)·rows_local) of the global table on its own device
    (one replica group of ``place_rows``).  Each shard takes the ids it
    owns (the others read as zero rows) and the partial results sum on the
    first shard's device, so the result equals ``lookup`` on the whole
    table.  (B, n_fields) -> (B, n_fields, dim)."""
    out_dev = table_shards[0].device
    gids = flat_ids(spec, sparse_ids).long()
    total = None
    for s, local_table in enumerate(table_shards):
        rows_local = local_table.shape[0]
        local = gids.to(local_table.device) - s * rows_local
        mine = (local >= 0) & (local < rows_local)
        vecs = local_table[torch.clamp(local, 0, rows_local - 1)]
        vecs = torch.where(mine[..., None], vecs, 0.0).to(out_dev)
        total = vecs if total is None else total + vecs
    return total
