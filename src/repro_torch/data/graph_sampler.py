"""Neighbour sampler with per-hop fanout (GraphSAGE-style, for minibatch_lg).

Host-side (numpy) sampler that builds fixed-shape padded subgraph batches the
device step consumes — the standard split for GNN training on an accelerator: irregular
sampling on CPU hosts, dense padded compute on device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["NeighborSampler"]


class NeighborSampler:
    """Uniform k-hop neighbour sampling over a CSR adjacency."""

    def __init__(self, edge_index: np.ndarray, n_nodes: int, seed: int = 0):
        src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
        order = np.argsort(dst, kind="stable")
        self._src_sorted = src[order].astype(np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self._indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_nodes = n_nodes
        self._rng = np.random.default_rng(seed)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int) -> np.ndarray:
        """(B,) nodes -> (B, fanout) sampled in-neighbours (self-fill if none)."""
        nodes = np.asarray(nodes, dtype=np.int64)
        out = np.empty((len(nodes), fanout), dtype=np.int64)
        lo = self._indptr[nodes]
        hi = self._indptr[nodes + 1]
        deg = hi - lo
        r = self._rng.integers(0, np.maximum(deg, 1)[:, None], size=(len(nodes), fanout))
        idx = lo[:, None] + r
        out[:] = np.where(deg[:, None] > 0, self._src_sorted[np.minimum(idx, len(self._src_sorted) - 1)], nodes[:, None])
        return out

    def sample_batch(self, batch_nodes: np.ndarray, fanouts: Sequence[int]):
        """Build a padded multi-hop block batch.

        Returns dict with, per hop h:
          ``nodes_h``: (B * prod(fanouts[:h]),) node ids at hop h (hop 0 = seeds)
          edges implied positionally: node k at hop h+1 is a sampled neighbour
          of node k // fanouts[h] at hop h.  The model materialises
          segment-sum aggregations from this layout.
        """
        layers = [np.asarray(batch_nodes, dtype=np.int64)]
        for f in fanouts:
            layers.append(self.sample_neighbors(layers[-1], f).reshape(-1))
        return layers
