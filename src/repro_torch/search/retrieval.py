"""n-simplex-accelerated candidate retrieval over an embedding space.

A two-tower or sequence model produces item embeddings; scoring one query
against 10⁶ candidates under a supermetric (cosine chord or l2) is exactly
the paper's workload.  Offline: project all candidate embeddings to the
apex table (n floats per item instead of d).  Online: n pivot distances and
the two-sided bounds prune the candidate set; survivors are re-ranked
exactly in the embedding space.  The top-k objective becomes one threshold
pass: the k-th smallest upper bound is a radius every true top-k item lies
within.

The JAX package's ``repro.search.retrieval`` on one device: the table, the
bounds and the re-rank distances are computed there in float64.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import NSimplexProjector, select_pivots
from repro_torch.device import resolve_device
from repro_torch.metrics import Metric, get_metric

__all__ = ["NSimplexRetriever", "RetrievalStats"]


@dataclass
class RetrievalStats:
    exact_scored: int
    admitted_by_upb: int
    pruned: int


class NSimplexRetriever:
    """Exact top-k retrieval over a supermetric embedding space on ``device``
    ("cuda" by default; "cpu" only when passed)."""

    def __init__(self, item_embeddings, *, metric: Metric | str = "cosine", n_pivots: int = 16, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.metric = get_metric(metric) if isinstance(metric, str) else metric
        items = np.asarray(item_embeddings)
        self.items = torch.tensor(items, device=self.device)
        self.projector = NSimplexProjector(select_pivots(items, n_pivots, seed=seed), self.metric, device=self.device)
        self.table = self.projector(self.items)

    def top_k(self, query_embedding, k: int = 10):
        """Exact top-k nearest items. Returns (indices, distances, stats)."""
        q = torch.as_tensor(np.asarray(query_embedding), device=self.device)
        apex = self.projector.project_distances(self.metric.cross(q[None, :], self.projector.pivots_t)[0])
        head = ((self.table[:, :-1] - apex[None, :-1]) ** 2).sum(dim=1)
        lwb = torch.sqrt(torch.clamp_min(head + (self.table[:, -1] - apex[-1]) ** 2, 0.0))
        upb = torch.sqrt(torch.clamp_min(head + (self.table[:, -1] + apex[-1]) ** 2, 0.0))
        # radius = k-th smallest upper bound: every true top-k item has
        # lwb <= true distance <= that radius
        radius = torch.kthvalue(upb, k).values
        cand = torch.nonzero(lwb <= radius + 1e-9).flatten()
        d = self.metric.one_to_many(q, self.items[cand]).cpu().numpy()
        cand = cand.cpu().numpy()
        order = np.argsort(d, kind="stable")[:k]
        stats = RetrievalStats(
            exact_scored=len(cand),
            admitted_by_upb=int((upb <= radius).sum()),
            pruned=self.items.shape[0] - len(cand),
        )
        return cand[order], d[order], stats

    def brute_force_top_k(self, query_embedding, k: int = 10):
        d = self.metric.one_to_many(torch.as_tensor(np.asarray(query_embedding), device=self.device), self.items)
        d = d.cpu().numpy()
        idx = np.argsort(d, kind="stable")[:k]
        return idx, d[idx]
