"""``SimplexTableIndex``: the protocol class of the n-simplex mechanism.

It wraps ``NSimplexIndex``, adapts its tuple-returning methods to the typed
result carriers, and owns persistence in the shared manifest + npz format.
Construct it through ``repro_torch.api.build_index`` / ``load_index``.
"""

from __future__ import annotations

import time
from typing import List

from repro_torch.api.execute import QuerySurface
from repro_torch.api.persistence import write_index_dir
from repro_torch.api.query import QueryOptions
from repro_torch.api.types import BatchQueryResult, QueryResult
from repro_torch.index.nsimplex_index import NSimplexIndex
from repro_torch.metrics import Metric, metric_from_config, metric_to_config

__all__ = ["SimplexTableIndex"]


def _batch(results: List[QueryResult], t0: float) -> BatchQueryResult:
    return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)


class SimplexTableIndex(QuerySurface):
    """Apex table + fused two-sided simplex bounds (the paper's mechanism)."""

    kind = "nsimplex"

    def __init__(self, inner: NSimplexIndex, metric: Metric):
        self._inner = inner
        self.metric = metric

    @classmethod
    def build(cls, data, metric: Metric, *, pivots, eps: float = 1e-6, use_kernel: bool = True,
              device="cuda") -> "SimplexTableIndex":
        return cls(
            NSimplexIndex(data, pivots, metric, eps=eps, use_kernel=use_kernel, device=device),
            metric,
        )

    @property
    def data(self):
        """The corpus, a tensor on the index's device."""
        return self._inner.data

    @property
    def table(self):
        """The float64 apex table, a tensor on the index's device."""
        return self._inner.table

    @property
    def n_pivots(self) -> int:
        return self._inner.n_pivots

    @property
    def device(self):
        return self._inner.device

    def fit(self, data) -> "SimplexTableIndex":
        """Rebuild over new data, reusing the fitted pivots and metric."""
        self._inner = NSimplexIndex(
            data,
            None,
            self.metric,
            eps=self._inner.eps,
            use_kernel=self._inner.use_kernel,
            projector=self._inner.projector,
            device=self._inner.device,
        )
        return self

    # -- execution primitives (dispatched by repro_torch.api.execute) ---------
    def _exec_search(self, q, threshold: float, qpd=None, rowmask=None) -> QueryResult:
        ids, st = self._inner.search(q, threshold, qpd=qpd, rowmask=rowmask)
        return QueryResult(ids=ids, distances=None, stats=st)

    def _exec_search_batch(self, queries, thresholds, qpd=None, rowmask=None) -> BatchQueryResult:
        t0 = time.perf_counter()
        pairs = self._inner.search_batch(queries, thresholds, qpd=qpd, rowmask=rowmask)
        return _batch([QueryResult(ids=ids, distances=None, stats=st) for ids, st in pairs], t0)

    def _exec_knn(self, q, k: int, qpd=None, radius_hint=None, rowmask=None) -> QueryResult:
        ids, d, st = self._inner.knn(q, k, qpd=qpd, radius_hint=radius_hint, rowmask=rowmask)
        return QueryResult(ids=ids, distances=d, stats=st)

    def _exec_knn_batch(self, queries, k: int, qpd=None, radius_hint=None, rowmask=None) -> BatchQueryResult:
        t0 = time.perf_counter()
        triples = self._inner.knn_batch(queries, k, qpd=qpd, radius_hint=radius_hint, rowmask=rowmask)
        return _batch([QueryResult(ids=ids, distances=d, stats=st) for ids, d, st in triples], t0)

    def stats(self) -> dict:
        table = self._inner.table
        return {
            "kind": self.kind,
            "metric": self.metric.name,
            "n_objects": int(self._inner.data.shape[0]),
            "dim": int(self._inner.data.shape[1]),
            "n_pivots": int(self._inner.n_pivots),
            "table_bytes": int(table.numel() * table.element_size()),
        }

    # -- persistence ----------------------------------------------------------
    def save(self, path) -> None:
        """Write the index in the format the JAX package's ``load_index`` reads."""
        cfg = metric_to_config(self.metric)
        metric_arrays = cfg.pop("arrays", {})
        write_index_dir(
            path,
            kind=self.kind,
            params={
                "metric": cfg,
                "eps": self._inner.eps,
                "use_kernel": self._inner.use_kernel,
                "approx": None,
                "query_options": self.query_options.to_dict() if self.query_options else None,
            },
            arrays={**self._inner.state_arrays(), **metric_arrays},
        )

    @classmethod
    def _load(cls, manifest: dict, arrays: dict, *, device="cuda") -> "SimplexTableIndex":
        params = manifest["params"]
        if params.get("approx"):
            raise NotImplementedError(
                "index was built with apex_dims (approximate search), not yet "
                "ported to repro_torch"
            )
        metric = metric_from_config(params["metric"], arrays)
        inner = NSimplexIndex.from_state(
            arrays, metric, eps=params["eps"], use_kernel=params["use_kernel"], device=device
        )
        out = cls(inner, metric)
        out.query_options = QueryOptions.from_dict(params.get("query_options"))
        return out
