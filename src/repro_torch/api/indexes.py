"""``SimplexTableIndex``: the protocol class of the n-simplex mechanism.

It wraps ``NSimplexIndex``, adapts its tuple-returning methods to the typed
result carriers, and owns persistence in the shared manifest + npz format.
Construct it through ``repro_torch.api.build_index`` / ``load_index``.

``approx`` (``{"dims": k, "refine": m}`` or None) is the truncation config
fixed at build time (``build_index(..., apex_dims=k)``): with it the planner
defaults queries to the approximate path and every result carries
``QueryResult.approx``; ``Query(mode=..., dims=..., refine=...)`` overrides
per query, so one fitted index serves the whole quality dial.
"""

from __future__ import annotations

import time
from typing import List, Optional

from repro_torch.api.execute import QuerySurface
from repro_torch.api.persistence import write_index_dir
from repro_torch.api.query import DEFAULT_REFINE, QueryOptions
from repro_torch.api.types import BatchQueryResult, QueryResult
from repro_torch.index.nsimplex_index import NSimplexIndex
from repro_torch.metrics import Metric, metric_from_config, metric_to_config

__all__ = ["SimplexTableIndex"]


def _batch(results: List[QueryResult], t0: float) -> BatchQueryResult:
    return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)


class SimplexTableIndex(QuerySurface):
    """Apex table + fused two-sided simplex bounds (the paper's mechanism)."""

    kind = "nsimplex"

    def __init__(self, inner: NSimplexIndex, metric: Metric, approx: Optional[dict] = None):
        self._inner = inner
        self.metric = metric
        self.approx = dict(approx) if approx else None

    @classmethod
    def build(cls, data, metric: Metric, *, pivots, eps: float = 1e-6, use_kernel: bool = True,
              approx: Optional[dict] = None, device="cuda") -> "SimplexTableIndex":
        return cls(
            NSimplexIndex(data, pivots, metric, eps=eps, use_kernel=use_kernel, device=device),
            metric,
            approx,
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
    # ``cfg`` is the plan's approx config ({"dims", "refine"}), None when exact.
    def _exec_search(self, q, threshold: float, cfg: Optional[dict], qpd=None, rowmask=None) -> QueryResult:
        if cfg is None:
            ids, st = self._inner.search(q, threshold, qpd=qpd, rowmask=rowmask)
        else:
            ids, st = self._inner.search_approx(
                q, threshold, dims=cfg["dims"], refine=cfg["refine"], qpd=qpd, rowmask=rowmask
            )
        return QueryResult(ids=ids, distances=None, stats=st, approx=cfg)

    def _exec_search_batch(self, queries, thresholds, cfg: Optional[dict], qpd=None, rowmask=None) -> BatchQueryResult:
        t0 = time.perf_counter()
        if cfg is None:
            pairs = self._inner.search_batch(queries, thresholds, qpd=qpd, rowmask=rowmask)
        else:
            pairs = self._inner.search_approx_batch(
                queries, thresholds, dims=cfg["dims"], refine=cfg["refine"], qpd=qpd, rowmask=rowmask
            )
        return _batch([QueryResult(ids=ids, distances=None, stats=st, approx=cfg) for ids, st in pairs], t0)

    def _exec_knn(self, q, k: int, cfg: Optional[dict], qpd=None, radius_hint=None, rowmask=None) -> QueryResult:
        if cfg is None:
            ids, d, st = self._inner.knn(q, k, qpd=qpd, radius_hint=radius_hint, rowmask=rowmask)
        else:
            ids, d, st = self._inner.knn_approx(
                q, k, dims=cfg["dims"], refine=cfg["refine"], qpd=qpd, rowmask=rowmask
            )
        return QueryResult(ids=ids, distances=d, stats=st, approx=cfg)

    def _exec_knn_batch(self, queries, k: int, cfg: Optional[dict], qpd=None, radius_hint=None,
                        rowmask=None) -> BatchQueryResult:
        t0 = time.perf_counter()
        if cfg is None:
            triples = self._inner.knn_batch(queries, k, qpd=qpd, radius_hint=radius_hint, rowmask=rowmask)
        else:
            triples = self._inner.knn_approx_batch(
                queries, k, dims=cfg["dims"], refine=cfg["refine"], qpd=qpd, rowmask=rowmask
            )
        return _batch([QueryResult(ids=ids, distances=d, stats=st, approx=cfg) for ids, d, st in triples], t0)

    def stats(self) -> dict:
        table = self._inner.table
        out = {
            "kind": self.kind,
            "metric": self.metric.name,
            "n_objects": int(self._inner.data.shape[0]),
            "dim": int(self._inner.data.shape[1]),
            "n_pivots": int(self._inner.n_pivots),
            "table_bytes": int(table.numel() * table.element_size()),
        }
        if self.approx:
            out["apex_dims"] = int(self.approx["dims"])
            out["refine"] = int(self.approx.get("refine", DEFAULT_REFINE))
            out["surrogate_bytes_per_object"] = int(self.approx["dims"]) * table.element_size()
        return out

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
                "approx": self.approx,
                "query_options": self.query_options.to_dict() if self.query_options else None,
            },
            arrays={**self._inner.state_arrays(), **metric_arrays},
        )

    @classmethod
    def _load(cls, manifest: dict, arrays: dict, *, device="cuda") -> "SimplexTableIndex":
        params = manifest["params"]
        metric = metric_from_config(params["metric"], arrays)
        inner = NSimplexIndex.from_state(
            arrays, metric, eps=params["eps"], use_kernel=params["use_kernel"], device=device
        )
        out = cls(inner, metric, params.get("approx"))
        out.query_options = QueryOptions.from_dict(params.get("query_options"))
        return out
