"""Protocol implementations: one class per index mechanism.

Each wraps the low-level structure (``NSimplexIndex`` / ``LaesaIndex`` /
``HyperplaneTree``), adapts its tuple-returning methods to the typed
``QueryResult``/``BatchQueryResult`` carriers, and owns persistence in the
JAX package's manifest + npz format.  Each class implements the four
private ``_exec_*`` primitives that the shared executor
(``repro_torch.api.execute``) dispatches to, taking the plan-resolved
approx config (``{"dims", "refine"}`` or None for exact).

Construct them through ``repro_torch.api.build_index`` / ``load_index``: the
factory owns pivot selection and kind dispatch.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.api.execute import QuerySurface
from repro_torch.api.persistence import write_index_dir
from repro_torch.api.query import DEFAULT_REFINE, QueryOptions
from repro_torch.api.types import BatchQueryResult, QueryResult, QueryStats
from repro_torch.device import resolve_device
from repro_torch.index.hyperplane_tree import HyperplaneTree
from repro_torch.index.laesa import LaesaIndex
from repro_torch.index.nsimplex_index import NSimplexIndex
from repro_torch.index.rows import device_rows, row_mask
from repro_torch.metrics import Metric, metric_from_config, metric_to_config

__all__ = ["MetricTreeIndex", "PivotTableIndex", "SimplexTableIndex"]


def _batch(results: List[QueryResult], t0: float) -> BatchQueryResult:
    return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)


def _save(index, path, params: dict, arrays: dict) -> None:
    """Write ``index`` with its metric and query options in the manifest."""
    cfg = metric_to_config(index.metric)
    metric_arrays = cfg.pop("arrays", {})
    params = {
        "metric": cfg,
        **params,
        "query_options": index.query_options.to_dict() if index.query_options else None,
    }
    write_index_dir(path, kind=index.kind, params=params, arrays={**arrays, **metric_arrays})
    index._save_attributes(path)


def _restore_options(index, params: dict):
    index.query_options = QueryOptions.from_dict(params.get("query_options"))
    return index


class _TableIndex(QuerySurface):
    """Shared adaptation layer of the two pivot-table mechanisms.

    ``approx`` (``{"dims": k, "refine": m}`` or None) is the truncation
    config fixed at build time (``build_index(..., apex_dims=k)``): with it
    the planner defaults queries to the approximate path and every result
    carries ``QueryResult.approx``; ``Query(mode=..., dims=..., refine=...)``
    overrides per query, so one fitted index serves the whole quality dial.
    """

    kind = "abstract"

    def __init__(self, inner, metric: Metric, approx: Optional[dict] = None):
        self._inner = inner
        self.metric = metric
        self.approx = dict(approx) if approx else None

    @property
    def data(self) -> torch.Tensor:
        """The corpus, a tensor on the index's device."""
        return self._inner.data

    @property
    def table(self) -> torch.Tensor:
        """The float64 per-object surrogate table (apex coordinates or pivot
        distances), a tensor on the index's device."""
        return self._inner.table

    @property
    def n_pivots(self) -> int:
        return self._inner.n_pivots

    @property
    def device(self) -> torch.device:
        return self._inner.device

    def fit(self, data) -> "_TableIndex":
        """Rebuild over new data, reusing the fitted pivots and metric."""
        self._inner = self.spawn(data)._inner
        return self

    def extend(self, rows) -> "_TableIndex":
        """A NEW same-config segment over this segment's rows plus ``rows``
        (only the new rows' table entries are measured; the fitted state is
        shared).  Functional: ``self`` is never mutated, so point-in-time
        read views holding this segment stay consistent while the live index
        extends its delta."""
        inner = self._inner.extended(rows)
        if inner is self._inner:
            return self
        return type(self)(inner, self.metric, self.approx)

    def query_pivot_distances(self, queries, cfg: Optional[dict] = None) -> torch.Tensor:
        """The (Q, width) float64 query-pivot distances (on the index's
        device) that this segment's ``_exec_*`` primitives accept as
        ``qpd``: the one original-metric cost every segment sharing this
        pivot set has in common.  A composite measures it once per query
        block and forwards it, and owns the ``original_calls`` of the block
        (``width`` per query)."""
        inner = self._inner
        queries = torch.atleast_2d(inner._tensor(queries))
        dims = None if cfg is None else int(cfg["dims"])
        return self.metric.cross(queries, inner._tensor(inner.pivot_rows(dims)))

    # -- execution primitives (dispatched by repro_torch.api.execute) ---------
    # ``rowmask`` (optional) restricts a primitive to the allowed row
    # positions, forwarded to the inner structure's masked scan paths.
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


class SimplexTableIndex(_TableIndex):
    """Apex table + fused two-sided simplex bounds (the paper's mechanism)."""

    kind = "nsimplex"

    #: overflow-route queries of the structures ``fit`` replaced
    _overflow_before_fit = 0

    @property
    def overflow_queries(self) -> int:
        """Queries whose K3 count exceeded its capacity (k-NN pass B, then
        K3 again at a width that holds them; range search, then K1 per
        query); the count survives ``fit``.  It stays out of ``stats()``, which
        holds the JAX package's keys."""
        return self._overflow_before_fit + self._inner.overflow_queries

    def fit(self, data) -> "SimplexTableIndex":
        self._overflow_before_fit = self.overflow_queries
        return super().fit(data)

    @classmethod
    def build(cls, data, metric: Metric, *, pivots, eps: float = 1e-6, use_kernel: bool = True,
              approx: Optional[dict] = None, device="cuda") -> "SimplexTableIndex":
        return cls(
            NSimplexIndex(data, pivots, metric, eps=eps, use_kernel=use_kernel, device=device),
            metric,
            approx,
        )

    def spawn(self, data) -> "SimplexTableIndex":
        """New same-config index over ``data``, sharing the fitted simplex
        (pivots, Cholesky factors): no inter-pivot distance is re-measured."""
        inner = NSimplexIndex(
            data,
            None,
            self.metric,
            eps=self._inner.eps,
            use_kernel=self._inner.use_kernel,
            projector=self._inner.projector,
            device=self._inner.device,
        )
        return type(self)(inner, self.metric, self.approx)

    def save(self, path) -> None:
        """Write the index in the format the JAX package's ``load_index`` reads."""
        _save(
            self,
            path,
            {"eps": self._inner.eps, "use_kernel": self._inner.use_kernel, "approx": self.approx},
            self._inner.state_arrays(),
        )

    @classmethod
    def _load(cls, manifest: dict, arrays: dict, *, device="cuda") -> "SimplexTableIndex":
        params = manifest["params"]
        metric = metric_from_config(params["metric"], arrays)
        inner = NSimplexIndex.from_state(
            arrays, metric, eps=params["eps"], use_kernel=params["use_kernel"], device=device
        )
        return _restore_options(cls(inner, metric, params.get("approx")), params)


class PivotTableIndex(_TableIndex):
    """LAESA pivot-distance table + Chebyshev/triangle bounds (baseline)."""

    kind = "laesa"

    @classmethod
    def build(cls, data, metric: Metric, *, pivots, approx: Optional[dict] = None,
              device="cuda") -> "PivotTableIndex":
        return cls(LaesaIndex(data, pivots, metric, device=device), metric, approx)

    def spawn(self, data) -> "PivotTableIndex":
        """New same-config index over ``data`` with the fitted pivots."""
        return type(self).build(
            data, self.metric, pivots=self._inner.pivots, approx=self.approx, device=self._inner.device
        )

    def save(self, path) -> None:
        _save(self, path, {"approx": self.approx}, self._inner.state_arrays())

    @classmethod
    def _load(cls, manifest: dict, arrays: dict, *, device="cuda") -> "PivotTableIndex":
        params = manifest["params"]
        metric = metric_from_config(params["metric"], arrays)
        inner = LaesaIndex.from_state(arrays, metric, device=device)
        return _restore_options(cls(inner, metric, params.get("approx")), params)


def _metric_dist_fn(metric: Metric):
    """The tree's row-space distance over the original space."""
    return lambda q, rows: metric.one_to_many(q, rows)


class MetricTreeIndex(QuerySurface):
    """Monotone hyperplane tree over the original space (Hilbert exclusion)."""

    kind = "tree"

    def __init__(self, data: torch.Tensor, metric: Metric, tree: HyperplaneTree, *,
                 leaf_size: int = 32, seed: int = 0):
        self.data = data
        self.metric = metric
        self._tree = tree
        self._leaf_size = int(leaf_size)
        self._seed = int(seed)

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def build(cls, data, metric: Metric, *, leaf_size: int = 32, seed: int = 0,
              device="cuda") -> "MetricTreeIndex":
        rows = device_rows(data, resolve_device(device))
        tree = HyperplaneTree(rows, _metric_dist_fn(metric), supermetric=True, leaf_size=leaf_size, seed=seed)
        return cls(rows, metric, tree, leaf_size=leaf_size, seed=seed)

    def spawn(self, data) -> "MetricTreeIndex":
        """New same-config index over ``data`` (the tree has no shared
        fitted state beyond its parameters, so this is a fresh build)."""
        return type(self).build(data, self.metric, leaf_size=self._leaf_size, seed=self._seed, device=self.device)

    def fit(self, data) -> "MetricTreeIndex":
        fresh = self.spawn(data)
        self.data, self._tree = fresh.data, fresh._tree
        return self

    def extend(self, rows) -> "MetricTreeIndex":
        """Trees have no append path: a delta segment is rebuilt over the
        combined rows (delta segments are small by construction)."""
        rows = torch.atleast_2d(device_rows(rows, self.device))
        if not rows.shape[0]:
            return self
        return self.spawn(torch.cat([self.data, rows]) if self.data.shape[0] else rows)

    @staticmethod
    def _original_stats(st: QueryStats) -> QueryStats:
        # the generic tree counts calls as surrogate; over the original space
        # with the original metric they ARE original-space calls
        return QueryStats(
            original_calls=st.surrogate_calls,
            surrogate_calls=0,
            accepted_no_check=st.accepted_no_check,
            candidates=st.candidates,
        )

    # -- execution primitives (dispatched by repro_torch.api.execute) ---------
    # The tree has no truncatable surrogate: the planner never resolves an
    # approx config for it.  It has no pivot table either, so ``qpd`` and a
    # ``radius_hint`` are accepted and ignored (the full top-k is a valid
    # superset of the capped set).  The traversal has no masked variant, so a
    # ``rowmask`` is answered by exact post-filtering: range results drop
    # masked ids; k-NN over-fetches with doubling k' until the unfiltered
    # top-k' holds k allowed rows (then the k best allowed rows overall are
    # among them).
    def _exec_search(self, q, threshold: float, cfg=None, qpd=None, rowmask=None) -> QueryResult:
        if cfg is not None:
            raise ValueError("the tree kind has no approximate path")
        ids, d, st = self._tree.query_with_distances(q, threshold)
        order = np.argsort(ids, kind="stable")
        ids, d = ids[order], d[order]
        mask = row_mask(rowmask, self.data.shape[0])
        if mask is not None:
            keep = mask[ids]
            ids, d = ids[keep], d[keep]
        return QueryResult(ids=ids, distances=d, stats=self._original_stats(st))

    def _exec_search_batch(self, queries, thresholds, cfg=None, qpd=None, rowmask=None) -> BatchQueryResult:
        queries = np.atleast_2d(np.asarray(queries))
        thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (queries.shape[0],))
        t0 = time.perf_counter()
        return _batch([self._exec_search(q, t, cfg, rowmask=rowmask) for q, t in zip(queries, thresholds)], t0)

    def _exec_knn(self, q, k: int, cfg=None, qpd=None, radius_hint=None, rowmask=None) -> QueryResult:
        if cfg is not None:
            raise ValueError("the tree kind has no approximate path")
        mask = row_mask(rowmask, self.data.shape[0])
        if mask is None:
            ids, d, st = self._tree.knn(q, k)
            return QueryResult(ids=ids, distances=d, stats=self._original_stats(st))
        N = self.data.shape[0]
        k_eff = min(int(k), int(mask.sum()))
        if k_eff <= 0:
            return QueryResult(ids=np.empty(0, dtype=np.int64), distances=np.empty(0, dtype=np.float64),
                               stats=QueryStats())
        fetch = min(N, max(2 * int(k), int(k) + 16))
        while True:
            ids, d, st = self._tree.knn(q, fetch)
            keep = mask[ids]
            if int(keep.sum()) >= k_eff or fetch >= N:
                break
            fetch = min(N, fetch * 2)
        return QueryResult(ids=ids[keep][:k_eff], distances=d[keep][:k_eff], stats=self._original_stats(st))

    def _exec_knn_batch(self, queries, k: int, cfg=None, qpd=None, radius_hint=None, rowmask=None) -> BatchQueryResult:
        queries = np.atleast_2d(np.asarray(queries))
        t0 = time.perf_counter()
        return _batch([self._exec_knn(q, k, cfg, rowmask=rowmask) for q in queries], t0)

    def save(self, path) -> None:
        _save(
            self,
            path,
            {"leaf_size": self._leaf_size, "seed": self._seed, "supermetric": self._tree.supermetric},
            {"data": self.data.cpu().numpy(), **self._tree.to_arrays()},
        )

    @classmethod
    def _load(cls, manifest: dict, arrays: dict, *, device="cuda") -> "MetricTreeIndex":
        params = manifest["params"]
        metric = metric_from_config(params["metric"], arrays)
        rows = torch.tensor(np.asarray(arrays["data"]), device=resolve_device(device))
        tree = HyperplaneTree.from_arrays(
            rows,
            _metric_dist_fn(metric),
            arrays,
            supermetric=params["supermetric"],
            leaf_size=params["leaf_size"],
            seed=params["seed"],
        )
        return _restore_options(
            cls(rows, metric, tree, leaf_size=params["leaf_size"], seed=params["seed"]), params
        )

    def stats(self) -> dict:
        return {
            "kind": self.kind,
            "metric": self.metric.name,
            "n_objects": int(self.data.shape[0]),
            "dim": int(self.data.shape[1]),
            "leaf_size": self._leaf_size,
            "build_calls": int(self._tree.build_calls),
        }
