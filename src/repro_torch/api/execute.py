"""The one executor behind the index query surface.

``execute(index, q_or_batch, query)`` resolves the ``QueryPlan`` (unless one
is passed in), dispatches to the index's ``_exec_*`` primitives and applies
the id filters.  A 1-D input answers as a ``QueryResult``, a 2-D block as a
``BatchQueryResult``.  ``QuerySurface`` gives an index class ``query`` /
``plan`` plus the legacy ``search``/``search_batch``/``knn``/``knn_batch``
shims over them.

The plan's approx config (``{"dims", "refine"}``, None for an exact plan)
rides into every primitive, so exact and approximate plans take the same
dispatch.  Id filters (all exact): ``allow`` is a direct true-metric scan of
the listed rows; ``deny`` with k-NN over-fetches ``k + len(deny)`` and drops
the denied ids; ``deny`` with range post-filters the verified set.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.planner import QueryPlan, plan as make_plan
from repro_torch.api.query import Query
from repro_torch.api.types import BatchQueryResult, QueryResult, QueryStats
from repro_torch.index.knn import knn_select

__all__ = ["QuerySurface", "execute"]


def _allow_direct(index, queries: np.ndarray, spec: Query):
    """Exact scan of the live rows of the allowlist, on the index's device."""
    want = np.asarray(spec.allow, dtype=np.int64)
    sel_ids = want[want < index.data.shape[0]]
    rows = index.data[torch.as_tensor(sel_ids, device=index.data.device)]
    out = []
    for qi, q in enumerate(queries):
        if len(sel_ids):
            q_t = torch.as_tensor(q, device=rows.device)
            d = np.asarray(index.metric.one_to_many(q_t, rows).cpu().numpy(), dtype=np.float64)
        else:
            d = np.empty(0, dtype=np.float64)
        stats = QueryStats(original_calls=len(sel_ids), candidates=len(sel_ids))
        if spec.task == "knn":
            ids, dd = knn_select(d, sel_ids, min(spec.k, len(sel_ids)))
            out.append(QueryResult(ids=ids, distances=dd, stats=stats))
        else:
            keep = d <= _threshold_for(spec, qi)
            out.append(QueryResult(ids=sel_ids[keep], distances=d[keep], stats=stats))
    return out


def _threshold_for(spec: Query, qi: int) -> float:
    t = spec.threshold
    return float(t[qi] if isinstance(t, tuple) and len(t) > 1 else (t[0] if isinstance(t, tuple) else t))


def _drop_denied(r: QueryResult, deny, k=None) -> QueryResult:
    keep = ~np.isin(r.ids, np.asarray(deny, dtype=np.int64))
    return QueryResult(
        ids=r.ids[keep][:k],
        distances=None if r.distances is None else r.distances[keep][:k],
        stats=r.stats,
        approx=r.approx,
    )


def _broadcast_thresholds(spec: Query, n: int) -> np.ndarray:
    arr = np.asarray(spec.threshold, dtype=np.float64)
    if arr.ndim == 1 and arr.shape[0] not in (1, n):
        raise ValueError(
            f"per-query threshold tuple has {arr.shape[0]} entries for a batch of {n} queries"
        )
    return np.broadcast_to(arr.ravel() if arr.ndim else arr, (n,))


def execute(index, q, spec: Query, *, plan: Optional[QueryPlan] = None):
    """Answer ``spec`` over ``q`` (1-D: one query -> ``QueryResult``; 2-D:
    a block -> ``BatchQueryResult``) through the resolved plan."""
    if not isinstance(spec, Query):
        raise TypeError(f"expected a Query; got {type(spec).__name__}")
    qp = plan if plan is not None else make_plan(index, spec)
    q = np.asarray(q)
    if q.ndim not in (1, 2):
        raise ValueError(f"queries must be 1-D or 2-D; got shape {q.shape}")
    single = q.ndim == 1
    queries = np.atleast_2d(q)
    if spec.task == "range" and isinstance(spec.threshold, tuple):
        if len(spec.threshold) not in (1, queries.shape[0]):
            raise ValueError(
                f"per-query threshold tuple has {len(spec.threshold)} entries "
                f"for a batch of {queries.shape[0]} queries"
            )
    return _dispatch(index, q, queries, single, spec, qp)


def _dispatch(index, q, queries, single: bool, spec: Query, qp: QueryPlan):
    """The strategy dispatch behind ``execute`` (one return point per path)."""
    cfg = qp.approx_cfg
    t0 = time.perf_counter()
    if qp.filter_strategy == "allow_direct":
        results = _allow_direct(index, queries, spec)
        if single:
            return results[0]
        return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)

    if spec.task == "knn":
        if qp.filter_strategy == "deny_overfetch":
            fetch = spec.k + len(spec.deny)
            if single:
                return _drop_denied(index._exec_knn(q, fetch, cfg), spec.deny, spec.k)
            b = index._exec_knn_batch(queries, fetch, cfg)
            return BatchQueryResult(
                results=[_drop_denied(r, spec.deny, spec.k) for r in b.results],
                elapsed_s=b.elapsed_s,
            )
        if single:
            return index._exec_knn(q, spec.k, cfg)
        return index._exec_knn_batch(queries, spec.k, cfg)

    if single:
        r = index._exec_search(q, _threshold_for(spec, 0), cfg)
        return _drop_denied(r, spec.deny) if spec.deny else r
    b = index._exec_search_batch(queries, _broadcast_thresholds(spec, queries.shape[0]), cfg)
    if spec.deny:
        return BatchQueryResult(
            results=[_drop_denied(r, spec.deny) for r in b.results], elapsed_s=b.elapsed_s
        )
    return b


class QuerySurface:
    """Declarative entry point plus the legacy method family as shims.

    A class mixing this in implements ``_exec_search``,
    ``_exec_search_batch``, ``_exec_knn`` and ``_exec_knn_batch``, each
    taking the plan's approx config (None when exact).
    """

    #: per-index query defaults (set by ``build_index(query_options=...)``)
    query_options = None

    def query(self, q, spec: Query, *, plan: Optional[QueryPlan] = None):
        """Answer one ``Query`` over a single vector (1-D) or a block (2-D)."""
        return execute(self, q, spec, plan=plan)

    def plan(self, spec: Query) -> QueryPlan:
        """The plan ``query()`` would use (see ``explain()``)."""
        return make_plan(self, spec)

    def search(self, q, threshold: float, *, mode=None, dims=None, refine=None):
        """Shim for ``query(q, Query.range(threshold, ...))``."""
        return self.query(
            np.asarray(q),
            Query.range(float(threshold), mode=mode or "auto", dims=dims, refine=refine),
        )

    def search_batch(self, queries, thresholds, *, mode=None, dims=None, refine=None):
        """Shim for ``query(queries, Query.range(...))``."""
        queries = np.atleast_2d(np.asarray(queries))
        if queries.shape[0] == 0:
            return BatchQueryResult(results=[], elapsed_s=0.0)
        th = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (queries.shape[0],))
        return self.query(
            queries,
            Query.range(tuple(float(x) for x in th), mode=mode or "auto", dims=dims, refine=refine),
        )

    def knn(self, q, k: int, *, mode=None, dims=None, refine=None):
        """Shim for ``query(q, Query.knn(k, ...))``."""
        return self.query(
            np.asarray(q), Query.knn(int(k), mode=mode or "auto", dims=dims, refine=refine)
        )

    def knn_batch(self, queries, k: int, *, mode=None, dims=None, refine=None):
        """Shim for ``query(queries, Query.knn(k, ...))``."""
        return self.query(
            np.atleast_2d(np.asarray(queries)),
            Query.knn(int(k), mode=mode or "auto", dims=dims, refine=refine),
        )
