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
the listed live rows; ``deny`` with k-NN over-fetches ``k + len(deny)`` and
drops the denied ids; ``deny`` with range post-filters the verified set.

Attribute predicates (``Query.where``) compile to the sorted logical ids of
the matching rows (``AttributeStore.match``, composed with allow/deny) and
run one of three strategies: ``prefilter`` scans those rows directly (the
allowlist path), ``pushdown`` hands them to the index as a ``rowmask`` (the
bound-scan kernels' row mask), ``postfilter`` over-fetches unfiltered and
keeps the matching rows, doubling the fetch until ``k`` match.

Logical ids are not row positions on a mutable index (removed ids,
compaction); the direct scans map ids to rows through the index's live
``(ids, rows)`` view, never by position.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.api.planner import QueryPlan, plan as make_plan
from repro_torch.api.query import Query
from repro_torch.api.types import BatchQueryResult, QueryResult, QueryStats

__all__ = ["QuerySurface", "execute"]


# -- id-filter helpers ---------------------------------------------------------
def _live_rows(index):
    """(ascending logical ids, aligned rows on the index's device) of any
    index.  A composite materialises ``.data`` by gathering its segments, so
    the view is cached on the instance under its mutation ``version``; a
    plain index exposes ``.data`` by reference, has no version and is not
    cached."""
    version = getattr(index, "version", None)
    cached = getattr(index, "_live_rows_cache", None)
    if version is not None and cached is not None and cached[0] == version:
        return cached[1], cached[2]
    rows = index.data
    ids_fn = getattr(index, "ids", None)
    lids = np.asarray(ids_fn(), dtype=np.int64) if callable(ids_fn) else np.arange(rows.shape[0], dtype=np.int64)
    if version is not None:
        index._live_rows_cache = (version, lids, rows)
    return lids, rows


def _allow_selection(index, allow):
    """(logical ids, rows) of the live subset of ``allow``, ids ascending."""
    lids, rows = _live_rows(index)
    want = np.asarray(allow, dtype=np.int64)
    pos = np.searchsorted(lids, want)
    pos_c = np.minimum(pos, max(len(lids) - 1, 0))
    valid = (pos < len(lids)) & (lids[pos_c] == want) if len(lids) else np.zeros(len(want), bool)
    sel = pos[valid]
    return lids[sel], rows[torch.as_tensor(sel, device=rows.device)]


def _allow_direct(index, queries: np.ndarray, spec: Query, want=None):
    """Exact scan of an explicit id set (the allowlist, or a predicate's
    matching rows under the prefilter strategy) on the index's device.  The
    selected ids ascend, so a stable sort by distance is the (distance, id)
    order of ``knn_select``."""
    sel_ids, sel_rows = _allow_selection(index, spec.allow if want is None else want)
    n = len(sel_ids)
    out = []
    for qi, q in enumerate(queries):
        stats = QueryStats(original_calls=n, candidates=n)
        if n:
            d = index.metric.one_to_many(torch.as_tensor(q, device=sel_rows.device), sel_rows).to(torch.float64)
        else:
            d = torch.empty(0, dtype=torch.float64)
        if spec.task == "knn":
            top = torch.sort(d, stable=True)
            take = min(spec.k, n)
            pos = top.indices[:take].cpu().numpy()
            out.append(QueryResult(ids=sel_ids[pos], distances=top.values[:take].cpu().numpy(), stats=stats))
        else:
            keep = torch.nonzero(d <= _threshold_for(spec, qi)).flatten()
            out.append(QueryResult(ids=sel_ids[keep.cpu().numpy()], distances=d[keep].cpu().numpy(), stats=stats))
    return out


# -- predicate strategies ------------------------------------------------------
def _match_ids(index, spec: Query) -> np.ndarray:
    """Sorted logical ids satisfying ``spec.where`` composed with allow/deny."""
    store = getattr(index, "attributes", None)
    if store is None:
        raise ValueError("query has a 'where' predicate but the index carries no attribute store")
    match = store.match(spec.where)
    if spec.allow is not None:
        match = np.intersect1d(match, np.asarray(spec.allow, dtype=np.int64))
    if spec.deny:
        match = np.setdiff1d(match, np.asarray(spec.deny, dtype=np.int64))
    return match


def _empty_result() -> QueryResult:
    return QueryResult(ids=np.empty(0, dtype=np.int64), distances=np.empty(0, dtype=np.float64), stats=QueryStats())


def _keep_matching(r: QueryResult, match: np.ndarray, limit=None) -> QueryResult:
    keep = np.isin(r.ids, match)
    return QueryResult(
        ids=r.ids[keep][:limit],
        distances=None if r.distances is None else r.distances[keep][:limit],
        stats=r.stats,
        approx=r.approx,
    )


def _postfilter_knn_one(index, q, k: int, cfg, match, n_live: int) -> QueryResult:
    """Grow-overfetch loop: fetch, keep the matching rows, double until
    ``k`` match or the index is exhausted; exact, because the final fetch
    holds the k nearest matching rows."""
    fetch = min(n_live, max(2 * k, k + 16))
    while True:
        r = index._exec_knn(q, fetch, cfg)
        if int(np.isin(r.ids, match).sum()) >= k or fetch >= n_live or len(r.ids) < fetch:
            return _keep_matching(r, match, k)
        fetch = min(n_live, fetch * 2)


def _dispatch_predicate(index, q, queries, single: bool, spec: Query, qp: QueryPlan):
    """The three predicate strategies (plan ``filter_strategy`` =
    ``predicate_{prefilter,pushdown,postfilter}``)."""
    cfg = qp.approx_cfg
    strategy = qp.filter_strategy.split("_", 1)[1]
    t0 = time.perf_counter()
    match = _match_ids(index, spec)

    def _batch(results):
        return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)

    if match.size == 0:
        results = [_empty_result() for _ in range(queries.shape[0])]
        return results[0] if single else _batch(results)

    if strategy == "prefilter":
        results = _allow_direct(index, queries, spec, want=match)
        return results[0] if single else _batch(results)

    if strategy == "pushdown":
        if spec.task == "knn":
            if single:
                return index._exec_knn(q, spec.k, cfg, rowmask=match)
            return index._exec_knn_batch(queries, spec.k, cfg, rowmask=match)
        if single:
            return index._exec_search(q, _threshold_for(spec, 0), cfg, rowmask=match)
        return index._exec_search_batch(queries, _broadcast_thresholds(spec, queries.shape[0]), cfg, rowmask=match)

    # postfilter
    n_live = len(_live_rows(index)[0])
    if spec.task == "knn":
        if single:
            return _postfilter_knn_one(index, q, spec.k, cfg, match, n_live)
        fetch = min(n_live, max(2 * spec.k, spec.k + 16))
        b = index._exec_knn_batch(queries, fetch, cfg)
        results = []
        for qi, r in enumerate(b.results):
            if int(np.isin(r.ids, match).sum()) >= spec.k or fetch >= n_live or len(r.ids) < fetch:
                results.append(_keep_matching(r, match, spec.k))
            else:
                results.append(_postfilter_knn_one(index, queries[qi], spec.k, cfg, match, n_live))
        return _batch(results)
    if single:
        return _keep_matching(index._exec_search(q, _threshold_for(spec, 0), cfg), match)
    b = index._exec_search_batch(queries, _broadcast_thresholds(spec, queries.shape[0]), cfg)
    return _batch([_keep_matching(r, match) for r in b.results])


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


def execute(index, q, spec: Query, *, plan: Optional[QueryPlan] = None, telemetry=None):
    """Answer ``spec`` over ``q`` (1-D: one query -> ``QueryResult``; 2-D:
    a block -> ``BatchQueryResult``) through the resolved plan.

    ``telemetry`` (default: the index's own ``telemetry`` attribute, a
    ``repro_torch.serve.Telemetry``) observes every execution: the plan, the
    block size, the wall time and the result.  The results are host arrays,
    so the wall time covers the device work.  A caller that executes on
    another object than the one the user holds (a durable index runs on one
    read view) passes its own."""
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
    if queries.shape[0] == 0:
        # a 0-row block answers empty before any per-block reduction (the
        # f32 slack's max over the queries, the device filter's min
        # threshold) on every kind and composite; it carries no cost to
        # observe
        return BatchQueryResult(results=[], elapsed_s=0.0)
    t0 = time.perf_counter()
    with tracing.span("api.execute", rows=queries.shape[0], mechanism=qp.mechanism, task=qp.task, mode=qp.mode):
        out = _dispatch(index, q, queries, single, spec, qp)
    if telemetry is None:
        telemetry = getattr(index, "telemetry", None)
    if telemetry is not None:
        telemetry.observe(qp, queries.shape[0], time.perf_counter() - t0, out)
    return out


def _dispatch(index, q, queries, single: bool, spec: Query, qp: QueryPlan):
    """The strategy dispatch behind ``execute`` (one return point per path)."""
    cfg = qp.approx_cfg
    t0 = time.perf_counter()
    if qp.filter_strategy.startswith("predicate_"):
        return _dispatch_predicate(index, q, queries, single, spec, qp)
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

    #: optional ``repro_torch.filter.AttributeStore`` riding with the index
    #: (``build_index(attributes=...)`` or ``attach_attributes``); required
    #: by ``Query.where`` predicates
    attributes = None

    #: optional serving telemetry (``repro_torch.serve.Telemetry``): the
    #: executor feeds it every query's cost ledger and the planner consults
    #: its calibrated estimate in place of the static prior
    telemetry = None

    def query(self, q, spec: Query, *, plan: Optional[QueryPlan] = None):
        """Answer one ``Query`` over a single vector (1-D) or a block (2-D)."""
        return execute(self, q, spec, plan=plan)

    def plan(self, spec: Query) -> QueryPlan:
        """The plan ``query()`` would use (see ``explain()``)."""
        return make_plan(self, spec)

    def attach_attributes(self, store):
        """Attach an ``AttributeStore`` (enables ``Query.where`` predicates)."""
        self.attributes = store
        return self

    def _attrs_put(self, ids, attrs) -> None:
        """Record attribute rows of a mutation just accepted (so a rejected
        batch never touches the store)."""
        if attrs is None:
            return
        if self.attributes is None:
            raise ValueError(
                "attrs= given but the index carries no attribute store; build "
                "with build_index(..., attributes=AttributeStore(schema)) or "
                "attach_attributes() first"
            )
        self.attributes.put(ids, attrs)

    def _attrs_drop(self, ids) -> None:
        """Drop the attribute rows of removed logical ids (absent ids ignored)."""
        if self.attributes is not None:
            self.attributes.drop(ids)

    def _save_attributes(self, path) -> None:
        """Persist the attached store as the ``attributes/`` sidecar of an
        index directory (``load_index`` reattaches it)."""
        if self.attributes is not None:
            self.attributes.save(os.path.join(os.fspath(path), "attributes"))

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
