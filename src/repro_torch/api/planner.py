"""Query planner: (index stats, Query) -> QueryPlan.

A plan is the resolved mode (``"auto"`` collapsed to exact/approx), the
truncation config, the id-filter strategy and the ordered pipeline stages.
It is computed from ``index.stats()`` and the query alone — deterministic
for a fixed index — and ``explain()`` returns it as a plain dict, equal
field for field to the JAX package's plan for the same index and query.

Mode resolution:

  * ``mode="exact"``  — the exact path.
  * ``mode="approx"`` — the truncated-surrogate path; needs a truncation
    dimension from the query, the index's ``QueryOptions`` or the build.
  * ``mode="auto"``   — with a budget: exact when the static estimate
    (``n_pivots`` pivot distances + ``max(k, 2% of n)`` rechecks) fits it,
    where an index carrying a warm ``repro_torch.serve.Telemetry`` puts its
    measured refine fraction in place of the 2% (``explain()["calibration"]``
    shows both numbers), else the truncated path (dims defaulting to ``n_pivots // 2``) with the
    refine budget capped to fit; without a budget: approx iff the index was
    built with ``apex_dims``.

The ``tree`` kind has no truncatable surrogate: it is always exact, and
``mode="approx"`` on it raises.  An ``allow`` list overrides all of this:
the executor scans the listed rows directly, and the plan says so.  A
``where`` predicate is planned from the attribute store's column
statistics: a direct scan of the matching rows (``prefilter``), a row mask
handed to the bound-scan kernels (``pushdown``) or an over-fetch filtered on
the way out (``postfilter``).  The strategy thresholds and the cost model
are the JAX package's constants, unchanged, so both packages pick the same
strategy for the same stats.  This package plans the three single-structure
kinds (``nsimplex``, ``laesa``, ``tree``) and the ``mutable`` and ``sharded``
composites over them; a sharded plan carries the ``shard_fanout`` stage
(shards, whether the device filter runs, the fan-out workers and layout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.api.query import DEFAULT_REFINE, Query, QueryOptions

__all__ = ["MIN_DEVICE_THRESHOLD", "PlanStage", "QueryPlan", "plan"]

#: expected fraction of the table surviving the exact filter (auto-mode
#: cost estimate only; ~2x the measured N_seq fraction for margin)
_EXACT_CANDIDATE_FRACTION = 0.02

#: below this threshold the sharded device filter flips to the host fan-out
#: (the fp32 relative guard band around a near-zero threshold would swallow
#: the decision); shared with ShardedIndex._use_device_filter so the plan's
#: shard_fanout stage reports the gate the executor applies
MIN_DEVICE_THRESHOLD = 1e-6

#: predicate-strategy thresholds (estimated matching rows / selectivity):
#: few enough matches -> a direct exact scan of them beats any index work
_PREFILTER_ROWS_FLOOR = 1024
_PREFILTER_SELECTIVITY = 0.05
#: matches this common -> an overfetch + postfilter costs ~one unfiltered query
_POSTFILTER_SELECTIVITY = 0.5
#: masked-table-scan cost model: per-element overhead of the bounds and
#: the masked selection relative to one fused direct-scan multiply, and the
#: relative cost of a true-metric evaluation for the non-vector metrics
_MASKED_SCAN_OVERHEAD = 3.0
_CHEAP_METRICS = ("euclidean", "cosine")
_EXPENSIVE_METRIC_FACTOR = 4.0


@dataclass(frozen=True)
class PlanStage:
    """One pipeline stage: a name plus its sorted, JSON-able parameters."""

    name: str
    params: Tuple[Tuple[str, object], ...] = ()

    def to_dict(self) -> dict:
        return {"stage": self.name, **dict(self.params)}


def _stage(name: str, **params) -> PlanStage:
    return PlanStage(name=name, params=tuple(sorted(params.items())))


@dataclass(frozen=True)
class QueryPlan:
    """The executor's contract for one (index, Query) pair."""

    index_kind: str
    mechanism: str
    task: str
    mode: str                          # "exact" | "approx" (auto resolved)
    k: Optional[int]
    threshold: Optional[object]
    dims: Optional[int]
    refine: Optional[int]
    filter_strategy: str               # "none"|"allow_direct"|"deny_overfetch"|"postfilter"
    stages: Tuple[PlanStage, ...]
    reason: str
    budget: Optional[int] = None
    #: exact-path cost-estimate provenance as sorted (key, value) pairs
    calibration: Optional[Tuple[Tuple[str, object], ...]] = None

    @property
    def approx_cfg(self) -> Optional[dict]:
        """``{"dims", "refine"}`` for the approximate path, None when exact."""
        if self.mode != "approx":
            return None
        return {"dims": int(self.dims), "refine": int(self.refine)}

    def explain(self) -> dict:
        """The plan as a deterministic, JSON-able dict."""
        return {
            "index_kind": self.index_kind,
            "mechanism": self.mechanism,
            "task": self.task,
            "mode": self.mode,
            "k": self.k,
            "threshold": list(self.threshold) if isinstance(self.threshold, tuple) else self.threshold,
            "dims": self.dims,
            "refine": self.refine,
            "budget": self.budget,
            "filter": self.filter_strategy,
            "reason": self.reason,
            "calibration": dict(self.calibration) if self.calibration else None,
            "stages": [s.to_dict() for s in self.stages],
        }


def _resolve_approx_fields(query: Query, options: Optional[QueryOptions], stats: dict):
    """(dims, refine) after the Query > QueryOptions > build-config cascade."""
    opt = options or QueryOptions()
    dims = query.dims if query.dims is not None else opt.dims
    if dims is None:
        dims = stats.get("apex_dims")
    refine = query.refine if query.refine is not None else opt.refine
    if refine is None:
        refine = stats.get("refine", None)
    return (int(dims) if dims is not None else None,
            int(refine) if refine is not None else None)


def _exact_cost_estimate(stats: dict, query: Query) -> int:
    """The static prior: true-metric evaluations of the exact path."""
    n = int(stats.get("n_objects", 0))
    n_pivots = int(stats.get("n_pivots", 0))
    want = query.k if query.task == "knn" and query.k else 0
    return n_pivots + max(int(want), int(_EXACT_CANDIDATE_FRACTION * n))


def _cost_calibration(stats: dict, query: Query, telemetry):
    """(estimate to use, calibration provenance pairs) for the table kinds:
    the static prior, replaced by the measured-refine-fraction estimate of
    a warm ``Telemetry`` model when the index carries one.  The pairs record
    both numbers and which one was used, so ``explain()`` shows the flip."""
    prior = _exact_cost_estimate(stats, query)
    calibrated = telemetry.calibrated_exact_cost(stats, query) if telemetry is not None else None
    used = float(prior) if calibrated is None else float(calibrated)
    pairs = tuple(
        sorted(
            {
                "prior_evals": int(prior),
                "calibrated_evals": round(float(calibrated), 3) if calibrated is not None else None,
                "source": "telemetry_ewma" if calibrated is not None else "static_prior",
            }.items()
        )
    )
    return used, pairs


def _resolve_mode(query: Query, options: Optional[QueryOptions], stats: dict, telemetry=None):
    """(mode, dims, refine, reason, budget, calibration) with "auto" collapsed."""
    table_kind = "n_pivots" in stats  # the truncatable (table) mechanisms
    dims, refine = _resolve_approx_fields(query, options, stats)
    calibration = _cost_calibration(stats, query, telemetry)[1] if table_kind else None
    mode = query.mode
    if mode == "auto" and options and options.mode:
        mode = options.mode
    budget = query.budget if query.budget is not None else (options.budget if options else None)

    if mode == "exact":
        return "exact", None, None, "requested exact", budget, calibration
    if mode == "approx":
        if not table_kind:
            raise ValueError(
                f"mode='approx' needs a truncatable surrogate table; "
                f"kind {stats.get('kind')!r} (mechanism "
                f"{stats.get('base_kind') or stats.get('inner_kind') or stats.get('kind')!r}) has none"
            )
        if dims is None:
            raise ValueError(
                "approx mode needs a truncation dimension: build with "
                "apex_dims=... or pass dims=... (Query/QueryOptions)"
            )
        return (
            "approx", dims, refine if refine is not None else DEFAULT_REFINE,
            "requested approx", budget, calibration,
        )

    if budget is not None and table_kind:
        if dims is None:
            dims = max(2, int(stats["n_pivots"]) // 2)
        est, calibration = _cost_calibration(stats, query, telemetry)
        source = dict(calibration)["source"]
        if est > budget:
            r = refine if refine is not None else DEFAULT_REFINE
            r = max(0, min(r, budget - dims))
            return (
                "approx", dims, r,
                f"auto: exact estimate {est:g} evals ({source}) exceeds budget {budget}",
                budget, calibration,
            )
        return (
            "exact", None, None,
            f"auto: exact estimate {est:g} evals ({source}) fits budget {budget}",
            budget, calibration,
        )
    if stats.get("apex_dims") is not None and dims is not None:
        return (
            "approx", dims, refine if refine is not None else DEFAULT_REFINE,
            "auto: index built with apex_dims defaults to the truncated path",
            budget, calibration,
        )
    return "exact", None, None, "auto: no truncation configured", budget, calibration


def _filter_strategy(query: Query) -> str:
    if query.deny:
        return "deny_overfetch" if query.task == "knn" else "postfilter"
    return "none"


def _predicate_strategy(query: Query, selectivity: float, est_rows: int, stats: dict) -> str:
    """Pick a predicate strategy from the stats-only estimate.

    * ``prefilter``  — a direct exact scan of the matching rows beats the
      index traversal: always for small match sets and, on the table kinds,
      whenever the modelled direct cost ``est_rows * dim`` undercuts the
      masked surrogate scan (``n * n_pivots`` plus bookkeeping).
    * ``postfilter`` — matches are common: an overfetch of ``~k/selectivity``
      costs about one unfiltered query, so filter on the way out.
    * ``pushdown``   — the middle: the row mask rides into the fused scan,
      so pruning still works but only matching rows can surface.
    """
    if query.filter_mode is not None:
        return query.filter_mode
    want = int(query.k or 0)
    if est_rows <= max(_PREFILTER_ROWS_FLOOR, 4 * want) or selectivity <= _PREFILTER_SELECTIVITY:
        return "prefilter"
    n = int(stats.get("n_objects", 0))
    dim = int(stats.get("dim") or 0)
    n_pivots = int(stats.get("n_pivots") or 0)
    if n and dim and n_pivots:
        unit = 1.0 if stats.get("metric") in _CHEAP_METRICS else _EXPENSIVE_METRIC_FACTOR
        direct = est_rows * dim * unit
        masked = (
            _MASKED_SCAN_OVERHEAD * n * n_pivots
            + n_pivots * dim * unit
            + _EXACT_CANDIDATE_FRACTION * est_rows * dim * unit
        )
        if direct <= masked:
            return "prefilter"
    if selectivity >= _POSTFILTER_SELECTIVITY:
        return "postfilter"
    return "pushdown"


def _fanout_stage(kind: str, stats: dict, device_filter: bool):
    """The sharded composite's fan-out stage, or None for another kind."""
    if kind != "sharded":
        return None
    return _stage(
        "shard_fanout",
        shards=int(stats.get("n_shards", 1)),
        device_filter=bool(device_filter),
        workers=int(stats.get("fanout_workers", 0)),
        overlap=bool(stats.get("fanout_overlap", False)),
        layout=stats.get("layout"),
    )


def _merge_stage(kind: str, stats: dict):
    """The composite's segment-merge stage, or None for a plain index or
    an immutable sharded one."""
    if kind not in ("mutable", "durable") and not (kind == "sharded" and stats.get("mutable")):
        return None
    return _stage(
        "merge_segments",
        delta_rows=int(stats.get("delta_rows", 0)),
        tombstones=int(stats.get("tombstones", 0)),
    )


def _plan_predicate(index, query: Query, stats: dict, kind: str) -> QueryPlan:
    """Plan a query carrying an attribute predicate (``Query.where``)."""
    store = getattr(index, "attributes", None)
    if store is None:
        raise ValueError(
            "query has a 'where' predicate but the index carries no attribute "
            "store; build with build_index(..., attributes=AttributeStore(schema))"
        )
    for name in query.where.attrs:
        if name not in store.schema:
            raise ValueError(
                f"predicate references unknown attribute {name!r}; "
                f"the store has columns {sorted(store.schema)}"
            )
    n = int(stats.get("n_objects", 0))
    selectivity = store.selectivity(query.where)
    est_rows = int(round(selectivity * n))
    choice = _predicate_strategy(query, selectivity, est_rows, stats)
    strategy = f"predicate_{choice}"
    filter_stage = _stage(
        "predicate_filter",
        strategy=choice,
        forced=query.filter_mode is not None,
        clauses=len(query.where.clauses),
        columns=list(query.where.attrs),
        selectivity=round(float(selectivity), 6),
        est_rows=est_rows,
        allow=len(query.allow) if query.allow is not None else None,
        deny=len(query.deny) if query.deny else None,
    )
    if choice == "prefilter":
        # like the allowlist: a direct exact scan of the matching rows; no
        # index pipeline runs, whatever mode the query asked for
        return QueryPlan(
            index_kind=kind,
            mechanism=stats.get("base_kind") or stats.get("inner_kind") or kind,
            task=query.task,
            mode="exact",
            k=query.k,
            threshold=query.threshold,
            dims=None,
            refine=None,
            filter_strategy=strategy,
            stages=(filter_stage, _stage("prefilter_scan", est_rows=est_rows)),
            reason=(
                f"predicate prefilter: ~{est_rows} matching rows "
                f"(selectivity {selectivity:.4g}) — direct exact scan"
            ),
            budget=query.budget,
        )
    options = getattr(index, "query_options", None)
    telemetry = getattr(index, "telemetry", None)
    mode, dims, refine, reason, budget, calibration = _resolve_mode(query, options, stats, telemetry)
    mech, inner_stages = _mechanism_stages(stats, query, mode, dims, refine)
    # the row mask routes through the host fan-out: the device filter has
    # no mask operand on the sharded flat state
    composite = [st for st in (_fanout_stage(kind, stats, False), _merge_stage(kind, stats)) if st]
    stages = [filter_stage] + composite + inner_stages
    return QueryPlan(
        index_kind=kind,
        mechanism=mech,
        task=query.task,
        mode=mode,
        k=query.k,
        threshold=query.threshold,
        dims=dims,
        refine=refine,
        filter_strategy=strategy,
        stages=tuple(stages),
        reason=f"predicate {choice}: selectivity {selectivity:.4g} (~{est_rows} rows); {reason}",
        budget=budget,
        calibration=calibration,
    )


def _mechanism_stages(stats: dict, query: Query, mode: str, dims, refine):
    """(mechanism, stages) of the innermost segment's pipeline."""
    mech = stats.get("base_kind") or stats.get("inner_kind") or stats["kind"]
    n = int(stats.get("n_objects", 0))
    if mech == "tree":
        algo = "best_first_branch_and_bound" if query.task == "knn" else "hyperplane_exclusion"
        return mech, [_stage("tree_traverse", algorithm=algo, n=n)]
    eff = dims if mode == "approx" else int(stats.get("n_pivots", 0))
    stages = [_stage("pivot_distances", count=eff)]
    if mech == "nsimplex":
        stages.append(_stage("project", dims=eff, space="apex"))
    # how the bound scan's output reaches the refine stage, in the JAX
    # package's words: the n-simplex paths and LAESA exact k-NN select
    # inside the scan; LAESA exact range keeps a boolean mask and its
    # approximate paths dense bounds
    if mech == "nsimplex" or (mode == "exact" and query.task == "knn"):
        selection = "fused_epilogue"
    elif mode == "exact":
        selection = "masked_scan"
    else:
        selection = "dense_bounds"
    if mode == "approx":
        stages.append(
            _stage("filter", algorithm="truncated_surrogate_scan", rows=n, dims=eff, selection=selection)
        )
        stages.append(
            _stage(
                "refine",
                strategy="true_metric_rerank" if query.task == "knn" else "straddler_recheck",
                budget=refine,
            )
        )
        return mech, stages
    algo = "two_sided_simplex" if mech == "nsimplex" else "chebyshev_triangle"
    stages.append(_stage("filter", algorithm=algo, rows=n, selection=selection))
    stages.append(
        _stage("refine", strategy="shrinking_radius" if query.task == "knn" else "straddler_recheck")
    )
    return mech, stages


def plan(index, query: Query) -> QueryPlan:
    """Plan one query against one index, from its ``stats()`` facts."""
    if not isinstance(query, Query):
        raise TypeError(f"expected a Query; got {type(query).__name__}")
    stats = index.stats()
    kind = stats["kind"]
    if query.where is not None:
        # attribute predicates subsume allow/deny: the executor composes the
        # match set with both before running the chosen strategy
        return _plan_predicate(index, query, stats, kind)
    if query.allow is not None:
        return QueryPlan(
            index_kind=kind,
            mechanism=stats.get("base_kind") or stats.get("inner_kind") or kind,
            task=query.task,
            mode="exact",
            k=query.k,
            threshold=query.threshold,
            dims=None,
            refine=None,
            filter_strategy="allow_direct",
            stages=(
                _stage("allow_direct_scan", rows=len(query.allow)),
                _stage(
                    "id_filter",
                    strategy="allow_direct",
                    allow=len(query.allow),
                    deny=len(query.deny) if query.deny else None,
                ),
            ),
            reason="allowlist: direct exact scan of the listed rows",
            budget=query.budget,
        )

    options = getattr(index, "query_options", None)
    telemetry = getattr(index, "telemetry", None)
    mode, dims, refine, reason, budget, calibration = _resolve_mode(query, options, stats, telemetry)
    mech, inner_stages = _mechanism_stages(stats, query, mode, dims, refine)
    t = query.threshold
    t_min = min(t) if isinstance(t, tuple) else t
    device = (
        mech == "nsimplex"
        and mode == "exact"
        and query.task == "range"
        and stats.get("device_filter") is not False
        and stats.get("shared_projector", False)
        and t_min is not None
        and t_min > MIN_DEVICE_THRESHOLD
    )
    composite = [st for st in (_fanout_stage(kind, stats, device), _merge_stage(kind, stats)) if st]
    stages = composite + inner_stages
    strategy = _filter_strategy(query)
    if strategy != "none":
        stages.append(
            _stage(
                "id_filter",
                strategy=strategy,
                allow=None,
                deny=len(query.deny) if query.deny else None,
            )
        )
    return QueryPlan(
        index_kind=kind,
        mechanism=mech,
        task=query.task,
        mode=mode,
        k=query.k,
        threshold=query.threshold,
        dims=dims,
        refine=refine,
        filter_strategy=strategy,
        stages=tuple(stages),
        reason=reason,
        budget=budget,
        calibration=calibration,
    )
