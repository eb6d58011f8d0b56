"""Serving telemetry: measured stage costs -> a calibrated planner cost model.

The planner's static auto-mode estimate (``n_pivots + max(k, 2% of n)``
true-metric evaluations) is a prior; real corpora land anywhere from 0.2% to
10% surviving candidates.  ``Telemetry`` closes the loop: every executed
query feeds its ``QueryStats`` ledger and wall time into per-(mechanism,
task, mode) EWMA aggregates, and ``calibrated_exact_cost`` rebuilds the
planner's estimate from the measured refine fraction.  Host code over plan
stages and cost ledgers, the JAX package's ``repro.serve.telemetry``
copied, so the same sequence of observations gives the same state and the
same ``stage_costs()`` in both packages.

Wiring (duck-typed, no import cycle into ``repro_torch.api``):

  * ``index.telemetry = Telemetry()`` — the executor
    (``repro_torch.api.execute``) calls ``telemetry.observe(plan,
    n_queries, elapsed_s, result)`` after every ``query()``.  The port's
    results are host numpy, so ``query()`` has synchronised with the card
    before it returns and the wall time includes the device work.
  * The planner consults ``telemetry.calibrated_exact_cost(stats, query)``
    in place of its static estimate once ``min_samples`` observations exist
    for the key; ``QueryPlan.explain()`` shows both numbers.

Stage accounting follows the plan's stage names: ``pivot_distances`` evals
are the plan's resolved dimension count, ``refine`` evals the remainder of
``QueryStats.original_calls``, ``filter`` rows come from ``surrogate_calls``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["DEFAULT_ALPHA", "DEFAULT_MIN_SAMPLES", "Telemetry"]

#: EWMA smoothing factor (2/(N+1) with N ~ 9 observations of history)
DEFAULT_ALPHA = 0.2

#: observations per key before the calibrated estimate replaces the prior
DEFAULT_MIN_SAMPLES = 8


def _ewma(old: float, new: float, alpha: float, n: int) -> float:
    """EWMA that seeds from the first sample instead of decaying from 0."""
    return new if n == 0 else (1.0 - alpha) * old + alpha * new


@dataclass
class _KeyStats:
    """EWMA aggregates for one (mechanism, task, mode) serving key."""

    n_samples: int = 0
    ewma_latency_s: float = 0.0        # wall time per query
    ewma_original_calls: float = 0.0   # true-metric evals per query (incl. pivots)
    ewma_pivot_evals: float = 0.0      # the plan's pivot_distances stage
    ewma_refine_evals: float = 0.0     # original_calls minus the pivot stage
    ewma_filter_rows: float = 0.0      # surrogate rows scanned per query
    ewma_candidates: float = 0.0       # rows surviving the filter per query
    ewma_n_objects: float = 0.0        # corpus size the samples were measured at

    @property
    def refine_fraction(self) -> float:
        """Measured fraction of the corpus surviving to the refine stage —
        the calibrated replacement for the planner's static 2% constant."""
        if self.ewma_n_objects <= 0:
            return 0.0
        return self.ewma_refine_evals / self.ewma_n_objects


class Telemetry:
    """Per-index serving telemetry + the EWMA-calibrated planner cost model.

    Attach with ``index.telemetry = Telemetry()``; thread-safe (the serving
    runtime observes from dispatcher threads while HTTP handlers plan).
    """

    def __init__(self, *, alpha: float = DEFAULT_ALPHA,
                 min_samples: int = DEFAULT_MIN_SAMPLES):
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1]; got {alpha}")
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1; got {min_samples}")
        self.alpha = float(alpha)
        self.min_samples = int(min_samples)
        self._lock = threading.Lock()
        self._keys: Dict[Tuple[str, str, str], _KeyStats] = {}

    # -- ingest ----------------------------------------------------------------
    def observe(self, plan, n_queries: int, elapsed_s: float, result) -> None:
        """Fold one executed query (or fused block) into the model.

        Called by the executor with the resolved ``QueryPlan``, the block
        size, the wall time (the device work included: the results are host
        arrays, copied back after the card finished), and the
        ``QueryResult`` / ``BatchQueryResult`` it produced.
        """
        results = getattr(result, "results", None)
        if results is None:
            results = [result]
        n = max(int(n_queries), 1)
        # the plan's pivot_distances stage count: dims on the approx path,
        # n_pivots (or 0 for the tree) otherwise; the filter stage carries
        # the corpus size the sample was measured at
        pivot_evals = 0
        n_objects = 0.0
        for stage in plan.stages:
            d = dict(stage.params)
            if stage.name == "pivot_distances":
                pivot_evals = int(d.get("count", 0))
            elif stage.name == "filter":
                n_objects = float(d.get("rows", 0))
        per_q = 1.0 / n
        original = sum(r.stats.original_calls for r in results) * per_q
        surrogate = sum(r.stats.surrogate_calls for r in results) * per_q
        candidates = sum(r.stats.candidates for r in results) * per_q
        refine = max(0.0, original - pivot_evals)
        key = (plan.mechanism, plan.task, plan.mode)
        a = self.alpha
        with self._lock:
            ks = self._keys.setdefault(key, _KeyStats())
            i = ks.n_samples
            ks.ewma_latency_s = _ewma(ks.ewma_latency_s, elapsed_s * per_q, a, i)
            ks.ewma_original_calls = _ewma(ks.ewma_original_calls, original, a, i)
            ks.ewma_pivot_evals = _ewma(ks.ewma_pivot_evals, float(pivot_evals), a, i)
            ks.ewma_refine_evals = _ewma(ks.ewma_refine_evals, refine, a, i)
            ks.ewma_filter_rows = _ewma(ks.ewma_filter_rows, surrogate, a, i)
            ks.ewma_candidates = _ewma(ks.ewma_candidates, candidates, a, i)
            if n_objects > 0:
                ks.ewma_n_objects = _ewma(ks.ewma_n_objects, n_objects, a, i)
            # one fused block = n_queries samples of the per-query cost
            ks.n_samples += n

    # -- the calibrated cost model ---------------------------------------------
    def calibrated_exact_cost(self, stats: dict, query) -> Optional[float]:
        """The planner's exact-path estimate, rebuilt from measured costs:
        ``n_pivots + max(k, measured_refine_fraction * n)``.  None until
        ``min_samples`` exact-path observations exist for this mechanism and
        task (the planner then keeps its static prior)."""
        mech = stats.get("base_kind") or stats.get("inner_kind") or stats.get("kind")
        with self._lock:
            ks = self._keys.get((mech, query.task, "exact"))
            if ks is None or ks.n_samples < self.min_samples:
                return None
            frac = ks.refine_fraction
        n = int(stats.get("n_objects", 0))
        n_pivots = int(stats.get("n_pivots", 0))
        want = query.k if query.task == "knn" and query.k else 0
        return float(n_pivots + max(float(want), frac * n))

    def expected_latency_s(self, mechanism: str, task: str, mode: str) -> Optional[float]:
        """Measured per-query wall time for a serving key, or None if the
        key is cold (admission control uses this for wait estimates)."""
        with self._lock:
            ks = self._keys.get((mechanism, task, mode))
            if ks is None or ks.n_samples < self.min_samples:
                return None
            return ks.ewma_latency_s

    # -- observability ---------------------------------------------------------
    def stage_costs(self) -> dict:
        """Deterministic JSON snapshot: per (mechanism, task, mode) key, the
        EWMA per-query stage ledger (keys sorted, floats rounded)."""
        with self._lock:
            items = sorted(self._keys.items())
            return {
                "/".join(key): {
                    "n_samples": ks.n_samples,
                    "latency_ms": round(ks.ewma_latency_s * 1e3, 4),
                    "original_calls": round(ks.ewma_original_calls, 3),
                    "stage_pivot_distances_evals": round(ks.ewma_pivot_evals, 3),
                    "stage_refine_evals": round(ks.ewma_refine_evals, 3),
                    "stage_filter_rows": round(ks.ewma_filter_rows, 3),
                    "candidates": round(ks.ewma_candidates, 3),
                    "refine_fraction": round(ks.refine_fraction, 6),
                }
                for key, ks in items
            }
