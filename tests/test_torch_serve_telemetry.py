"""Serving telemetry in the port (``repro_torch.serve.telemetry``) and the
planner's calibration from it.

Twins every test of the JAX package's ``tests/test_telemetry.py`` on
``device="cpu"`` (ingest through the executor's hook, the cold/warm flip of
``explain()["calibration"]``, determinism, the calibrated estimate within 2x
of the measured cost), then holds the port to the JAX package: the same
sequence of ``observe`` calls (each package's own plan and result for the
same query, the same wall times) leaves both models in the same state with
equal ``stage_costs()`` (exact), and ``explain()`` is equal between the
packages for telemetry in the same state, with source ``static_prior`` and
with ``telemetry_ewma``.
"""

import json

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro import serve as rserve
from repro.compat import enable_x64
from repro_torch.api import Query, build_index
from repro_torch.data import colors_like
from repro_torch.metrics import get_metric
from repro_torch.serve import Telemetry

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def warm_index():
    """An index with an attached telemetry model, warmed past min_samples."""
    X = colors_like(n=2100, seed=23)
    data, queries = X[:2000], X[2000:2100]
    idx = build_index(data, get_metric("euclidean"), kind="nsimplex", n_pivots=12, seed=1, device="cpu")
    idx.telemetry = Telemetry(min_samples=8)
    spec = Query.knn(5)
    for q in queries[:16]:
        idx.query(q, spec)
    return idx, queries


class TestIngest:
    def test_observe_builds_stage_ledger(self, warm_index):
        idx, _ = warm_index
        costs = idx.telemetry.stage_costs()
        key = "nsimplex/knn/exact"
        assert key in costs
        ks = costs[key]
        assert ks["n_samples"] >= 16
        assert ks["stage_pivot_distances_evals"] == 12.0     # the pivot stage
        assert ks["stage_refine_evals"] > 0.0
        assert ks["original_calls"] == pytest.approx(
            ks["stage_pivot_distances_evals"] + ks["stage_refine_evals"], rel=1e-6
        )
        assert ks["latency_ms"] > 0.0
        assert 0.0 < ks["refine_fraction"] < 1.0             # measured, not 0

    def test_batched_observation_counts_queries(self):
        X = colors_like(n=600, seed=29)
        idx = build_index(X[:500], get_metric("euclidean"), n_pivots=8, seed=1, device="cpu")
        idx.telemetry = Telemetry()
        idx.query(X[500:532], Query.knn(3))                  # one fused block
        costs = idx.telemetry.stage_costs()
        assert costs["nsimplex/knn/exact"]["n_samples"] == 32

    def test_validates(self):
        with pytest.raises(ValueError, match="alpha"):
            Telemetry(alpha=0.0)
        with pytest.raises(ValueError, match="min_samples"):
            Telemetry(min_samples=0)


class TestColdWarmFlip:
    def test_cold_model_returns_none(self):
        tm = Telemetry(min_samples=8)
        stats = {"kind": "nsimplex", "n_objects": 1000, "n_pivots": 8}
        assert tm.calibrated_exact_cost(stats, Query.knn(5)) is None
        assert tm.expected_latency_s("nsimplex", "knn", "exact") is None

    def test_planner_prior_until_warm(self):
        X = colors_like(n=1100, seed=31)
        idx = build_index(X[:1000], get_metric("euclidean"), n_pivots=8, seed=1, device="cpu")
        idx.telemetry = Telemetry(min_samples=8)
        spec = Query.knn(5, budget=10_000)
        cold = idx.plan(spec).explain()["calibration"]
        assert cold["source"] == "static_prior"
        assert cold["calibrated_evals"] is None
        assert cold["prior_evals"] == 8 + max(5, int(0.02 * 1000))
        for q in X[1000:1008]:                               # warm to min_samples
            idx.query(q, spec)
        warm = idx.plan(spec).explain()["calibration"]
        assert warm["source"] == "telemetry_ewma"
        assert warm["calibrated_evals"] is not None
        assert warm["prior_evals"] == cold["prior_evals"]    # prior still shown

    def test_calibrated_formula(self, warm_index):
        """calibrated = n_pivots + max(k, measured_fraction * n)."""
        idx, _ = warm_index
        stats = idx.stats()
        frac = idx.telemetry.stage_costs()["nsimplex/knn/exact"]["refine_fraction"]
        got = idx.telemetry.calibrated_exact_cost(stats, Query.knn(5))
        want = stats["n_pivots"] + max(5.0, frac * stats["n_objects"])
        assert got == pytest.approx(want, rel=1e-3)

    def test_calibration_can_flip_the_budget_decision(self):
        """The point of calibrating: a corpus whose measured refine fraction
        beats the 2% prior lets auto mode keep the exact path under a budget
        the prior would have rejected."""
        X = colors_like(n=2100, seed=37)
        idx = build_index(X[:2000], get_metric("euclidean"), n_pivots=12, seed=1, device="cpu")
        idx.telemetry = Telemetry(min_samples=8)
        warm_spec = Query.knn(5)
        for q in X[2000:2016]:
            idx.query(q, warm_spec)
        cal = idx.telemetry.calibrated_exact_cost(idx.stats(), warm_spec)
        prior = 12 + max(5, int(0.02 * 2000))
        budget = int((cal + prior) / 2)                      # between the two
        if cal < prior:
            plan = idx.plan(Query.knn(5, budget=budget, dims=6))
            assert plan.mode == "exact"
            assert "telemetry_ewma" in plan.reason
        else:
            plan = idx.plan(Query.knn(5, budget=budget, dims=6))
            assert plan.mode == "approx"
            assert "telemetry_ewma" in plan.reason


class TestDeterminism:
    def test_explain_deterministic_for_fixed_state(self, warm_index):
        idx, _ = warm_index
        spec = Query.knn(5, budget=10_000)
        a = idx.plan(spec).explain()
        b = idx.plan(spec).explain()
        assert a == b
        json.dumps(a)                                        # JSON-able

    def test_explain_without_telemetry_unchanged(self):
        """Indexes with no attached telemetry keep a valid (prior-only)
        calibration block — the key exists either way, deterministically."""
        X = colors_like(n=400, seed=41)
        idx = build_index(X[:300], get_metric("euclidean"), n_pivots=8, seed=1, device="cpu")
        exp = idx.plan(Query.knn(3)).explain()
        assert exp["calibration"]["source"] == "static_prior"
        assert exp["calibration"]["calibrated_evals"] is None


class TestAccuracy:
    def test_calibrated_within_2x_of_measured(self, warm_index):
        """Acceptance: after warmup the calibrated per-query eval estimate
        is within 2x of the measured cost."""
        idx, queries = warm_index
        spec = Query.knn(5)
        measured = []
        for q in queries[20:40]:
            measured.append(idx.query(q, spec).stats.original_calls)
        mean_evals = float(np.mean(measured))
        cal = idx.telemetry.calibrated_exact_cost(idx.stats(), spec)
        assert cal is not None
        assert cal <= 2.0 * mean_evals
        assert cal >= 0.5 * mean_evals

    def test_expected_latency_warm(self, warm_index):
        idx, _ = warm_index
        lat = idx.telemetry.expected_latency_s("nsimplex", "knn", "exact")
        assert lat is not None and 0.0 < lat < 10.0


# -- parity with the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    X = colors_like(n=2040, seed=23).astype(np.float64)
    data, queries = X[:2000], X[2000:]
    with enable_x64(True):
        ref = rapi.build_index(data, "euclidean", n_pivots=12, seed=1, use_kernel=True)
    port = build_index(data, "euclidean", n_pivots=12, seed=1, device="cpu")
    return port, ref, queries


TRAFFIC = [
    (dict(task="knn", k=5), 1),
    (dict(task="knn", k=5), 8),
    (dict(task="range", threshold=0.05), 4),
    (dict(task="knn", k=5, mode="approx", dims=6, refine=16), 2),
    (dict(task="knn", k=3), 1),
]


def _observe_both(port, ref, queries, ptm, rtm):
    """Each package's own plan and result for the same queries, observed
    with the same wall time."""
    row = 0
    for i, (fields, n) in enumerate(TRAFFIC * 2):
        q = queries[row:row + n] if n > 1 else queries[row]
        row += n
        with enable_x64(True):
            rspec = rapi.Query(**fields)
            rtm.observe(ref.plan(rspec), n, 1e-3 * (i + 1), ref.query(q, rspec))
        spec = Query(**fields)
        ptm.observe(port.plan(spec), n, 1e-3 * (i + 1), port.query(q, spec))


def test_stage_costs_equal_reference(pair):
    port, ref, queries = pair
    ptm, rtm = Telemetry(), rserve.Telemetry()
    _observe_both(port, ref, queries, ptm, rtm)
    assert ptm.stage_costs() == rtm.stage_costs()
    assert sorted(ptm._keys) == sorted(rtm._keys)
    for key, ks in ptm._keys.items():
        assert vars(ks) == vars(rtm._keys[key]), key


EXPLAIN = [
    dict(task="knn", k=5),
    dict(task="knn", k=5, budget=40),
    dict(task="knn", k=5, budget=10_000),
    dict(task="range", threshold=0.05, budget=30),
    dict(task="knn", k=5, budget=20, dims=6),
]


@pytest.mark.parametrize("kw", EXPLAIN)
def test_explain_equals_reference_cold_and_warm(pair, kw):
    port, ref, queries = pair
    ptm, rtm = Telemetry(min_samples=8), rserve.Telemetry(min_samples=8)
    port.telemetry, ref.telemetry = ptm, rtm
    try:
        cold = port.plan(Query(**kw)).explain()
        assert cold == ref.plan(rapi.Query(**kw)).explain()
        assert cold["calibration"]["source"] == "static_prior"
        port.telemetry = ref.telemetry = None
        _observe_both(port, ref, queries, ptm, rtm)
        port.telemetry, ref.telemetry = ptm, rtm
        warm = port.plan(Query(**kw)).explain()
        assert warm == ref.plan(rapi.Query(**kw)).explain()
        assert warm["calibration"]["source"] == "telemetry_ewma"
    finally:
        port.telemetry = ref.telemetry = None
