"""The port's launch-plan tuner (``repro_torch.kernels.tuning``) and its
cache on the CPU: the twin of every class of ``tests/test_kernel_tuning.py``.

* the cache round-trips winners through a versioned JSON file and falls
  back to ``DEFAULT_CONFIG`` — never an exception — on unknown keys,
  corrupt files, old schema versions and malformed entries;
* ``autotune`` is deterministic for a fixed timer: the winner is the min
  over VALIDATED candidates by ``(time, config)``; an invalid candidate is
  never timed;
* the CPU path (the plain versions) never consults the tuner: the
  wrappers answer with ``lookup`` patched to raise;
* with ``DEFAULT_CONFIG`` (no cache file), ``topk_plan`` and
  ``threshold_plan`` give exactly the plans the wrappers launched before
  the tuner existed: the literals below were computed by the earlier
  ``ops.py`` over (width, Q, N, SM count).

Autotune runs here on CPU tensors, where the wrappers run their plain
versions whatever the plan: that exercises the sweep's logic
(validation, deduplication, the winner rule, the cache), not its times.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, tuning
from repro_torch.kernels.tuning import DEFAULT_CONFIG, KernelConfig, TuningCache, candidate_space, make_key

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_memo(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.CACHE_ENV_VAR, str(tmp_path / "env_cache.json"))
    tuning.reset_lookup_memo()
    yield
    tuning.reset_lookup_memo()


def _problem(N=300, Q=5, n=12, seed=0):
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(N, n)) * 0.3).astype(np.float32)
    table[:, -1] = np.abs(table[:, -1])
    queries = (rng.normal(size=(Q, n)) * 0.3).astype(np.float32)
    queries[:, -1] = np.abs(queries[:, -1])
    return torch.as_tensor(table), torch.as_tensor(queries)


class TestCacheRoundTrip:
    def test_put_save_load_get(self, tmp_path):
        path = str(tmp_path / "tune.json")
        cache = TuningCache(path)
        cfg = KernelConfig(max_group=8, waves=4, slice_rows=2048)
        cache.put("k1", cfg, 123.4)
        cache.save()
        again = TuningCache(path).load()
        assert again.get("k1") == cfg
        payload = json.loads(open(path).read())
        assert payload["schema_version"] == tuning.TUNE_SCHEMA_VERSION
        assert payload["entries"]["k1"]["us_per_call"] == 123.4

    def test_lookup_roundtrip_and_memo_reset(self, tmp_path):
        path = str(tmp_path / "tune.json")
        key = make_key("apex_topk", 12, None, np.float32)
        assert tuning.lookup("apex_topk", 12, None, np.float32, path=path) == DEFAULT_CONFIG
        cache = TuningCache(path)
        won = KernelConfig(max_group=4, waves=1, slice_rows=32768)
        cache.put(key, won, 1.0)
        cache.save()
        # memoised miss persists until reset
        assert tuning.lookup("apex_topk", 12, None, np.float32, path=path) == DEFAULT_CONFIG
        tuning.reset_lookup_memo()
        assert tuning.lookup("apex_topk", 12, None, np.float32, path=path) == won
        # the key names the kernel: another kernel's lookup is a miss
        assert tuning.lookup("apex_threshold", 12, None, np.float32, path=path) == DEFAULT_CONFIG

    def test_make_key_distinguishes(self):
        keys = {
            make_key("apex_bounds_batch", 16, None, np.float32),
            make_key("apex_bounds_batch", 16, 8, np.float32),
            make_key("apex_bounds_batch", 16, None, np.float64),
            make_key("apex_bounds_batch", 32, None, np.float32),
            make_key("apex_topk", 16, None, np.float32),
            make_key("apex_threshold", 16, None, np.float32),
        }
        assert len(keys) == 6
        # numpy and torch dtypes name the same key
        assert make_key("apex_topk", 20, 10, torch.float32) == make_key("apex_topk", 20, 10, np.float32)
        with pytest.raises(ValueError):
            make_key("apex_project", 20, None, np.float32)

    def test_env_var_names_the_default_path(self, tmp_path, monkeypatch):
        path = str(tmp_path / "elsewhere.json")
        monkeypatch.setenv(tuning.CACHE_ENV_VAR, path)
        assert tuning.default_cache_path() == path
        monkeypatch.delenv(tuning.CACHE_ENV_VAR)
        assert tuning.default_cache_path().endswith("/.cache/repro_torch/kernel_tuning.json")


class TestCacheFallback:
    def test_unknown_key_is_none_and_lookup_defaults(self, tmp_path):
        path = str(tmp_path / "tune.json")
        TuningCache(path).save()
        assert TuningCache(path).get("nope") is None
        assert tuning.lookup("apex_bounds_batch", 99, None, np.float32, path=path) == DEFAULT_CONFIG

    def test_corrupt_file(self, tmp_path):
        path = tmp_path / "tune.json"
        path.write_text("{not json")
        assert TuningCache(str(path)).load().keys() == ()
        assert tuning.lookup("apex_topk", 12, None, np.float32, path=str(path)) == DEFAULT_CONFIG

    def test_old_schema_version(self, tmp_path):
        path = tmp_path / "tune.json"
        path.write_text(json.dumps({"schema_version": 0, "entries": {
            "k": {"plan": "tile", "max_group": 8, "waves": 2, "slice_rows": 8192}}}))
        assert TuningCache(str(path)).load().keys() == ()

    def test_malformed_entry(self, tmp_path):
        path = tmp_path / "tune.json"
        path.write_text(json.dumps({"schema_version": tuning.TUNE_SCHEMA_VERSION, "entries": {
            "k": {"plan": "wat"}, "j": {"plan": "stream", "max_group": 99, "waves": 2, "slice_rows": 8192}}}))
        assert TuningCache(str(path)).get("k") is None
        assert TuningCache(str(path)).get("j") is None      # G beyond the kernels' 32

    def test_missing_file(self, tmp_path):
        path = str(tmp_path / "absent" / "tune.json")
        assert TuningCache(path).load().keys() == ()
        assert tuning.lookup("apex_threshold", 4, None, np.float32, path=path) == DEFAULT_CONFIG


class TestCandidateSpace:
    @pytest.mark.parametrize("kernel", tuning.KERNELS)
    def test_default_always_included_and_clamped(self, kernel):
        space = candidate_space(400, 4, kernel=kernel, quick=True)
        assert DEFAULT_CONFIG in space
        # every swept candidate respects the problem-size clamp; only the
        # always-present default may exceed it
        if kernel != "apex_bounds_batch":       # K1's knob is its plan alone
            assert all(c.max_group <= 4 and c.slice_rows <= max(2048, 400) for c in space if c != DEFAULT_CONFIG)
        assert space == tuple(sorted(space))

    def test_kernel_knobs(self):
        assert {c.plan for c in candidate_space(10_000, 64)} == {"stream", "tile"}
        assert {c.max_group for c in candidate_space(10_000, 64, kernel="apex_topk")} == {1, 2, 4, 8, 16, 32}
        assert 0 in {c.max_group for c in candidate_space(10_000, 64, kernel="apex_threshold")}
        assert {c.max_group for c in candidate_space(10_000, 1, kernel="apex_threshold")} == {0, 1, 32}

    def test_quick_is_smaller(self):
        for kernel in ("apex_topk", "apex_threshold"):
            assert len(candidate_space(50_000, 64, kernel=kernel, quick=True)) < len(
                candidate_space(50_000, 64, kernel=kernel, quick=False))


class TestAutotuneDeterminism:
    def test_fixed_timer_yields_deterministic_winner(self, tmp_path):
        table, queries = _problem(N=600, Q=32)

        # a timing stub that prefers small groups (at N = 600 every slice
        # rule gives one slice, so configs differing only there share a
        # launch plan and its one timing)
        def timer(thunk, config):
            thunk()
            return 1000.0 + config.max_group

        cache = TuningCache(str(tmp_path / "tune.json"))
        cands = candidate_space(600, 32, kernel="apex_topk", quick=True)
        assert len(cands) > 1
        winner1, rows1 = tuning.autotune(table, queries, kernel="apex_topk", k=10, candidates=cands,
                                         timer=timer, cache=cache)
        winner2, _ = tuning.autotune(table, queries, kernel="apex_topk", k=10, candidates=cands, timer=timer,
                                     cache=None)
        assert winner1 == winner2
        assert winner1 == min(c for c in cands if c.max_group == 1)
        assert all(r["valid"] for r in rows1)
        tuning.reset_lookup_memo()
        assert tuning.lookup("apex_topk", table.shape[1], None, np.float32, path=cache.path) == winner1

    def test_tie_breaks_by_smallest_config(self):
        table, queries = _problem(N=600, Q=32)

        def timer(thunk, config):
            thunk()
            return 42.0

        cands = candidate_space(600, 32, kernel="apex_threshold", quick=True)
        assert len(cands) > 1
        winner, _ = tuning.autotune(table, queries, kernel="apex_threshold", cap=64,
                                    thresholds=torch.full((32,), 0.5), candidates=cands, timer=timer, cache=None)
        assert winner == min(cands)

    def test_same_launch_plan_timed_once(self):
        """At Q = 1 every group size launches G = 1: one timing serves all."""
        table, queries = _problem(N=600, Q=1)
        timed = []

        def timer(thunk, config):
            thunk()
            timed.append(config)
            return 1.0

        cands = (KernelConfig(max_group=1), KernelConfig(max_group=8), DEFAULT_CONFIG)
        winner, rows = tuning.autotune(table, queries, kernel="apex_topk", k=5, candidates=cands, timer=timer,
                                       cache=None)
        assert len(timed) == 1 and winner == min(cands)
        assert {tuple(r["launch"]) for r in rows} == {(1, 1)}

    def test_k1_plans_validate(self):
        table, queries = _problem(N=300, Q=7)
        winner, rows = tuning.autotune(table, queries, dims=6, timer=lambda thunk, c: 1.0 if c.plan == "tile"
                                       else 2.0, cache=None)
        assert winner.plan == "tile" and all(r["valid"] for r in rows)

    def test_invalid_candidates_cannot_win(self, monkeypatch):
        table, queries = _problem(N=150, Q=3)
        calls = []

        def timer(thunk, config):
            thunk()
            calls.append(config)
            return 1.0

        monkeypatch.setattr(tuning, "_validate_against_ref", lambda kernel, got, want: False)
        with pytest.raises(RuntimeError):
            tuning.autotune(table, queries, kernel="apex_topk", candidates=(DEFAULT_CONFIG,), timer=timer,
                            cache=None)
        assert calls == []  # nothing invalid is ever timed

    def test_wrong_selection_is_invalid(self):
        table, queries = _problem(N=150, Q=3)
        got = ops.apex_bounds_topk(table, queries, 5, key="upb")
        bad = (got[0].flip(1), got[1], got[2])
        assert tuning._validate_against_ref("apex_topk", got, got)
        assert not tuning._validate_against_ref("apex_topk", bad, got)


class TestCpuNeverConsultsTuner:
    @pytest.fixture
    def boom(self, monkeypatch):
        def raise_(*a, **k):
            raise AssertionError("the CPU path consulted the tuner")

        monkeypatch.setattr(tuning, "lookup", raise_)

    def test_cpu_wrappers_answer_with_lookup_raising(self, boom):
        table, queries = _problem(N=130, Q=3)
        lwb, upb = ops.apex_bounds_batch(table, queries)
        assert lwb.shape == (3, 130) and bool(torch.all(lwb <= upb + 1e-6))
        ids, _, _ = ops.apex_bounds_topk(table, queries, 7, key="upb")
        assert ids.shape == (3, 7)
        ids, _, _, counts = ops.apex_bounds_threshold(table, queries, torch.full((3,), 0.4), 16)
        assert ids.shape == (3, 16) and counts.shape == (3,)

    def test_explicit_plans_skip_lookup(self, boom):
        table, queries = _problem(N=130, Q=3)
        assert ops.apex_bounds_batch(table, queries, _plan="tile")[0].shape == (3, 130)
        assert ops.apex_bounds_topk(table, queries, 7, _plan=(3, 2))[0].shape == (3, 7)
        assert ops.apex_bounds_threshold(table, queries, torch.full((3,), 0.4), 16, _plan=(0, 2))[0].shape == (3, 16)

    def test_invalid_forced_plans_refused(self):
        table, queries = _problem(N=130, Q=3)
        with pytest.raises(ValueError):
            ops.apex_bounds_topk(table, queries, 7, _plan=(0, 2))       # K2 has no G = 0
        with pytest.raises(ValueError):
            ops.apex_bounds_topk(table, queries, 100, _plan=(32, 2))    # beyond the 64 KiB budget
        with pytest.raises(ValueError):
            ops.apex_bounds_batch(table, queries, _plan="warp")


#: the plans of the wrappers before the tuner, per width, over
#: (Q, N, SM count) in the order of ``itertools.product(QS, NS, SMS)``
QS, NS, SMS = (1, 7, 16, 64), (1000, 250_000, 1_000_000), (78, 132)
TOPK_PLANS = {
    1: [(1, 1), (1, 1), (1, 31), (1, 31), (1, 64), (1, 64), (7, 1), (7, 1), (7, 31), (7, 31), (7, 64), (7, 64), (8, 1), (8, 1), (8, 31), (8, 31), (8, 64), (8, 64), (13, 1), (13, 1), (13, 31), (13, 31), (13, 32), (13, 53)],
    10: [(1, 1), (1, 1), (1, 31), (1, 31), (1, 64), (1, 64), (7, 1), (7, 1), (7, 31), (7, 31), (7, 64), (7, 64), (8, 1), (8, 1), (8, 31), (8, 31), (8, 64), (8, 64), (13, 1), (13, 1), (13, 31), (13, 31), (13, 32), (13, 53)],
    64: [(1, 1), (1, 1), (1, 31), (1, 31), (1, 64), (1, 64), (7, 1), (7, 1), (7, 31), (7, 31), (7, 64), (7, 64), (8, 1), (8, 1), (8, 31), (8, 31), (8, 64), (8, 64), (13, 1), (13, 1), (13, 31), (13, 31), (13, 32), (13, 53)],
    300: [(1, 1), (1, 1), (1, 31), (1, 31), (1, 64), (1, 64), (7, 1), (7, 1), (7, 31), (7, 31), (7, 64), (7, 64), (8, 1), (8, 1), (8, 31), (8, 31), (8, 64), (8, 64), (8, 1), (8, 1), (8, 20), (8, 31), (8, 20), (8, 33)],
    4096: [(1, 1), (1, 1), (1, 31), (1, 31), (1, 64), (1, 64), (1, 1), (1, 1), (1, 23), (1, 31), (1, 23), (1, 38), (1, 1), (1, 1), (1, 10), (1, 17), (1, 10), (1, 17), (1, 1), (1, 1), (1, 3), (1, 5), (1, 3), (1, 5)],
}
THRESHOLD_PLANS = {
    1: [(1, 1), (1, 1), (1, 31), (1, 31), (1, 64), (1, 64), (7, 1), (7, 1), (7, 31), (7, 31), (7, 64), (7, 64), (16, 1), (16, 1), (16, 31), (16, 31), (16, 64), (16, 64), (16, 1), (16, 1), (16, 31), (16, 31), (16, 39), (16, 64)],
    512: [(1, 1), (1, 1), (1, 31), (1, 31), (1, 64), (1, 64), (7, 1), (7, 1), (7, 31), (7, 31), (7, 64), (7, 64), (16, 1), (16, 1), (16, 31), (16, 31), (16, 64), (16, 64), (16, 1), (16, 1), (16, 31), (16, 31), (16, 39), (16, 64)],
    4096: [(1, 1), (1, 1), (1, 31), (1, 31), (1, 64), (1, 64), (7, 1), (7, 1), (7, 31), (7, 31), (7, 64), (7, 64), (16, 1), (16, 1), (16, 31), (16, 31), (16, 64), (16, 64), (16, 1), (16, 1), (16, 31), (16, 31), (16, 39), (16, 64)],
}


@pytest.mark.parametrize("k", sorted(TOPK_PLANS))
def test_default_topk_plans_are_the_earlier_plans(k):
    got = [ops.topk_plan(k, Q, N, s) for Q, N, s in itertools.product(QS, NS, SMS)]
    assert got == TOPK_PLANS[k]
    assert got == [ops.topk_plan(k, Q, N, s, DEFAULT_CONFIG) for Q, N, s in itertools.product(QS, NS, SMS)]


@pytest.mark.parametrize("cap", sorted(THRESHOLD_PLANS))
def test_default_threshold_plans_are_the_earlier_plans(cap):
    got = [ops.threshold_plan(cap, Q, N, s) for Q, N, s in itertools.product(QS, NS, SMS)]
    assert got == THRESHOLD_PLANS[cap]
    assert got == [ops.threshold_plan(cap, Q, N, s, DEFAULT_CONFIG) for Q, N, s in itertools.product(QS, NS, SMS)]


def test_configs_move_the_plans():
    cfg = KernelConfig(max_group=4, waves=1, slice_rows=32768)
    assert ops.topk_plan(10, 64, 1_000_000, 132, cfg) == (4, 9)
    assert ops.threshold_plan(512, 64, 1_000_000, 132, cfg) == (4, 9)
    assert ops.threshold_plan(512, 64, 1_000_000, 132, KernelConfig(max_group=0)) == (0, 5)
    assert ops.topk_plan(10, 64, 1_000_000, 132, KernelConfig(max_group=0)) == (1, 5)
