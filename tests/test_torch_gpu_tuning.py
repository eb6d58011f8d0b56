"""The launch-plan tuner on the card (``repro_torch.kernels.tuning``).

Marked ``gpu``; without a CUDA device every test skips (decided inside the
``cuda`` fixture).  Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_tuning.py

* every candidate of K1's, K2's and K3's full sweep validates: K1 within
  its tolerance (rtol = atol = 2e-5), K2 and K3 bit-equal to the plain
  selection over K1's own matrices, under every (G, S) the space yields;
* a cache entry reaches the wrappers: with a winner on file, K1, K2 and K3
  plan under it (the plan functions receive the cached config) and still
  answer bit-equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref, tuning

pytestmark = pytest.mark.gpu

N, N_PIVOTS = 200_000, 20


@pytest.fixture
def cuda(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    monkeypatch.setenv(tuning.CACHE_ENV_VAR, str(tmp_path / "kernel_tuning.json"))
    tuning.reset_lookup_memo()
    yield torch.device("cuda")
    tuning.reset_lookup_memo()


def _apexes(rows, seed, device):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(rows, N_PIVOTS)) * 0.3
    a[:, -1] = np.abs(a[:, -1])
    return torch.tensor(a, dtype=torch.float32, device=device)


def _fast_timer(thunk, config):
    thunk()
    return 1.0


@pytest.mark.parametrize("kernel", tuning.KERNELS)
@pytest.mark.parametrize("Q", [1, 13])
def test_every_candidate_validates(cuda, kernel, Q):
    table, q = _apexes(N, 1, cuda), _apexes(Q, 2, cuda)
    kw = {}
    if kernel == "apex_topk":
        kw = dict(k=10, key="upb")
    elif kernel == "apex_threshold":
        _, U = ops.apex_bounds_batch(table, q)
        kw = dict(cap=512, thresholds=torch.kthvalue(U, 10, dim=1).values)
    winner, rows = tuning.autotune(table, q, kernel=kernel, timer=_fast_timer, cache=None, **kw)
    assert all(r["valid"] for r in rows), [r for r in rows if not r["valid"]]
    assert winner == min(tuning.KernelConfig(r["plan"], r["max_group"], r["waves"], r["slice_rows"]) for r in rows)


def test_cache_entry_reaches_the_wrappers(cuda, monkeypatch):
    table, q = _apexes(N, 3, cuda), _apexes(16, 4, cuda)
    cache = tuning.TuningCache()
    won = tuning.KernelConfig(plan="tile", max_group=0, waves=1, slice_rows=2048)
    for kernel in tuning.KERNELS:
        cache.put(tuning.make_key(kernel, N_PIVOTS, N_PIVOTS, torch.float32), won, 1.0)
    cache.save()
    tuning.reset_lookup_memo()
    seen = []
    real_topk, real_thr = ops.topk_plan, ops.threshold_plan
    # the config is the fifth argument; the key's bytes follow by keyword
    monkeypatch.setattr(ops, "topk_plan", lambda *a, **k: (seen.append(("topk", a[4])), real_topk(*a, **k))[1])
    monkeypatch.setattr(ops, "threshold_plan", lambda *a, **k: (seen.append(("thr", a[4])), real_thr(*a, **k))[1])
    L, U = ops.apex_bounds_batch(table, q)
    torch.testing.assert_close(L, ops.apex_bounds_batch(table, q, _plan="stream")[0], rtol=0, atol=0)
    got = ops.apex_bounds_topk(table, q, 10, key="upb")
    want = ref.topk_from_bounds(L, U, 10, "upb")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    t = torch.kthvalue(U, 10, dim=1).values
    got = ops.apex_bounds_threshold(table, q, t, 512)
    want = ref.threshold_from_bounds(L, U, t, 512)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert seen == [("topk", won), ("thr", won)]
