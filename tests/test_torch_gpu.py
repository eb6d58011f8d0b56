"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; without a CUDA device every test skips (the decision is
taken inside the ``cuda`` fixture, so every pytest worker collects the same
tests).  Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: rtol = atol = 2e-5 in float32, 1e-12 in float64 for K1 and K6;
K2 and K3 must equal a selection over K1's own float32 matrices exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, ops, ref

pytestmark = pytest.mark.gpu

SENTINEL = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


def _apexes(N, n, seed, dtype, device):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(N, n)) * 0.3
    a[:, -1] = np.abs(a[:, -1])
    return torch.tensor(a, dtype=dtype, device=device)


def _close(got, want, dtype):
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [1, 1000, 70_001])
def test_k6_apex_bounds(cuda, dtype, N):
    table, query = _apexes(N, 20, 1, dtype, cuda), _apexes(1, 20, 2, dtype, cuda)[0]
    before = LAUNCHES["apex_bounds"]
    got = ops.apex_bounds(table, query)
    assert LAUNCHES["apex_bounds"] == before + 1
    for g, w in zip(got, ref.apex_bounds_ref(table, query)):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [None, 2, 9])
@pytest.mark.parametrize("pretruncated", [False, True])
def test_k1_apex_bounds_batch(cuda, dtype, dims, pretruncated):
    table, queries = _apexes(50_003, 20, 3, dtype, cuda), _apexes(37, 20, 4, dtype, cuda)
    if pretruncated and dims is not None:
        queries = queries[:, :dims].contiguous()
    got = ops.apex_bounds_batch(table, queries, dims=dims)
    for g, w in zip(got, ref.apex_bounds_batch_ref(table, queries, dims or 20)):
        _close(g, w, dtype)


def _selection(packed, L, U, width):
    return ref._take(packed, L, U, width)


@pytest.mark.parametrize("key", ["lwb", "upb", "mid"])
@pytest.mark.parametrize("k", [1, 10, 513, 4096])
@pytest.mark.parametrize("masked", [False, True])
def test_k2_topk_equals_selection_over_k1(cuda, key, k, masked):
    table, queries = _apexes(30_011, 20, 5, torch.float32, cuda), _apexes(19, 20, 6, torch.float32, cuda)
    mask = torch.rand(30_011, generator=torch.Generator().manual_seed(7)).lt(0.3).to(cuda) if masked else None
    ids, lwb, upb = ops.apex_bounds_topk(table, queries, k, key=key, dims=11, rowmask=mask)
    L, U = ops.apex_bounds_batch(table, queries, dims=11)
    keys = {"lwb": L, "upb": U}.get(key, 0.5 * (L + U))
    live = torch.ones_like(L, dtype=torch.bool) if mask is None else mask[None].expand_as(L)
    want = _selection(ref.pack_keys(keys, live), L, U, k)
    for g, w in zip((ids, lwb, upb), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cap", [1, 512, 4096])
@pytest.mark.parametrize("masked", [False, True])
def test_k3_threshold_equals_selection_over_k1(cuda, cap, masked):
    table, queries = _apexes(40_009, 20, 8, torch.float32, cuda), _apexes(23, 20, 9, torch.float32, cuda)
    mask = torch.rand(40_009, generator=torch.Generator().manual_seed(3)).lt(0.6).to(cuda) if masked else None
    L, U = ops.apex_bounds_batch(table, queries)
    ranks = torch.linspace(1, 5000, queries.shape[0], device=cuda).long()
    thr = torch.sort(L[:, :16384], dim=1).values[torch.arange(queries.shape[0], device=cuda), ranks]
    thr[0] = -1.0                                         # an empty query
    ids, lwb, upb, counts = ops.apex_bounds_threshold(table, queries, thr, cap, rowmask=mask)
    live = torch.ones_like(L, dtype=torch.bool) if mask is None else mask[None].expand_as(L)
    hit = live & (L <= thr[:, None])
    assert torch.equal(counts, hit.sum(dim=1).to(torch.int32))
    assert bool((counts > cap).any())                     # overflow keeps the cap smallest
    assert int(counts[0]) == 0 and bool((ids[0] == SENTINEL).all())
    want = _selection(ref.pack_keys(L, hit), L, U, cap)
    for g, w in zip((ids, lwb, upb), want):
        assert torch.equal(g, w)


def test_wider_than_kernel_refused(cuda):
    table, queries = _apexes(5000, 8, 1, torch.float32, cuda), _apexes(2, 8, 2, torch.float32, cuda)
    with pytest.raises(ValueError, match="exceeds"):
        ops.apex_bounds_topk(table, queries, ops.MAX_SELECT_WIDTH + 1, key="lwb")
    with pytest.raises(TypeError):
        ops.apex_bounds_topk(table.double(), queries.double(), 3, key="lwb")


def test_index_on_card_matches_brute_force(cuda):
    """k-NN and range through the kernels equal a float64 scan on the card."""
    from repro_torch.api import Query, build_index
    from repro_torch.data import colors_like
    from repro_torch.metrics import get_metric

    X = colors_like(n=60_000 + 16, seed=5).astype(np.float64)
    data, queries = X[:60_000], X[60_000:]
    index = build_index(data, "jensen_shannon", n_pivots=16, seed=1)
    metric, data_t = get_metric("jensen_shannon"), index.data
    for q, r in zip(queries, index.query(queries, Query.knn(10))):
        d = metric.one_to_many(torch.tensor(q, device=cuda), data_t)
        want = torch.sort(d, stable=True).indices[:10].cpu().numpy()
        np.testing.assert_array_equal(r.ids, want)
        np.testing.assert_allclose(r.distances, d[want].cpu().numpy(), rtol=1e-12, atol=1e-12)
    t = 0.5 * float(r.distances[-1] + r.distances[-2])
    for q, r in zip(queries, index.query(queries, Query.range(t))):
        d = metric.one_to_many(torch.tensor(q, device=cuda), data_t)
        np.testing.assert_array_equal(r.ids, torch.nonzero(d <= t).flatten().cpu().numpy())
