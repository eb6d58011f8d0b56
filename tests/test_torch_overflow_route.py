"""The exact k-NN overflow route of ``NSimplexIndex.knn_batch`` on the CPU.

A query whose pass-B count exceeds K3's capacity (``max(512, 16k)``) takes
K3 once more, over just the batch's overflowing queries, at the width that
holds the largest count.  On a 20,000-row table with few pivots every
query of a 32-query batch overflows, most past 4,096 (the widest
shared-memory selection); under a radius hint, some do.  Each answer must equal the JAX package's
``knn_batch`` (ids, distances within 1e-12, all four ``QueryStats`` fields:
its overflow route is the dense per-query scan) and the brute-force oracle.
``LAUNCHES`` counts launches on the card only, so the wrappers the index
calls are spied on here instead.
"""

import numpy as np
import pytest
import torch

import repro_torch.index.nsimplex_index as nsimplex_module
from repro.compat import enable_x64
from repro.core.surrogate import select_pivots as rselect
from repro.data import colors_like
from repro.index.knn import knn_select
from repro.index.nsimplex_index import NSimplexIndex as RIndex
from repro.metrics import get_metric as rget
from repro_torch.index import NSimplexIndex
from repro_torch.kernels import ops
from repro_torch.metrics import get_metric

torch.set_num_threads(1)

N, Q, K, PIVOTS = 20000, 32, 10, 8
#: a cluster of near-copies of query 0 whose widened lower bounds all clamp
#: to 0: more of them than a refinement chunk (256) holds
CLUSTER = 300


def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


@pytest.fixture(scope="module", params=["euclidean", "jensen_shannon"])
def pair(request):
    X = colors_like(n=N + Q, seed=23).astype(np.float64)
    data, queries = X[:N], X[N:]
    if request.param == "euclidean":
        near = queries[0] + 1e-7 * np.random.default_rng(5).random((CLUSTER, data.shape[1]))
        data = np.concatenate([data[: N - CLUSTER], near])
    pivots = rselect(data, PIVOTS, seed=3)
    with enable_x64(True):
        ref = RIndex(data, pivots, rget(request.param), use_kernel=True)
    port = NSimplexIndex(data, pivots, get_metric(request.param), device="cpu")
    return request.param, port, ref, data, queries


def _oracle(metric, data, q, k, allowed, hint):
    d = np.asarray(rget(metric).one_to_many_np(q, data[allowed]), dtype=np.float64)
    keep = d <= hint
    return knn_select(d[keep], allowed[keep], k)


def _spy(monkeypatch):
    calls = {"K1": 0, "K3": []}
    k3, k1 = nsimplex_module.apex_bounds_threshold, nsimplex_module.apex_bounds_batch

    def threshold(table, queries, thresholds, cap, **kw):
        calls["K3"].append((queries.shape[0], cap))
        return k3(table, queries, thresholds, cap, **kw)

    def batch(*a, **kw):
        calls["K1"] += 1
        return k1(*a, **kw)

    monkeypatch.setattr(nsimplex_module, "apex_bounds_threshold", threshold)
    monkeypatch.setattr(nsimplex_module, "apex_bounds_batch", batch)
    return calls


@pytest.mark.parametrize("case", ["plain", "rowmask", "radius_hint", "one_query", "small_budget"])
def test_overflow_route_equals_reference_and_oracle(pair, case, monkeypatch):
    metric, port, ref, data, queries = pair
    kw = {}
    allowed = np.arange(N)
    hint = np.full(Q, np.inf)
    if case == "rowmask":
        mask = np.random.default_rng(3).random(N) < 0.7
        kw["rowmask"], allowed = mask, np.flatnonzero(mask)
    elif case == "radius_hint":
        # halfway across each query's widest relative gap between neighbours
        # i and i + 1: the result holds i + 1 rows, clear of the slack
        full = [d for _, d, _ in ref.knn_batch(queries, K)]
        gap = [np.argmax((d[1:] - d[:-1]) / d[1:]) for d in full]
        hint = np.array([0.5 * (d[i] + d[i + 1]) for d, i in zip(full, gap)])
        kw["radius_hint"] = hint
    elif case == "one_query":
        queries = queries[:1]
    elif case == "small_budget":
        monkeypatch.setattr(ops, "_WIDE_SCRATCH_BYTES", 1 << 24)
    want = ref.knn_batch(queries, K, **kw)
    calls = _spy(monkeypatch)
    before = port.overflow_queries
    got = port.knn_batch(queries, K, **kw)
    n_q, n_over = len(queries), port.overflow_queries - before
    # every query overflows pass B; a hint below the k-th distance shrinks
    # the radius, so that then only some do
    assert n_over == n_q or (case == "radius_hint" and 0 < n_over < n_q)

    # pass B, then K3 again over the overflowing queries; never K1
    (pass_b, cap), *rerun = calls["K3"]
    assert pass_b == n_q and cap == 512 and calls["K1"] == 0
    width = rerun[0][1]
    assert {w for _, w in rerun} == {width} and sum(q for q, _ in rerun) == n_over
    assert width == N or width & (width - 1) == 0
    if case == "small_budget":
        assert len(rerun) == -(-n_q // ops.threshold_chunk(width, n_q, N)) > 1
    else:
        assert len(rerun) == 1

    for qi, ((gi, gd, gs), (wi, wd, ws)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-12, atol=1e-12)
        assert _stats(gs) == _stats(ws)
        # under a hint the answer is the top-k of the rows within it (rows
        # beyond it may follow, as in the reference)
        oi, od = _oracle(metric, data, queries[qi], K, allowed, hint[qi])
        within = gd <= hint[qi]
        np.testing.assert_array_equal(gi[within], oi)
        np.testing.assert_allclose(gd[within], od, rtol=1e-12, atol=1e-12)


def test_rerun_width_holds_every_count_past_4096(pair, monkeypatch):
    """The cases above reach the wide plan's widths: the counts pass 4,096,
    the re-run's width is the next power of two of the largest (or N), and a
    clamped cluster of more than one chunk precedes the euclidean query 0."""
    metric, port, _, data, queries = pair
    counts = []
    k3 = nsimplex_module.apex_bounds_threshold

    def threshold(table, q, thresholds, cap, **kw):
        out = k3(table, q, thresholds, cap, **kw)
        counts.append((cap, out[3].numpy()))
        return out

    monkeypatch.setattr(nsimplex_module, "apex_bounds_threshold", threshold)
    port.knn_batch(queries, K)
    (_, c_b), (width, c_r) = counts
    np.testing.assert_array_equal(c_r, c_b)
    assert c_b.min() > 512 and c_b.max() > ops.MAX_SELECT_WIDTH
    assert width == min(N, 1 << (int(c_b.max()) - 1).bit_length())
    if metric == "euclidean":
        assert width < N
        apex = port.query_apex_batch(torch.as_tensor(queries[:1]))
        err = port._kernel_err_sq(apex.numpy())
        lwb, _ = port.bounds_batch(apex)
        assert int((lwb[0].numpy() ** 2 < err).sum()) > 256
