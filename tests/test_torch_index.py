"""The port's ``NSimplexIndex`` against the JAX package's, on the CPU.

Both indexes see the same float64 corpus, pivots and queries.  The
reference is fitted under ``enable_x64`` (its jnp pivot fit is float32
otherwise) and queried in both of its modes: ids and (distance, id) tie
order must be identical to both, distances within 1e-12, and ``QueryStats``
equal to its ``use_kernel=True`` run, whose algorithm the port follows.
"""

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core.surrogate import select_pivots as rselect
from repro.data import colors_like
from repro.index.knn import knn_select
from repro.index.nsimplex_index import NSimplexIndex as RIndex
from repro.metrics import get_metric as rget
from repro_torch.index import NSimplexIndex
from repro_torch.metrics import get_metric

# small shapes: one intra-op thread keeps these tests from crowding the
# other pytest workers
torch.set_num_threads(1)

N, Q, DIM_GAUSS = 1000, 8, 24


def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


def _corpus(kind):
    if kind == "colors":
        X = colors_like(n=N + Q, seed=17).astype(np.float64)
    else:
        X = np.abs(np.random.default_rng(5).normal(size=(N + Q, DIM_GAUSS)))
    return X[:N], X[N:]


@pytest.fixture(scope="module", params=[
    ("euclidean", "colors"), ("euclidean", "gauss"),
    ("cosine", "colors"), ("cosine", "gauss"),
    ("jensen_shannon", "colors"), ("jensen_shannon", "gauss"),
])
def trio(request):
    name, kind = request.param
    data, queries = _corpus(kind)
    pivots = rselect(data, 10, seed=2)
    with enable_x64(True):
        ref_k = RIndex(data, pivots, rget(name), use_kernel=True)
    ref_h = RIndex.from_state(ref_k.state_arrays(), rget(name), use_kernel=False)
    port = NSimplexIndex(data, pivots, get_metric(name), device="cpu")
    return port, ref_k, ref_h, queries


def _same_knn(got, refs, stats_ref):
    for want in refs:
        assert len(got) == len(want)
        for (gi, gd, _), (wi, wd, _) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gd, wd, rtol=1e-12, atol=1e-12)
    assert [_stats(s) for _, _, s in got] == [_stats(s) for _, _, s in stats_ref]


def _same_range(got, refs, stats_ref):
    for want in refs:
        for (gi, _), (wi, _) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
    assert [_stats(s) for _, s in got] == [_stats(s) for _, s in stats_ref]


@pytest.mark.parametrize("k", [1, 10, 100])
def test_knn_batch(trio, k):
    port, ref_k, ref_h, queries = trio
    want_k = ref_k.knn_batch(queries, k)
    _same_knn(port.knn_batch(queries, k), [want_k, ref_h.knn_batch(queries, k)], want_k)


def _between(dists, i):
    """Thresholds halfway between the i-th and (i+1)-th neighbour distance:
    a threshold equal to a computed distance would hinge on its last ulp."""
    return np.array([0.5 * (d[i] + d[i + 1]) for d in dists])


def test_search_batch_scalar_and_per_query(trio):
    port, ref_k, ref_h, queries = trio
    kth = _between([d for _, d, _ in ref_h.knn_batch(queries, 26)], 24)
    for t in (float(np.median(kth)), kth):
        want = ref_k.search_batch(queries, t)
        _same_range(port.search_batch(queries, t), [want, ref_h.search_batch(queries, t)], want)


def test_single_knn_and_search(trio):
    port, ref_k, ref_h, queries = trio
    t = float(_between([ref_h.knn(queries[0], 31)[1]], 29)[0])
    for q in queries[:3]:
        want = ref_k.knn(q, 10)
        _same_knn([port.knn(q, 10)], [[want], [ref_h.knn(q, 10)]], [want])
        want = ref_k.search(q, t)
        _same_range([port.search(q, t)], [[want], [ref_h.search(q, t)]], [want])


def test_rowmask(trio):
    port, ref_k, ref_h, queries = trio
    mask = np.random.default_rng(3).random(N) < 0.4
    want = ref_k.knn_batch(queries, 10, rowmask=mask)
    _same_knn(port.knn_batch(queries, 10, rowmask=mask), [want, ref_h.knn_batch(queries, 10, rowmask=mask)], want)
    t = float(np.median(_between([d for _, d, _ in want], 8)))
    want = ref_k.search_batch(queries, t, rowmask=mask)
    _same_range(port.search_batch(queries, t, rowmask=mask), [want], want)
    allowed = np.flatnonzero(mask)                   # positions form
    q = queries[0]
    want = ref_k.knn(q, 5, rowmask=allowed)
    _same_knn([port.knn(q, 5, rowmask=allowed)], [[want]], [want])
    want = ref_k.search(q, t, rowmask=allowed)
    _same_range([port.search(q, t, rowmask=allowed)], [[want]], [want])


def test_radius_hint_and_qpd(trio):
    port, ref_k, _, queries = trio
    full = ref_k.knn_batch(queries, 10)
    hint = _between([d for _, d, _ in full], 4)       # caps the result at 5 rows
    want = ref_k.knn_batch(queries, 10, radius_hint=hint)
    _same_knn(port.knn_batch(queries, 10, radius_hint=hint), [want], want)
    qpd = ref_k.metric.cross_np(queries, ref_k.projector.pivots)
    want = ref_k.knn_batch(queries, 10, qpd=qpd)
    _same_knn(port.knn_batch(queries, 10, qpd=qpd), [want], want)
    want = ref_k.search(queries[1], float(hint[1]), qpd=qpd[1])
    _same_range([port.search(queries[1], float(hint[1]), qpd=qpd[1])], [[want]], [want])


@pytest.fixture(scope="module")
def big():
    """N > 4096, so a threshold admitting every row overflows K3's capacity."""
    X = np.random.default_rng(11).normal(size=(4200 + 4, 12))
    data, queries = X[:4200], X[4200:]
    pivots = rselect(data, 8, seed=4)
    with enable_x64(True):
        ref_k = RIndex(data, pivots, rget("euclidean"), use_kernel=True)
    return NSimplexIndex(data, pivots, get_metric("euclidean"), device="cpu"), ref_k, queries


def test_range_overflow_takes_per_query_k1(big):
    port, ref_k, queries = big
    want = ref_k.search_batch(queries, 1e3)
    got = port.search_batch(queries, 1e3)
    _same_range(got, [want], want)
    assert all(len(ids) == 4200 for ids, _ in got)
    assert port.overflow_queries == len(queries)


def test_wide_knn_takes_the_overflow_route(big):
    """k = 300 asks for a K3 width min(N, 16k) = 4200, above 4096 (the name
    is that of the route such a width once took): K3 runs at that width as
    in the reference, and since the width is N no count can exceed it, so no
    query takes the overflow route; answers and ledger are the reference's
    ``knn_batch``'s (its kernel path: the overflow route's dense candidate
    count can differ by one)."""
    port, ref_k, queries = big
    before = port.overflow_queries
    got = port.knn_batch(queries, 300)
    assert port.overflow_queries == before
    want = ref_k.knn_batch(queries, 300)
    _same_knn(got, [want], want)


def test_ties_on_duplicated_rows_follow_brute_force():
    base = colors_like(n=80, seed=11).astype(np.float64)
    data = np.concatenate([base, base, base[:40]])        # every row duplicated
    metric = get_metric("euclidean")
    pivots = rselect(data, 6, seed=3)                    # a non-degenerate draw
    port = NSimplexIndex(data, pivots, metric, device="cpu")
    queries = np.concatenate([base[:4], colors_like(n=90, seed=12)[80:84].astype(np.float64)])
    rm = rget("euclidean")
    for k in (1, 3, 80, 100):
        got = port.knn_batch(queries, k)
        for q, (ids, d, _) in zip(queries, got):
            dist = rm.one_to_many_np(q, data)
            want_ids, want_d = knn_select(dist, np.arange(len(dist)), min(k, len(dist)))
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_allclose(d, want_d, rtol=1e-12, atol=1e-12)
            ids1, _, _ = port.knn(q, k)
            np.testing.assert_array_equal(ids1, want_ids)


def test_state_roundtrip_is_bit_identical(trio):
    port, ref_k, _, queries = trio
    back = NSimplexIndex.from_state(ref_k.state_arrays(), port.metric, device="cpu")
    np.testing.assert_array_equal(back.table.numpy(), ref_k.table)
    want = ref_k.knn_batch(queries, 10)
    _same_knn(back.knn_batch(queries, 10), [want], want)
    again = NSimplexIndex.from_state(port.state_arrays(), port.metric, device="cpu")
    np.testing.assert_array_equal(again.table.numpy(), port.table.numpy())


def test_pivot_rows_and_prefix_apexes(trio):
    port, ref_k, _, queries = trio
    np.testing.assert_array_equal(port.pivot_rows(), ref_k.pivot_rows())
    np.testing.assert_array_equal(port.pivot_rows(4), ref_k.pivot_rows(4))
    np.testing.assert_allclose(
        port.query_apex_batch(queries, dims=4).numpy(),
        ref_k.query_apex_batch(queries, dims=4),
        rtol=1e-9, atol=1e-12,
    )
