"""The port's LAESA index and approximate-search helpers against the JAX
package's, on the CPU; and the coverage of ``select_pivots(strategy=
"maxmin")`` and of the triangular and quadratic-form metrics at index level.

Both packages see the same float64 corpus (1200 rows, dim 24), the same 10
pivots and the same queries; the reference runs under ``enable_x64`` (its
quadratic form is jnp, float32 otherwise).  The Chebyshev/triangle bounds
use only subtraction, abs, max, addition and min, so for the same table and
query-pivot distances they are bit-equal; answers are held to identical ids
in (distance, id) order, distances within 1e-12 and equal ``QueryStats``.
Range thresholds sit between two neighbour distances, since f64 distances
agree to ~1e-16, not bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core.surrogate import select_pivots as rselect
from repro.data import colors_like
from repro.index import approx as rapprox
from repro.index.laesa import LaesaIndex as RLaesa
from repro.index.nsimplex_index import NSimplexIndex as RIndex
from repro.metrics import get_metric as rget
from repro.metrics.supermetrics import QuadraticFormMetric as RQuadratic
from repro_torch.core import select_pivots
from repro_torch.index import LaesaIndex, NSimplexIndex
from repro_torch.index import approx as tapprox
from repro_torch.metrics import get_metric

# small shapes: one intra-op thread keeps these tests from crowding the
# other pytest workers
torch.set_num_threads(1)

N, Q, DIM, N_PIVOTS, DIMS, REFINE = 1200, 8, 24, 10, 4, 40
METRICS = ["euclidean", "cosine", "jensen_shannon", "triangular", "quadratic_form"]
F64 = dict(rtol=1e-12, atol=1e-12)


def _stats(s):
    return dataclasses.astuple(s)[:4]


def metric_pair(name):
    """(port metric, reference metric); the quadratic form shares one W."""
    if name == "quadratic_form":
        W = RQuadratic.random(DIM, seed=4).W
        return get_metric(name, W=np.asarray(W)), RQuadratic(W)
    return get_metric(name), rget(name)


@pytest.fixture(scope="module")
def corpus():
    X = colors_like(n=N + Q, dim=DIM, seed=17).astype(np.float64)
    return X[:N], X[N:]


def threshold(ref_metric, data, q, rank=40):
    """Between the rank-th and (rank+1)-th neighbour distances of ``q``."""
    with enable_x64(True):
        d = np.sort(ref_metric.one_to_many_np(q, data))
    return float(0.5 * (d[rank] + d[rank + 1]))


@pytest.fixture(scope="module", params=METRICS)
def pair(request, corpus):
    data, queries = corpus
    pm, rm = metric_pair(request.param)
    pivots = rselect(data, N_PIVOTS, seed=2)
    with enable_x64(True):
        ref = RLaesa(data, pivots, rm)
    port = LaesaIndex(data, pivots, pm, device="cpu")
    return port, ref, rm, data, queries


def test_table_matches_reference(pair):
    """Squared, since a row against itself (a pivot's own row) is 0 only up
    to rounding under the cosine chord's sqrt."""
    port, ref, *_ = pair
    np.testing.assert_allclose(port.table.numpy() ** 2, ref.table**2, **F64)
    assert port.table.dtype == torch.float64 and port.table.device.type == "cpu"


@pytest.mark.parametrize("dims", [None, DIMS])
def test_bounds_bit_equal(pair, dims):
    """Same table (carried across) and same query-pivot distances: lwb and
    upb bit for bit, full and truncated, batch and one query."""
    port, ref, _, _, queries = pair
    carried = LaesaIndex.from_state(ref.state_arrays(), port.metric, device="cpu")
    with enable_x64(True):
        qd = ref.query_distances_batch(queries)
    qd = qd if dims is None else qd[:, :dims]
    want = ref.bounds_batch(qd, dims=dims)
    got = carried.bounds_batch(qd, dims=dims)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if dims is None:
        for g, w in zip(carried.bounds(qd[0]), ref.bounds(qd[0])):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("k", [1, 10, 100])
def test_knn_equals_reference(pair, k):
    port, ref, *_ , queries = pair
    with enable_x64(True):
        want = ref.knn_batch(queries, k)
        want_1 = [ref.knn(q, k) for q in queries[:2]]
    got = port.knn_batch(queries, k)
    got_1 = [port.knn(q, k) for q in queries[:2]]
    for (gi, gd, gs), (wi, wd, ws) in zip(got + got_1, want + want_1):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, **F64)
        assert _stats(gs) == _stats(ws)


def test_range_equals_reference(pair):
    port, ref, rm, data, queries = pair
    t = threshold(rm, data, queries[0])
    with enable_x64(True):
        want = ref.search_batch(queries, t)
        want_1 = [ref.search(q, t) for q in queries[:2]]
    for (gi, gs), (wi, ws) in zip(port.search_batch(queries, t) + [port.search(q, t) for q in queries[:2]],
                                  want + want_1):
        np.testing.assert_array_equal(gi, wi)
        assert _stats(gs) == _stats(ws)


def test_rowmask_and_radius_hint_equal_reference(pair):
    port, ref, *_ , queries = pair
    mask = np.zeros(N, dtype=bool)
    mask[::3] = True
    allowed = np.flatnonzero(mask)[:100]
    hint = np.full(Q, 0.25)
    with enable_x64(True):
        cases = [
            (dict(rowmask=mask), ref.knn_batch(queries, 10, rowmask=mask)),
            (dict(rowmask=allowed), ref.knn_batch(queries, 10, rowmask=allowed)),
            (dict(radius_hint=hint), ref.knn_batch(queries, 10, radius_hint=hint)),
        ]
        want_1 = ref.knn(queries[0], 10, rowmask=mask)
    for kw, want in cases:
        for (gi, gd, gs), (wi, wd, ws) in zip(port.knn_batch(queries, 10, **kw), want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gd, wd, **F64)
            assert _stats(gs) == _stats(ws)
    gi, gd, gs = port.knn(queries[0], 10, rowmask=mask)
    np.testing.assert_array_equal(gi, want_1[0])
    assert _stats(gs) == _stats(want_1[2])


ONE_QUERY_CASES = {
    "radius_hint": lambda ref, q: (10, dict(radius_hint=0.25)),
    "qpd": lambda ref, q: (10, dict(qpd=ref.query_distances(q))),
    "allowed_ids": lambda ref, q: (10, dict(rowmask=np.arange(5, 12))),
    "k_above_allowed": lambda ref, q: (20, dict(rowmask=np.arange(5, 12))),
    "empty_mask": lambda ref, q: (10, dict(rowmask=np.zeros(N, dtype=bool))),
    "k_zero": lambda ref, q: (0, {}),
}


@pytest.mark.parametrize("case", sorted(ONE_QUERY_CASES))
def test_one_query_knn_equals_reference(pair, case):
    """One-query ``knn`` (a block of one on the device) under each option:
    ids, distances and ``QueryStats`` as the reference's own ``knn``, whose
    ``surrogate_calls`` counts every row even under a mask."""
    port, ref, *_ , queries = pair
    with enable_x64(True):
        k, kw = ONE_QUERY_CASES[case](ref, queries[0])
        wi, wd, ws = ref.knn(queries[0], k, **kw)
    gi, gd, gs = port.knn(queries[0], k, **kw)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, **F64)
    assert _stats(gs) == _stats(ws)


def test_approx_equals_reference(pair):
    """Approximate k-NN and range on the carried-across table with the
    reference's own query-pivot distances.  k-NN is held to the reference
    where the ``REFINE``-th and next mean estimates differ (the reference's
    ``argpartition`` takes an arbitrary subset of tied rows), and everywhere
    to the exact top-k of the first ``REFINE`` rows by (estimate, id)."""
    port, ref, rm, data, queries = pair
    carried = LaesaIndex.from_state(ref.state_arrays(), port.metric, device="cpu")
    t = threshold(rm, data, queries[0])
    with enable_x64(True):
        qd = rm.cross_np(queries, ref.pivots[:DIMS])
        want_knn = ref.knn_approx_batch(queries, 10, dims=DIMS, refine=REFINE, qpd=qd)
        want_rng = ref.search_approx_batch(queries, t, dims=DIMS, refine=10, qpd=qd)
        lwb, upb = ref.bounds_batch(qd, dims=DIMS)
        d_all = np.stack([rm.one_to_many_np(q, data) for q in queries])
    got_knn = carried.knn_approx_batch(queries, 10, dims=DIMS, refine=REFINE, qpd=qd)
    untied = 0
    for qi, ((gi, gd, gs), (wi, wd, ws)) in enumerate(zip(got_knn, want_knn)):
        est = 0.5 * (lwb[qi] + upb[qi])
        cand = np.lexsort((np.arange(N), est))[:REFINE]
        order = np.lexsort((cand, d_all[qi][cand]))[:10]
        np.testing.assert_array_equal(gi, cand[order])
        np.testing.assert_allclose(gd, d_all[qi][cand[order]], **F64)
        assert (gs.original_calls, gs.candidates) == (REFINE, REFINE)
        s = np.sort(est)
        if s[REFINE] > s[REFINE - 1]:
            untied += 1
            np.testing.assert_array_equal(gi, wi)
            assert gs.bound_width == pytest.approx(ws.bound_width, rel=1e-12)
    assert untied >= 1
    for (gi, gs), (wi, ws) in zip(carried.search_approx_batch(queries, t, dims=DIMS, refine=10, qpd=qd), want_rng):
        np.testing.assert_array_equal(gi, wi)
        assert _stats(gs) == _stats(ws)
        assert gs.bound_width == pytest.approx(ws.bound_width, rel=1e-12)


def test_approx_measures_dims_pivots(pair):
    """Without ``qpd`` each query measures only the ``dims`` prefix."""
    port, *_, queries = pair
    (_, _, s), = port.knn_approx_batch(queries[:1], 5, dims=DIMS, refine=20)
    assert (s.original_calls, s.surrogate_calls) == (DIMS + 20, N)
    ids, s = port.search_approx(queries[0], 0.0, dims=DIMS, refine=3)
    assert s.original_calls <= DIMS + 3


# -- the approximate helpers on their own ------------------------------------
def _bounds(seed, n=300):
    rng = np.random.default_rng(seed)
    lwb = rng.random(n)
    return lwb, lwb + rng.random(n) * 0.5


@pytest.mark.parametrize("k, refine", [(5, 20), (5, 2), (300, 10), (0, 10)])
def test_approx_knn_from_bounds_equals_reference(k, refine):
    lwb, upb = _bounds(1)
    true = 0.5 * (lwb + upb) + np.random.default_rng(2).normal(0, 0.05, lwb.shape)
    want = rapprox.approx_knn_from_bounds(lambda r: true[r], lwb, upb, k, refine)
    got = tapprox.approx_knn_from_bounds(lambda r: true[r], torch.tensor(lwb), torch.tensor(upb), k, refine)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert got[3] == pytest.approx(want[3], rel=1e-12)


@pytest.mark.parametrize("t, refine", [(0.5, 0), (0.5, 7), (0.7, 1000), (-1.0, 3)])
def test_approx_search_from_bounds_equals_reference(t, refine):
    lwb, upb = _bounds(3)
    true = 0.5 * (lwb + upb)
    want = rapprox.approx_search_from_bounds(lambda r: true[r], lwb, upb, t, refine)
    got = tapprox.approx_search_from_bounds(lambda r: true[r], torch.tensor(lwb), torch.tensor(upb), t, refine)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_approx_knn_from_est_breaks_ties_by_id():
    est = torch.tensor([0.3, 0.1, 0.1, 0.2, 0.1, 0.1])
    ids, d, n_eval, _ = tapprox.approx_knn_from_est(lambda r: np.zeros(len(r)), est, 2, 3)
    assert n_eval == 3
    np.testing.assert_array_equal(ids, [1, 2])


# -- coverage: maxmin pivots, triangular and quadratic form at index level ---
@pytest.mark.parametrize("name", METRICS)
def test_select_pivots_maxmin_draws_the_same_rows(name, corpus):
    data, _ = corpus
    pm, rm = metric_pair(name)
    with enable_x64(True):
        want = rselect(data, N_PIVOTS, strategy="maxmin", seed=5, metric=rm)
    np.testing.assert_array_equal(select_pivots(data, N_PIVOTS, strategy="maxmin", seed=5, metric=pm), want)


@pytest.mark.parametrize("kind", ["nsimplex", "laesa"])
@pytest.mark.parametrize("name", ["euclidean", "jensen_shannon"])
def test_maxmin_pivot_indexes_equal_reference(name, kind, corpus):
    data, queries = corpus
    pm, rm = metric_pair(name)
    with enable_x64(True):
        pivots = rselect(data, N_PIVOTS, strategy="maxmin", seed=5, metric=rm)
        ref = RIndex(data, pivots, rm, use_kernel=True) if kind == "nsimplex" else RLaesa(data, pivots, rm)
        want = ref.knn_batch(queries[:4], 10)
    cls = NSimplexIndex if kind == "nsimplex" else LaesaIndex
    port = cls(data, select_pivots(data, N_PIVOTS, strategy="maxmin", seed=5, metric=pm), pm, device="cpu")
    for (gi, gd, gs), (wi, wd, ws) in zip(port.knn_batch(queries[:4], 10), want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, **F64)
        assert _stats(gs) == _stats(ws)


@pytest.mark.parametrize("name", ["triangular", "quadratic_form"])
def test_nsimplex_index_equals_reference(name, corpus):
    """The n-simplex index on the two metrics the earlier parity tests left
    out, against the reference's ``use_kernel=True`` run."""
    data, queries = corpus
    pm, rm = metric_pair(name)
    pivots = rselect(data, N_PIVOTS, seed=2)
    t = threshold(rm, data, queries[0])
    with enable_x64(True):
        ref = RIndex(data, pivots, rm, use_kernel=True)
        want_knn = ref.knn_batch(queries[:4], 10)
        want_rng = ref.search_batch(queries[:4], t)
    port = NSimplexIndex(data, pivots, pm, device="cpu")
    for (gi, gd, gs), (wi, wd, ws) in zip(port.knn_batch(queries[:4], 10), want_knn):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, **F64)
        assert _stats(gs) == _stats(ws)
    for (gi, gs), (wi, ws) in zip(port.search_batch(queries[:4], t), want_rng):
        np.testing.assert_array_equal(gi, wi)
        assert _stats(gs) == _stats(ws)


def test_laesa_default_device_raises_without_a_card(corpus):
    data, _ = corpus
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LaesaIndex(data[:50], data[:4], get_metric("euclidean"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LaesaIndex.from_state({"data": data[:50], "pivots": data[:4], "table": np.zeros((50, 4))},
                              get_metric("euclidean"))
