"""The port's approximate (truncated-surrogate) search against the JAX
package's, on the CPU: the index paths, the host decision module, the API
(build config, plans, persistence both ways, ``SearchService``) and the
recall of the quality harness.

Both packages see the same float64 corpus, pivots and queries; the
reference is fitted under ``enable_x64`` and queried with
``use_kernel=True``, whose algorithm the port follows (K2 on the f32
mid-point key for k-NN, K3 for range).  Required: equal ids and tie order,
distances within 1e-12, equal ``QueryStats`` counts.

Two f32 facts shape the comparison.  The candidates come from f32 bounds,
and the reference's interpret-mode kernels and the port's plain versions
round a bound differently by an ulp now and then.  So (1) every parity
case first asserts that its decisions are separated by more than a few
ulps (the m-th and (m+1)-th mid keys for k-NN; the admit, exclude and
refine boundaries for range), which makes the answers independent of that
rounding; and (2) ``bound_width``, a mean of f32 bound differences, is held
to within four f32 ulps of the bound scale, not to 1e-12.
"""

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.compat import enable_x64
from repro.core.surrogate import select_pivots as rselect
from repro.data import colors_like
from repro.index import approx as rapprox
from repro.index.knn import knn_select
from repro.index.nsimplex_index import NSimplexIndex as RIndex
from repro.metrics import get_metric as rget
from repro_torch.api import Query, QueryOptions, build_index, load_index
from repro_torch.index import NSimplexIndex
from repro_torch.index import approx as tapprox
from repro_torch.index import nsimplex_index
from repro_torch.kernels import apex_bounds_batch
from repro_torch.kernels.ops import MAX_SELECT_WIDTH
from repro_torch.launch.service import SearchService
from repro_torch.metrics import get_metric

# small shapes: one intra-op thread keeps these tests from crowding the
# other pytest workers
torch.set_num_threads(1)

N, Q, N_PIVOTS, K = 1000, 8, 10, 10
EPS32 = float(np.finfo(np.float32).eps)
#: decisions closer than this many f32 ulps could round either way (the
#: two packages' bounds differ by at most one ulp)
ULPS = 4


def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


@pytest.fixture(scope="module", params=["euclidean", "cosine", "jensen_shannon"])
def trio(request):
    name = request.param
    X = colors_like(n=N + Q, seed=22).astype(np.float64)   # a seed whose decisions are ulp-separated
    data, queries = X[:N], X[N:]
    pivots = rselect(data, N_PIVOTS, seed=2)
    with enable_x64(True):
        ref = RIndex(data, pivots, rget(name), use_kernel=True)
    port = NSimplexIndex(data, pivots, get_metric(name), device="cpu")
    return port, ref, queries


def _mask(masked):
    return (np.random.default_rng(3).random(N) < 0.4) if masked else None


def _bounds(port, queries, dims):
    """The port's f32 truncated bounds (its K1 plain version) as float64."""
    apexes = port.query_apex_batch(queries, dims=dims).float()
    lwb, upb = apex_bounds_batch(port._kernel_table(), apexes, dims=dims)
    return lwb.numpy().astype(np.float64), upb.numpy().astype(np.float64), lwb.numpy(), upb.numpy()


def _assert_mid_gap(port, queries, dims, m, mask):
    """The m-th and (m+1)-th f32 mid keys of every query lie ULPS apart."""
    _, _, l32, u32 = _bounds(port, queries, dims)
    mid = (np.float32(0.5) * (l32 + u32)).astype(np.float64)
    live = np.ones(N, bool) if mask is None else mask
    for row in mid:
        keys = np.sort(row[live])
        if m < keys.shape[0]:
            assert keys[m] - keys[m - 1] > ULPS * EPS32 * keys[m], "near-tie at the m-th key: pick another corpus"


def _assert_range_margins(port, queries, t, dims, refine, mask):
    """No live row's f32 bound sits within ULPS of the admit or the exclude
    threshold, and the refine boundary of the straddlers' |est - t| order is
    separated by ULPS as well."""
    lwb, upb, _, _ = _bounds(port, queries, dims)
    apexes = port.query_apex_batch(queries, dims=dims).numpy()
    slack = port._kernel_slack(apexes, t)
    t_hi = t * (1.0 + port.eps) + 1e-12 + slack
    t_lo = t * (1.0 - port.eps) - 1e-12 - slack
    live = np.ones(N, bool) if mask is None else mask
    for qi in range(queries.shape[0]):
        tol = ULPS * EPS32 * t_hi[qi]
        l, u = lwb[qi][live], upb[qi][live]
        assert np.min(np.abs(u - t_lo[qi])) > tol and np.min(np.abs(l - t_hi[qi])) > tol
        strad = (l <= t_hi[qi]) & (u > t_lo[qi])
        gap = np.sort(np.abs(0.5 * (l[strad] + u[strad]) - t[qi]))
        r = min(refine, gap.shape[0])
        if r < gap.shape[0]:
            assert gap[r] > tol and (r == 0 or gap[r] - gap[r - 1] > tol), "near-tie at the refine boundary"


def _width_tol(port, queries, dims):
    """Four f32 ulps of the largest bound (|q| + max |x|) of these queries."""
    apexes = port.query_apex_batch(queries, dims=dims).numpy()
    row = float(np.sqrt((port.table.numpy() ** 2).sum(axis=1).max()))
    return 4 * EPS32 * (row + float(np.sqrt((apexes**2).sum(axis=1).max())))


def _same_knn(got, want, wtol):
    assert len(got) == len(want)
    for (gi, gd, gs), (wi, wd, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-12, atol=1e-12)
        assert _stats(gs) == _stats(ws)
        assert abs(gs.bound_width - ws.bound_width) <= wtol


def _same_range(got, want, wtol):
    assert len(got) == len(want)
    for (gi, gs), (wi, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert _stats(gs) == _stats(ws)
        assert abs(gs.bound_width - ws.bound_width) <= wtol


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("refine", [K, 16, 100])
@pytest.mark.parametrize("dims", [2, N_PIVOTS // 2, N_PIVOTS])
def test_knn_approx_batch(trio, dims, refine, masked):
    port, ref, queries = trio
    mask = _mask(masked)
    n_live = N if mask is None else int(mask.sum())
    _assert_mid_gap(port, queries, dims, min(max(refine, K), n_live), mask)
    want = ref.knn_approx_batch(queries, K, dims=dims, refine=refine, rowmask=mask)
    got = port.knn_approx_batch(queries, K, dims=dims, refine=refine, rowmask=mask)
    _same_knn(got, want, _width_tol(port, queries, dims))
    assert all(s.original_calls == dims + max(refine, K) for _, _, s in got)
    if mask is not None:
        assert all(mask[ids].all() for ids, _, _ in got)


def _thresholds(port, queries):
    """Per query, halfway between its 20th and 21st true distances."""
    out = []
    for q in queries:
        d = np.sort(port.metric.one_to_many(torch.as_tensor(q), port.data).numpy())
        out.append(0.5 * (d[19] + d[20]))
    return np.asarray(out)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("refine", [K, 16, 100])
@pytest.mark.parametrize("dims", [2, N_PIVOTS // 2, N_PIVOTS])
def test_search_approx_batch(trio, dims, refine, masked):
    port, ref, queries = trio
    mask = _mask(masked)
    t = _thresholds(port, queries)
    _assert_range_margins(port, queries, t, dims, refine, mask)
    want = ref.search_approx_batch(queries, t, dims=dims, refine=refine, rowmask=mask)
    got = port.search_approx_batch(queries, t, dims=dims, refine=refine, rowmask=mask)
    _same_range(got, want, _width_tol(port, queries, dims))
    scalar = float(np.median(t))
    _assert_range_margins(port, queries, np.full(Q, scalar), dims, refine, mask)
    want = ref.search_approx_batch(queries, scalar, dims=dims, refine=refine, rowmask=mask)
    _same_range(port.search_approx_batch(queries, scalar, dims=dims, refine=refine, rowmask=mask),
                want, _width_tol(port, queries, dims))


def test_single_query_and_qpd(trio):
    port, ref, queries = trio
    dims, wtol = 5, _width_tol(port, queries, 5)
    qpd = ref.metric.cross_np(queries, ref.pivot_rows(dims))
    _assert_mid_gap(port, queries, dims, 16, None)
    want = ref.knn_approx_batch(queries, K, dims=dims, refine=16, qpd=qpd)
    got = port.knn_approx_batch(queries, K, dims=dims, refine=16, qpd=qpd)
    _same_knn(got, want, wtol)
    assert all(s.original_calls == 16 for _, _, s in got)       # qpd charges no pivot calls
    for qi in range(3):
        _same_knn([port.knn_approx(queries[qi], K, dims=dims, refine=16)],
                  [ref.knn_approx(queries[qi], K, dims=dims, refine=16)], wtol)
        _same_knn([port.knn_approx(queries[qi], K, dims=dims, refine=16, qpd=qpd[qi])],
                  [ref.knn_approx(queries[qi], K, dims=dims, refine=16, qpd=qpd[qi])], wtol)
    t = _thresholds(port, queries)
    _assert_range_margins(port, queries, t, dims, 16, None)
    for qi in range(3):
        _same_range([port.search_approx(queries[qi], t[qi], dims=dims, refine=16, qpd=qpd[qi])],
                    [ref.search_approx(queries[qi], t[qi], dims=dims, refine=16, qpd=qpd[qi])], wtol)


@pytest.mark.parametrize("dims", [2, 7, N_PIVOTS])
def test_truncated_table(trio, dims):
    port, ref, _ = trio
    back = NSimplexIndex.from_state(ref.state_arrays(), port.metric, device="cpu")
    np.testing.assert_allclose(back.truncated_table(dims).numpy(), ref.truncated_table(dims), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        port.truncated_table(1)


def test_k_zero_and_empty_mask(trio):
    port, ref, queries = trio
    for kw in (dict(k=0), dict(k=K, rowmask=np.zeros(N, bool))):
        k = kw.pop("k")
        got = port.knn_approx_batch(queries, k, dims=4, refine=16, **kw)
        want = ref.knn_approx_batch(queries, k, dims=4, refine=16, **kw)
        for (gi, _, gs), (wi, _, ws) in zip(got, want):
            assert gi.size == wi.size == 0 and _stats(gs) == _stats(ws)


@pytest.fixture(scope="module")
def big():
    """N > 4096, so a refine budget above 4096 is a K2 selection wider than
    its shared-memory plans."""
    X = np.random.default_rng(11).normal(size=(4300 + 3, 12))
    data, queries = X[:4300], X[4300:]
    pivots = rselect(data, 8, seed=4)
    with enable_x64(True):
        ref = RIndex(data, pivots, rget("euclidean"), use_kernel=True)
    return NSimplexIndex(data, pivots, get_metric("euclidean"), device="cpu"), ref, queries


@pytest.mark.parametrize("masked", [False, True])
def test_refine_wider_than_k2_takes_the_host_route(big, masked, monkeypatch):
    """m > MAX_SELECT_WIDTH (the name is that of the route it once took):
    one K2 call at that width, as the reference; the candidate set, answers
    and ledger equal the reference's K2 run, and no query counts as an
    overflow query (neither package has a host route here)."""
    port, ref, queries = big
    mask = (np.arange(4300) % 50 != 0) if masked else None
    refine = MAX_SELECT_WIDTH + 100
    calls = []
    for name in ("apex_bounds_topk", "apex_bounds_batch"):
        fn = getattr(nsimplex_index, name)
        monkeypatch.setattr(nsimplex_index, name, lambda *a, _n=name, _f=fn, **k: (calls.append(_n), _f(*a, **k))[1])
    before = port.overflow_queries
    got = port.knn_approx_batch(queries, K, dims=4, refine=refine, rowmask=mask)
    assert port.overflow_queries == before
    assert calls == ["apex_bounds_topk"]
    want = ref.knn_approx_batch(queries, K, dims=4, refine=refine, rowmask=mask)
    apexes = port.query_apex_batch(queries, dims=4).numpy()
    wtol = 4 * EPS32 * (float(np.sqrt((port.table.numpy() ** 2).sum(axis=1).max()))
                        + float(np.sqrt((apexes**2).sum(axis=1).max())))
    _same_knn(got, want, wtol)
    assert all(s.candidates == min(refine, 4300 if mask is None else int(mask.sum())) for _, _, s in got)


class TestDecisionModule:
    """``index.approx``, the host control flow, equals the reference module."""

    def _bounds(self, seed):
        rng = np.random.default_rng(seed)
        true = rng.random(300)
        lwb = true - rng.random(300) * 0.2
        upb = true + rng.random(300) * 0.2
        dist = lambda rows: true[rows]  # noqa: E731
        return true, lwb, upb, dist

    @pytest.mark.parametrize("refine", [0, 5, 40, 1000])
    def test_search_decide(self, refine):
        _, lwb, upb, dist = self._bounds(refine)
        t = 0.4
        accepted = np.flatnonzero(upb <= t)
        straddle = np.flatnonzero((lwb <= t) & (upb > t))
        args = (dist, accepted, straddle, lwb[straddle], upb[straddle], t, refine)
        for g, w in zip(tapprox.approx_search_decide(*args), rapprox.approx_search_decide(*args)):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("k", [0, 12, 500])
    def test_knn_from_pairs(self, k):
        _, lwb, upb, dist = self._bounds(9 + k)
        ids = np.arange(0, 300, 3)
        for g, w in zip(tapprox.approx_knn_from_pairs(dist, ids, lwb[ids], upb[ids], k),
                        rapprox.approx_knn_from_pairs(dist, ids, lwb[ids], upb[ids], k)):
            np.testing.assert_array_equal(g, w)


# -- the API ------------------------------------------------------------------
@pytest.fixture(scope="module")
def api_pair():
    X = colors_like(n=1212, seed=31).astype(np.float64)
    data, queries = X[:1200], X[1200:]
    with enable_x64(True):
        ref = rapi.build_index(data, "jensen_shannon", n_pivots=12, seed=3, use_kernel=True,
                               apex_dims=6, refine=40)
    port = build_index(data, "jensen_shannon", n_pivots=12, seed=3, apex_dims=6, refine=40, device="cpu")
    return port, ref, data, queries


def _same_results(got, want, wtol, dists=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        if dists:
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-12, atol=1e-12)
        assert _stats(g.stats) == _stats(w.stats) and g.approx == w.approx
        assert abs(g.stats.bound_width - w.stats.bound_width) <= wtol


API_WTOL = 4 * EPS32 * 2.0          # JSD bounds of colors rows stay below 2


@pytest.mark.parametrize(
    "kw",
    [
        dict(task="knn", k=10),
        dict(task="knn", k=5, refine=17),
        dict(task="knn", k=5, dims=12),
        dict(task="knn", k=5, deny=(3, 1)),
        dict(task="range", threshold=0.12),
        dict(task="range", threshold=0.12, refine=3),
    ],
)
def test_apex_dims_index_answers_like_the_reference(api_pair, kw):
    port, ref, _, queries = api_pair
    spec, rspec = Query(**kw), rapi.Query(**kw)
    assert port.plan(spec).explain() == ref.plan(rspec).explain()
    assert port.plan(spec).mode == "approx"
    dists = kw["task"] == "knn"
    _same_results(list(port.query(queries, spec)), list(ref.query(queries, rspec)), API_WTOL, dists)
    _same_results([port.query(queries[0], spec)], [ref.query(queries[0], rspec)], API_WTOL, dists)


def test_auto_mode_cascade_and_overrides(api_pair):
    port, _, data, _ = api_pair
    p = port.plan(Query.knn(5))
    assert (p.mode, p.dims, p.refine) == ("approx", 6, 40)
    assert port.plan(Query.knn(5, mode="exact")).mode == "exact"
    assert port.plan(Query.knn(5, dims=4, refine=9)).approx_cfg == {"dims": 4, "refine": 9}
    exact = build_index(data[:300], "jensen_shannon", n_pivots=8, seed=2, device="cpu")
    assert exact.plan(Query.knn(5)).mode == "exact"
    p = exact.plan(Query.knn(5, mode="approx", dims=6))
    assert (p.mode, p.dims) == ("approx", 6)
    opts = build_index(data[:300], "jensen_shannon", n_pivots=8, seed=2, device="cpu",
                       query_options=QueryOptions(mode="approx", dims=5, refine=9))
    p = opts.plan(Query.knn(5))
    assert (p.mode, p.dims, p.refine) == ("approx", 5, 9)


@pytest.mark.parametrize(
    "kw",
    [dict(k=10, dims=4, budget=12), dict(k=10, dims=4, budget=10_000), dict(k=10, budget=12),
     dict(k=10, budget=10_000), dict(k=10)],
)
@pytest.mark.parametrize("apex_dims", [None, 4])
def test_budget_driven_plans_equal_the_reference(api_pair, kw, apex_dims):
    _, _, data, _ = api_pair
    extra = {} if apex_dims is None else dict(apex_dims=apex_dims)
    port = build_index(data[:400], "euclidean", n_pivots=8, seed=2, device="cpu", **extra)
    with enable_x64(True):
        ref = rapi.build_index(data[:400], "euclidean", n_pivots=8, seed=2, **extra)
    assert port.stats() == ref.stats()
    assert port.plan(Query.knn(**kw)).explain() == ref.plan(rapi.Query.knn(**kw)).explain()


def test_apex_dims_validation(api_pair):
    _, _, data, _ = api_pair
    with pytest.raises(ValueError, match="apex_dims"):
        build_index(data[:50], kind="tree", apex_dims=4, device="cpu")
    with pytest.raises(ValueError, match="apex_dims"):
        build_index(data[:50], n_pivots=8, apex_dims=9, device="cpu")
    with pytest.raises(ValueError, match="apex_dims"):
        build_index(data[:50], n_pivots=8, apex_dims=1, device="cpu")


def test_stats_carry_the_approx_keys(api_pair):
    port, ref, _, _ = api_pair
    st = port.stats()
    assert st == ref.stats()
    assert (st["apex_dims"], st["refine"], st["surrogate_bytes_per_object"]) == (6, 40, 48)


def test_save_load_both_ways_keeps_approx(api_pair, tmp_path):
    port, ref, _, queries = api_pair
    ref.save(tmp_path / "ref")
    port.save(tmp_path / "port")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    with enable_x64(True):
        from_port = rapi.load_index(tmp_path / "port")
    assert from_ref.approx == from_port.approx == {"dims": 6, "refine": 40}
    np.testing.assert_array_equal(from_ref.table.numpy(), ref.table)
    spec, rspec = Query.knn(10), rapi.Query.knn(10)
    _same_results(list(from_ref.query(queries, spec)), list(ref.query(queries, rspec)), API_WTOL)
    _same_results(list(from_port.query(queries, rspec)), list(port.query(queries, spec)), API_WTOL)
    back = load_index(tmp_path / "port", device="cpu")
    for g, w in zip(back.query(queries, spec), port.query(queries, spec)):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.distances, w.distances)
        assert g.stats.bound_width == w.stats.bound_width


@pytest.mark.parametrize("spec", [Query.knn(7), Query.knn(7, dims=4, refine=20), Query.range(0.12)])
def test_search_service_serves_approx_specs(api_pair, spec):
    port, _, _, queries = api_pair
    direct = port.query(queries, spec)
    with SearchService(port, max_batch=8, max_wait_s=0.05) as svc:
        svc.warmup(spec, queries[0])
        futures = [svc.submit(q, spec) for q in queries]
        results = [f.result(timeout=60) for f in futures]
    for r, w in zip(results, direct):
        assert r.approx is not None and r.approx == w.approx
        np.testing.assert_array_equal(r.ids, w.ids)
        if w.distances is not None:
            np.testing.assert_array_equal(r.distances, w.distances)
        assert _stats(r.stats) == _stats(w.stats) and r.stats.bound_width == w.stats.bound_width


# -- quality ------------------------------------------------------------------
@pytest.fixture(scope="module")
def quality_corpus():
    """``tests/test_quality.py``'s corpus: clustered colors histograms."""
    X = colors_like(n=1100, seed=5).astype(np.float64)
    return X[:1000], X[1000:1012]


@pytest.mark.parametrize("metric_name", ["euclidean", "cosine", "jensen_shannon"])
def test_recall_at_half_dims(quality_corpus, metric_name):
    """Recall@10 >= 0.95 at dims = n/2, refine = 100, n = 20 pivots."""
    data, queries = quality_corpus
    index = build_index(data, metric_name, n_pivots=20, seed=2, device="cpu")
    metric = rget(metric_name)
    hits = 0
    for q in queries:
        r = index.knn(q, 10, mode="approx", dims=10, refine=100)
        d = metric.one_to_many_np(q, data)
        oracle, _ = knn_select(d, np.arange(len(d), dtype=np.int64), 10)
        hits += len(np.intersect1d(r.ids, oracle))
    assert hits / (10 * len(queries)) >= 0.95
