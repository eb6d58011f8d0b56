"""The port's ``ExactSearchEngine`` (all five mechanisms), ``NSimplexRetriever``
and the ``laesa`` / ``tree`` kinds behind the unified API, against the JAX
package's, on the CPU.

The reference engine is built with ``use_kernel=True``: the port's N_seq
always scans through its kernels (or their plain versions on the CPU), and
its counts follow that algorithm.  The reference's default
``use_kernel=False`` run gives the same answers, but its range counts may
differ by the rows inside the f32 slack band, which the kernel path
rechecks and the host path decides in f64 (``test_n_seq_host_path``).
Values that are 0 only up to rounding under a sqrt (a pivot row's apex
altitude, the cosine chord of a row with itself; ~1e-8) are compared
squared.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.compat import enable_x64
from repro.data import colors_like
from repro.metrics import get_metric as rget
from repro.search.engine import ExactSearchEngine as REngine
from repro.search.retrieval import NSimplexRetriever as RRetriever
from repro_torch.api import Query, build_index, load_index
from repro_torch.search import MECHANISMS, ExactSearchEngine, NSimplexRetriever

# small shapes: one intra-op thread keeps these tests from crowding the
# other pytest workers
torch.set_num_threads(1)

N, Q, DIM, N_PIVOTS, LEAF, SEED = 1000, 6, 24, 10, 16, 3
F64 = dict(rtol=1e-12, atol=1e-12)


def _counts(r):
    return (r.original_calls, r.surrogate_calls, r.accepted_no_check)


@pytest.fixture(scope="module")
def corpus():
    X = colors_like(n=N + Q, dim=DIM, seed=23).astype(np.float64)
    return X[:N], X[N:]


def _threshold(rm, data, q, rank=40):
    d = np.sort(rm.one_to_many_np(q, data))
    return float(0.5 * (d[rank] + d[rank + 1]))


@pytest.fixture(scope="module", params=["euclidean", "jensen_shannon"])
def engines(request, corpus):
    data, queries = corpus
    name = request.param
    with enable_x64(True):
        ref = REngine(data, rget(name), n_pivots=N_PIVOTS, leaf_size=LEAF, seed=SEED, use_kernel=True)
    port = ExactSearchEngine(data, name, n_pivots=N_PIVOTS, leaf_size=LEAF, seed=SEED, device="cpu")
    return name, port, ref, queries, _threshold(rget(name), data, queries[0])


@pytest.mark.parametrize("mechanism", MECHANISMS)
def test_engine_equals_reference(engines, mechanism):
    _, port, ref, queries, t = engines
    with enable_x64(True):
        want = ref.search_batch(mechanism, queries, t) + [ref.search(mechanism, queries[0], t)]
        for k in (1, 10, 100):
            want += ref.knn_batch(mechanism, queries, k) + [ref.knn(mechanism, queries[0], k)]
    got = port.search_batch(mechanism, queries, t) + [port.search(mechanism, queries[0], t)]
    for k in (1, 10, 100):
        got += port.knn_batch(mechanism, queries, k) + [port.knn(mechanism, queries[0], k)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.results, w.results)
        if w.distances is not None:
            np.testing.assert_allclose(g.distances, w.distances, **F64)
        assert _counts(g) == _counts(w)


def test_brute_force_oracles_equal_reference(engines):
    _, port, ref, queries, t = engines
    with enable_x64(True):
        want_rng = ref.brute_force_batch(queries, t)
        want_knn = ref.knn_brute_batch(queries, 10)
    for g, w in zip(port.brute_force_batch(queries, t), want_rng):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port.brute_force(queries[0], t), want_rng[0])
    for (gi, gd), (wi, wd) in zip(port.knn_brute_batch(queries, 10), want_knn):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, **F64)


def test_engine_structures_equal_reference(engines):
    """All three trees have the reference's shape, and the tables agree.
    The N_rei tree's radii and pivot gaps are distances between apex rows,
    which carry a pivot row's ~1e-8 altitude: they agree within 1e-7."""
    _, port, ref, *_ = engines
    for mech in ("L_rei", "N_rei", "tree"):
        got, want = port.trees[mech].to_arrays(), ref.trees[mech].to_arrays()
        tol = dict(rtol=0, atol=1e-7) if mech == "N_rei" else F64
        for key, w in want.items():
            if w.dtype == np.int64:
                np.testing.assert_array_equal(got[key], w, err_msg=f"{mech} {key}")
            else:
                np.testing.assert_allclose(got[key], w, err_msg=f"{mech} {key}", **tol)
    np.testing.assert_allclose(port.laesa.table.numpy(), ref.laesa.table, **F64)
    np.testing.assert_allclose(port.nsimplex.table.numpy() ** 2, ref.nsimplex.table**2, **F64)
    assert sorted(port.build_s) == sorted(MECHANISMS)
    assert sorted(port.indexes) == ["L_seq", "N_seq", "tree"]


def test_n_seq_host_path(corpus):
    """The reference's host path (``use_kernel=False``) answers as the
    port's kernel path; at this seed its k-NN counts are equal and one range
    query counts one metric call fewer (a row the host path admits in f64,
    which the kernel path's f32 slack sends to a recheck)."""
    data, queries = corpus
    rm = rget("euclidean")
    t = _threshold(rm, data, queries[0])
    with enable_x64(True):
        ref = REngine(data, rm, n_pivots=N_PIVOTS, seed=SEED, mechanisms=("N_seq",))
        want = ref.knn_batch("N_seq", queries, 10) + ref.search_batch("N_seq", queries, t)
    port = ExactSearchEngine(data, "euclidean", n_pivots=N_PIVOTS, seed=SEED, mechanisms=("N_seq",), device="cpu")
    got = port.knn_batch("N_seq", queries, 10) + port.search_batch("N_seq", queries, t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.results, w.results)
    assert [_counts(g) for g in got[:Q]] == [_counts(w) for w in want[:Q]]
    assert sum(g.original_calls - w.original_calls for g, w in zip(got[Q:], want[Q:])) == 1


def test_engine_rejects_unbuilt_and_unknown_mechanisms(corpus):
    data, queries = corpus
    eng = ExactSearchEngine(data[:200], "euclidean", n_pivots=4, mechanisms=("tree",), device="cpu")
    assert eng.laesa is None and eng.nsimplex is None
    with pytest.raises(KeyError, match="was not built"):
        eng.knn("L_seq", queries[0], 3)
    with pytest.raises(KeyError, match="unknown mechanism"):
        eng.search("L_tree", queries[0], 0.1)


def test_retriever_equals_reference():
    X = np.random.default_rng(8).normal(size=(1004, 16))
    items, queries = X[:1000], X[1000:]
    with enable_x64(True):
        ref = RRetriever(items, metric="cosine", n_pivots=10, seed=1)
    port = NSimplexRetriever(items, metric="cosine", n_pivots=10, seed=1, device="cpu")
    np.testing.assert_allclose(port.table.numpy() ** 2, ref.table**2, **F64)
    for q in queries:
        with enable_x64(True):
            wi, wd, ws = ref.top_k(q, 10)
            bi, bd = ref.brute_force_top_k(q, 10)
        gi, gd, gs = port.top_k(q, 10)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, **F64)
        assert dataclasses.astuple(gs) == dataclasses.astuple(ws)
        pi, pd = port.brute_force_top_k(q, 10)
        np.testing.assert_array_equal(pi, bi)
        np.testing.assert_array_equal(gi, pi)


# -- the laesa and tree kinds behind the unified API -------------------------
@pytest.fixture(scope="module", params=[("laesa", {}), ("L_seq", {}), ("laesa", {"apex_dims": 4}), ("tree", {})],
                ids=["laesa", "L_seq", "laesa-apex_dims", "tree"])
def api_pair(request, corpus):
    data, queries = corpus
    kind, extra = request.param
    kw = dict(kind=kind, n_pivots=N_PIVOTS, seed=SEED, leaf_size=LEAF, **extra)
    with enable_x64(True):
        ref = rapi.build_index(data, "jensen_shannon", **kw)
    port = build_index(data, "jensen_shannon", device="cpu", **kw)
    return port, ref, queries, _threshold(rget("jensen_shannon"), data, queries[0])


PLAN_QUERIES = [
    dict(task="knn", k=10),
    dict(task="range", threshold=0.1),
    dict(task="range", threshold=(0.1, 0.2)),
    dict(task="knn", k=5, mode="exact"),
    dict(task="knn", k=5, budget=10),
    dict(task="knn", k=5, budget=10_000),
    dict(task="knn", k=5, mode="approx", dims=4),
    dict(task="range", threshold=0.1, mode="approx", dims=3, refine=7),
    dict(task="knn", k=5, deny=(3, 1)),
    dict(task="range", threshold=0.1, deny=(2,)),
    dict(task="knn", k=5, allow=(1, 2, 3)),
]


@pytest.mark.parametrize("kw", PLAN_QUERIES)
def test_plans_equal_reference(api_pair, kw):
    port, ref, *_ = api_pair
    try:
        want = ref.plan(rapi.Query(**kw)).explain()
    except ValueError as e:
        with pytest.raises(ValueError, match="truncatable"):
            port.plan(Query(**kw))
        assert "truncatable" in str(e)
        return
    assert port.plan(Query(**kw)).explain() == want


def test_stats_equal_reference(api_pair):
    port, ref, *_ = api_pair
    assert port.stats() == ref.stats()


def test_queries_and_id_filters_equal_reference(api_pair):
    """Exact queries (``mode="exact"`` also on the ``apex_dims`` build)
    through the executor, with allow and deny lists."""
    port, ref, queries, t = api_pair
    for spec_kw in (dict(), dict(deny=(5, 6, 7)), dict(allow=(4, 9, 17, 1500))):
        for task in ("knn", "range"):
            spec = Query.knn(10, mode="exact", **spec_kw) if task == "knn" else Query.range(t, mode="exact", **spec_kw)
            rspec = rapi.Query(task=spec.task, k=spec.k, threshold=spec.threshold, mode="exact", **spec_kw)
            with enable_x64(True):
                want = list(ref.query(queries, rspec))
            for g, w in zip(port.query(queries, spec), want):
                np.testing.assert_array_equal(g.ids, w.ids)
                assert dataclasses.astuple(g.stats)[:4] == dataclasses.astuple(w.stats)[:4]


def test_cross_load_both_ways(api_pair, tmp_path):
    port, ref, queries, t = api_pair
    ref.save(tmp_path / "ref")
    port.save(tmp_path / "port")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    with enable_x64(True):
        from_port = rapi.load_index(tmp_path / "port")
        assert from_ref.stats() == rapi.load_index(tmp_path / "ref").stats()
    for spec, rspec in ((Query.knn(10, mode="exact"), rapi.Query.knn(10, mode="exact")),
                        (Query.range(t, mode="exact"), rapi.Query.range(t, mode="exact"))):
        with enable_x64(True):
            want_ref = list(ref.query(queries, rspec))
            got_back = list(from_port.query(queries, rspec))
        for g, w in zip(from_ref.query(queries, spec), want_ref):
            np.testing.assert_array_equal(g.ids, w.ids)
            assert dataclasses.astuple(g.stats)[:4] == dataclasses.astuple(w.stats)[:4]
        for g, w in zip(got_back, port.query(queries, spec)):
            np.testing.assert_array_equal(g.ids, w.ids)
    if port.kind == "laesa":
        np.testing.assert_array_equal(from_ref.table.numpy(), ref.table)
        np.testing.assert_array_equal(from_port.table, port.table.numpy())


def test_new_kinds_default_to_cuda(corpus, tmp_path):
    data, _ = corpus
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    build_index(data[:100], n_pivots=4, kind="laesa", device="cpu").save(tmp_path / "laesa")
    for kind in ("laesa", "L_seq", "tree"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_index(data[:100], n_pivots=4, kind=kind)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(tmp_path / "laesa")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExactSearchEngine(data[:100], "euclidean", n_pivots=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NSimplexRetriever(data[:100], n_pivots=4)


def test_unknown_and_composite_kinds(corpus, tmp_path):
    data, _ = corpus
    with pytest.raises(ValueError, match="unknown index kind"):
        build_index(data[:50], kind="ball_tree", device="cpu")
    with enable_x64(True):
        ref = rapi.build_index(data[:100], n_pivots=4, shards=2, fanout_workers=0)
        ref.save(tmp_path / "sharded")
    # the sharded composite is ported: the reference's directory loads and
    # answers as the reference does
    port = load_index(tmp_path / "sharded", device="cpu")
    assert port.stats()["kind"] == "sharded" and port.stats()["n_shards"] == 2
    for g, w in zip(port.knn_batch(data[100:104], 5), ref.knn_batch(data[100:104], 5)):
        np.testing.assert_array_equal(g.ids, w.ids)
    # so is the durable composite: a reference snapshot reattaches to its
    # WAL and answers as the reference does
    with enable_x64(True):
        ref = rapi.build_index(data[:100], n_pivots=4, durable=True, wal_dir=str(tmp_path / "wal"), use_kernel=True)
        ref.add(data[100:110])
        ref.save(tmp_path / "durable")
    port = load_index(tmp_path / "durable", device="cpu")
    assert port.stats()["kind"] == "durable" and port.stats()["n_objects"] == 110
    with enable_x64(True):
        want = ref.knn_batch(data[110:114], 5)
    for g, w in zip(port.knn_batch(data[110:114], 5), want):
        np.testing.assert_array_equal(g.ids, w.ids)
    port.close()
    ref.close()
