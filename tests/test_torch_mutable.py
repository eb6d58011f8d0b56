"""The mutable composite in the port against the JAX package, on the CPU.

The same corpus, the same mutation sequence (add / remove / upsert, then
``compact``) and the same queries go through ``repro.api`` (built under
``enable_x64``; the n-simplex kind with ``use_kernel=True``, the algorithm
the port follows) and ``repro_torch.api`` on ``device="cpu"``.  Held, dirty
and after compaction: ids in (distance, id) order equal to the reference's
and to a fresh port build over the live rows, distances within 1e-12
(1e-9 against the fresh build, whose pivots differ), ``QueryStats`` counts
equal to the reference's.  Also: the append paths (``extended``) against
``apex_gemm_np`` within K4's error (2.8e-16), filtered queries on the
composite, read-view isolation, persistence both ways, and the repaired
allowlist scan on an index whose logical ids are not row positions.
"""

import numpy as np
import pytest
import torch

from repro.api import Query as RQuery, build_index as rbuild, load_index as rload
from repro.compat import enable_x64
from repro.core.simplex import apex_gemm_np
from repro.data import colors_like
from repro.filter import AttributeStore as RStore, Predicate as RPredicate
from repro.metrics import get_metric as rmetric
from repro_torch.api import MutableIndex, Query, SupportsMutation, build_index, load_index
from repro_torch.filter import AttributeStore, Predicate

torch.set_num_threads(1)

KINDS = ("nsimplex", "laesa", "tree")
BUILD_KW = dict(n_pivots=5, pivot_strategy="maxmin", seed=3)


def tie_heavy(n: int, seed: int, dim: int = 6) -> np.ndarray:
    """Duplicate-saturated data: coarse grid values, every row repeated."""
    rng = np.random.default_rng(seed)
    half = np.round(rng.uniform(0.05, 1.0, size=((n + 1) // 2, dim)), 1)
    return np.concatenate([half, half])[:n]


def smooth(n: int, seed: int) -> np.ndarray:
    return colors_like(n=n, seed=seed)


def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


def same(got, want, dists=True):
    np.testing.assert_array_equal(got.ids, want.ids)
    if dists and want.distances is not None:
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-12, atol=1e-12)
    assert _stats(got.stats) == _stats(want.stats)


def same_up_to_ulp_ties(got, want, tol, counts=True):
    """Port k-NN == reference k-NN where the two packages' distances
    separate the rows.  They agree within ``tol``, not bit for bit: numpy
    and torch sum in different orders (f64: 1e-12; Euclidean on an f32
    corpus refines in f32 in both packages: 1e-6 relative).  Rows whose
    distances agree within ``tol`` are a tie that each package breaks by its
    own last ulp, so they are compared as a set — but for the last group,
    which the k-th row may cut, where the equal distances say all.  The
    cost ledger is equal where ``counts``."""
    np.testing.assert_allclose(got.distances, want.distances, rtol=tol, atol=1e-12)
    assert len(got.ids) == len(want.ids)
    groups = np.concatenate([[0], np.cumsum(np.diff(want.distances) > tol * want.distances[1:] + 1e-12)])
    for g in np.unique(groups)[:-1]:
        assert set(got.ids[groups == g].tolist()) == set(want.ids[groups == g].tolist())
    assert not counts or _stats(got.stats) == _stats(want.stats)


def same_tree_shapes(port, ref) -> bool:
    """Whether every tree segment of the two composites has the same shape.
    On tie-heavy data the packages' distances differ in the last ulp, which
    can move a row across a hyperplane (the tree's shape, and from there its
    call counts, differ; its answers stay exact), as the cosine tree's do
    (ROADMAP queue 3)."""
    for a, b in ((port._base, ref._base), (port._delta_seg, ref._delta_seg)):
        if a is None or b is None:
            if a is not b:
                return False
            continue
        ta, tb = a._tree.to_arrays(), b._tree.to_arrays()
        if any(not np.array_equal(np.asarray(ta[key]), np.asarray(tb[key])) for key in tb):
            return False
    return True


def build_pair(data, metric, kind, **kw):
    port = build_index(data, metric, kind=kind, mutable=True, device="cpu", **kw)
    with enable_x64(True):
        ref = rbuild(data, metric, kind=kind, mutable=True, use_kernel=True, **kw)
    return port, ref


def apply_ops(indexes, oracle: dict, pool: np.ndarray, seed: int):
    """The reference suite's mixed mutation sequence, applied to every index
    in ``indexes``; ``oracle`` mirrors the logical rows (id -> row)."""
    rng = np.random.default_rng(seed)
    cursor = 0
    for round_ in range(6):
        live = sorted(oracle)
        op = ("add", "remove", "upsert", "add", "remove", "upsert")[round_]
        if op == "add":
            block = pool[cursor:cursor + 17]
            cursor += 17
            ids = [idx.add(block) for idx in indexes]
            assert all(np.array_equal(i, ids[0]) for i in ids)
            for i, r in zip(ids[0], block):
                oracle[int(i)] = r
        elif op == "remove" and len(live) > 40:
            victims = rng.choice(live, size=12, replace=False)
            for idx in indexes:
                idx.remove(victims)
            for v in victims:
                oracle.pop(int(v))
        elif op == "upsert":
            targets = rng.choice(live, size=7, replace=False)
            block = pool[cursor:cursor + 7]
            cursor += 7
            for idx in indexes:
                idx.upsert(targets, block)
            for i, r in zip(targets, block):
                oracle[int(i)] = r
    return oracle


def assert_equals_reference_and_fresh(port, ref, oracle, metric, kind, queries):
    live = np.array(sorted(oracle), dtype=np.int64)
    np.testing.assert_array_equal(port.ids(), live)
    logical = np.stack([oracle[int(i)] for i in live])
    np.testing.assert_array_equal(port.data.numpy(), logical)
    assert port.stats() == ref.stats()
    fresh = build_index(logical, metric, kind=kind, device="cpu", **BUILD_KW)
    tol = 1e-6 if (metric == "euclidean" and logical.dtype == np.float32) else 1e-12
    counts = kind != "tree" or same_tree_shapes(port, ref)
    for k in (1, 10, 100):
        got = port.knn_batch(queries, k)
        for g, w, q in zip(got, ref.knn_batch(queries, k), queries):
            same_up_to_ulp_ties(g, w, tol, counts)
            f = fresh.knn(q, k)
            np.testing.assert_array_equal(g.ids, live[f.ids])
            np.testing.assert_allclose(g.distances, f.distances, rtol=1e-9, atol=1e-12)
        same_up_to_ulp_ties(port.knn(queries[0], k), ref.knn(queries[0], k), tol, counts)
    d0 = rmetric(metric).one_to_many_np(queries[0], logical)
    for quantile in (0.02, 0.2):
        t = float(np.quantile(d0, quantile))
        got = port.search(queries[0], t)
        np.testing.assert_array_equal(got.ids, live[fresh.search(queries[0], t).ids])
        for g, w in zip([got] + list(port.search_batch(queries[:3], t)),
                        [ref.search(queries[0], t)] + list(ref.search_batch(queries[:3], t))):
            np.testing.assert_array_equal(g.ids, w.ids)
            assert not counts or _stats(g.stats) == _stats(w.stats)


HARNESS = [(kind, "euclidean", data_fn) for kind in KINDS for data_fn in (tie_heavy, smooth)]
HARNESS.append(("nsimplex", "jensen_shannon", smooth))


@pytest.mark.parametrize("kind, metric, data_fn", HARNESS,
                         ids=[f"{k}-{m}-{f.__name__}" for k, m, f in HARNESS])
def test_mutation_sequence_equals_reference(kind, metric, data_fn):
    seed = 11 if data_fn is tie_heavy else 13
    data = data_fn(200, seed)
    pool = data_fn(320, seed + 1)
    queries = np.concatenate([data_fn(5, seed + 2), data[:3]])     # with exact duplicates
    port, ref = build_pair(data, metric, kind, compact_threshold=None, **BUILD_KW)
    assert isinstance(port, SupportsMutation) and isinstance(port, MutableIndex)
    oracle = apply_ops([port, ref], {i: r for i, r in enumerate(data)}, pool, seed + 3)
    assert_equals_reference_and_fresh(port, ref, oracle, metric, kind, queries)
    port.compact()
    ref.compact()
    assert port.stats()["delta_rows"] == 0 and port.stats()["tombstones"] == 0
    assert_equals_reference_and_fresh(port, ref, oracle, metric, kind, queries)


@pytest.mark.parametrize("metric", ("euclidean", "jensen_shannon"))
@pytest.mark.parametrize("kind", ("nsimplex", "laesa"))
def test_extended_appends_without_refit(kind, metric):
    """``extended`` is functional: existing table rows carry over bit for
    bit, ``self`` is untouched, and each new row's entry is what a fresh
    build computes for it — for the apex table, ``apex_gemm_np`` on the
    fitted factors within K4's error (2.8e-16; the head coordinates, and the
    altitude squared)."""
    X, new = colors_like(n=300, seed=5), colors_like(n=40, seed=6)
    idx = build_index(X, metric, kind=kind, n_pivots=8, seed=3, device="cpu")
    inner = idx._inner
    before = inner.table.clone()
    ext = inner.extended(new)
    assert ext is not inner and inner.table.shape[0] == 300 and torch.equal(inner.table, before)
    assert torch.equal(ext.table[:300], before) and ext.table.shape[0] == 340
    np.testing.assert_array_equal(ext.data.numpy(), np.concatenate([X, new]))
    assert inner.extended(new[:0]) is inner
    if kind == "nsimplex":
        proj = inner.projector
        want = apex_gemm_np(proj.Linv, proj.sq_norms, proj.pivot_distances(torch.as_tensor(new)).numpy())
        got = ext.table[300:].numpy()
        np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=0, atol=2.8e-16)
        np.testing.assert_allclose(got[:, -1] ** 2, want[:, -1] ** 2, rtol=0, atol=2.8e-16)
        fresh = proj(torch.as_tensor(np.concatenate([X, new])))
        assert torch.equal(ext.table, fresh)
    else:
        want = rmetric(metric).cross_np(new, inner.pivots)
        np.testing.assert_allclose(ext.table[300:].numpy(), want, rtol=1e-12, atol=1e-12)
    # the segment-level append is functional too, and queries answer over
    # the combined rows as a fresh segment does
    seg = idx.extend(new)
    q = colors_like(n=3, seed=7)
    fresh = idx.spawn(np.concatenate([X, new]))
    for g, w in zip(seg.knn_batch(q, 10), fresh.knn_batch(q, 10)):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert _stats(g.stats) == _stats(w.stats)


def test_query_pivot_distances_equal_reference():
    X = colors_like(n=200, seed=5)
    q = colors_like(n=4, seed=8)
    for kind in ("nsimplex", "laesa"):
        port, ref = build_pair(X, "jensen_shannon", kind, **BUILD_KW)
        for cfg in (None, {"dims": 3, "refine": 8}):
            np.testing.assert_allclose(port.query_pivot_distances(q, cfg).numpy(),
                                       ref.query_pivot_distances(q, cfg), rtol=1e-12, atol=1e-12)


# -- filtered queries on the composite (the reference's tests/test_filter.py) -
DIM, N = 12, 300
SCHEMA = {"bucket": "int", "price": "float", "flag": "bool", "color": "categorical"}
PREDICATES = {
    "1.0": Predicate.between("bucket", lo=-1),
    "0.5": Predicate.between("bucket", lo=0, hi=49),
    "0.1": Predicate.isin("bucket", range(10)),
    "0.01": Predicate.eq("bucket", 7),
    "0.0": Predicate.eq("bucket", 777),
}
MODES = (None, "prefilter", "pushdown", "postfilter")


def _attrs_for(ids):
    ids = np.asarray(ids, dtype=np.int64)
    return {
        "bucket": ids % 100,
        "price": (ids % 17).astype(np.float64) / 17.0,
        "flag": ids % 2 == 0,
        "color": np.asarray(["red", "green", "blue"])[ids % 3],
    }


def rquery(spec: Query) -> RQuery:
    kw = {f: getattr(spec, f) for f in ("task", "k", "threshold", "mode", "dims", "refine", "allow", "deny",
                                         "budget", "filter_mode")}
    kw["where"] = None if spec.where is None else RPredicate.from_dict(spec.where.to_dict())
    return RQuery(**kw)


def filtered_pair(kind):
    X = np.random.default_rng(11).normal(size=(N, DIM))
    ids = np.arange(N, dtype=np.int64)
    stores = AttributeStore(SCHEMA), RStore(SCHEMA)
    for s in stores:
        s.put(ids, _attrs_for(ids))
    port = build_index(X, kind=kind, n_pivots=8, mutable=True, seed=3, attributes=stores[0], device="cpu")
    with enable_x64(True):
        ref = rbuild(X, kind=kind, n_pivots=8, mutable=True, seed=3, attributes=stores[1], use_kernel=True)
    return port, ref, {int(i): X[i] for i in ids}


def mutate(indexes, vecs):
    """Add / remove / upsert rows with attributes; keep ``vecs`` current."""
    rng = np.random.default_rng(77)
    new_ids = np.arange(N, N + 40, dtype=np.int64)
    new_rows = rng.normal(size=(40, DIM))
    gone = np.array([5, 107, 211, N + 3], dtype=np.int64)
    up_ids = np.array([8, 42, N + 10], dtype=np.int64)
    up_rows = rng.normal(size=(3, DIM))
    for idx in indexes:
        idx.add(new_rows, ids=new_ids, attrs=_attrs_for(new_ids))
        idx.remove(gone)
        idx.upsert(up_ids, up_rows, attrs=_attrs_for(up_ids))
    vecs.update({int(i): r for i, r in zip(new_ids, new_rows)})
    for i in gone:
        vecs.pop(int(i))
    vecs.update({int(i): r for i, r in zip(up_ids, up_rows)})


def brute_knn(vecs, match, q, k):
    match = np.intersect1d(match, np.fromiter(vecs, dtype=np.int64))
    if not len(match):
        return np.empty(0, dtype=np.int64)
    d = np.sqrt(((np.stack([vecs[int(i)] for i in match]) - q) ** 2).sum(axis=1))
    return match[np.lexsort((match, d))[:k]]


def assert_all_selectivities(port, ref, vecs, seed=3):
    q = np.random.default_rng(seed).normal(size=(2, DIM))
    for pred in PREDICATES.values():
        for mode in MODES:
            spec = Query(task="knn", k=10, where=pred, filter_mode=mode)
            assert port.plan(spec).explain() == ref.plan(rquery(spec)).explain()
            for qi, (g, w) in enumerate(zip(port.query(q, spec), ref.query(q, rquery(spec)))):
                same(g, w)
                np.testing.assert_array_equal(g.ids, brute_knn(vecs, port.attributes.match(pred), q[qi], 10))
            same(port.query(q[0], spec), ref.query(q[0], rquery(spec)))
    spec = Query(task="range", threshold=4.5, where=PREDICATES["0.5"])
    for mode in MODES:
        spec = Query(task="range", threshold=4.5, where=PREDICATES["0.5"], filter_mode=mode)
        for g, w in zip(port.query(q, spec), ref.query(q, rquery(spec))):
            same(g, w)


@pytest.mark.parametrize("compacted", (False, True), ids=("dirty", "compacted"))
@pytest.mark.parametrize("kind", ("laesa", "nsimplex"))
def test_filtered_queries_after_mutations(kind, compacted):
    port, ref, vecs = filtered_pair(kind)
    mutate([port, ref], vecs)
    if compacted:
        port.compact()
        ref.compact()
    assert_all_selectivities(port, ref, vecs)


@pytest.mark.parametrize("kind", ("laesa", "nsimplex"))
def test_sugar_on_mutable_composite(kind):
    port, ref, vecs = filtered_pair(kind)
    mutate([port, ref], vecs)
    live = port.ids()
    rng = np.random.default_rng(59)
    allow = rng.choice(live, size=20, replace=False).astype(np.int64)
    deny = np.setdiff1d(live, allow)[:15]
    q = rng.normal(size=DIM)
    for legacy, sugar in ((Query.knn(10, allow=tuple(allow.tolist())), Query.knn(10, where=Predicate.ids(allow))),
                          (Query.knn(10, deny=tuple(deny.tolist())),
                           Query.knn(10, where=Predicate.exclude_ids(deny)))):
        a, b = port.query(q, legacy), port.query(q, sugar)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.distances, b.distances)
        same(a, ref.query(q, rquery(legacy)))


@pytest.mark.parametrize("kind", ("laesa", "nsimplex"))
def test_allow_direct_maps_logical_ids_to_rows(kind):
    """The allowlist scan maps logical ids to rows through the index's live
    view: after removes (logical id != row position), with ids that are
    removed, never existed or were added, it answers as the reference and as
    a brute force over the listed live rows.  Taking the ids as positions,
    as the scan did before, reads the wrong rows here."""
    port, ref, vecs = filtered_pair(kind)
    mutate([port, ref], vecs)
    port.compact()
    ref.compact()
    port.remove([0, 1, 2])
    ref.remove([0, 1, 2])
    for i in (0, 1, 2):
        vecs.pop(i)
    allow = np.array([1, 9, 100, 107, 250, 299, N + 5, N + 39, N + 41, 5000], dtype=np.int64)
    q = np.random.default_rng(3).normal(size=(3, DIM))
    live_allowed = np.intersect1d(allow, np.fromiter(vecs, dtype=np.int64))
    assert not np.array_equal(np.searchsorted(port.ids(), live_allowed), live_allowed)   # ids are not positions
    for spec in (Query.knn(4, allow=tuple(allow.tolist())), Query.range(4.0, allow=tuple(allow.tolist())),
                 Query.knn(20, allow=tuple(allow.tolist()))):
        for qi, (g, w) in enumerate(zip(port.query(q, spec), ref.query(q, rquery(spec)))):
            same(g, w)
            if spec.task == "knn":
                np.testing.assert_array_equal(g.ids, brute_knn(vecs, live_allowed, q[qi], spec.k))
            assert set(g.ids.tolist()) <= set(live_allowed.tolist())


def test_read_view_isolation():
    """A read view answers as the index did when it was taken, while the
    index adds, removes, upserts and compacts; a frozen copy compacts
    without touching the live index."""
    port, ref, vecs = filtered_pair("nsimplex")
    q = np.random.default_rng(5).normal(size=(3, DIM))
    specs = [Query.knn(10), Query.range(4.0), Query.knn(10, where=PREDICATES["0.5"], filter_mode="pushdown")]
    view = port.read_view()
    before = [port.query(q, s) for s in specs]
    mutate([port], dict(vecs))
    port.compact()
    port.add(np.random.default_rng(9).normal(size=(5, DIM)), attrs=_attrs_for(np.arange(N + 40, N + 45)))
    for s, b in zip(specs, before):
        for g, w in zip(view.query(q, s), b):
            same(g, w)
    assert view.stats()["n_objects"] == N and view.attributes is not None
    frozen = port.frozen_copy()
    n_live = port.stats()["n_objects"]
    frozen.remove([10])
    frozen.compact()
    assert port.stats()["n_objects"] == n_live and port.has_id(10)
    assert frozen.stats()["n_objects"] == n_live - 1


class TestMutationSemantics:
    @pytest.fixture()
    def idx(self):
        data = colors_like(n=300, seed=5)
        return build_index(data, "euclidean", mutable=True, compact_threshold=None, device="cpu", **BUILD_KW), data

    def test_ids_and_errors(self, idx):
        index, data = idx
        np.testing.assert_array_equal(index.add(colors_like(n=5, seed=6)), np.arange(300, 305))
        with pytest.raises(KeyError, match="999"):
            index.remove(999)
        index.remove(7)
        with pytest.raises(KeyError, match="7"):
            index.remove(7)
        with pytest.raises(KeyError, match="upsert"):
            index.add(colors_like(n=1, seed=7), ids=[3])
        with pytest.raises(ValueError, match="duplicate"):
            index.add(colors_like(n=2, seed=7), ids=[500, 500])
        with pytest.raises(ValueError, match="need 3 ids"):
            index.upsert([1, 2], colors_like(n=3, seed=7))
        assert index.has_id(1) and index.has_id(2) and not index.has_id(500)
        with pytest.raises(ValueError, match="finite"):
            index.add(np.full((1, data.shape[1]), np.nan))
        with pytest.raises(ValueError, match="rows must be"):
            index.add(np.zeros((1, 3)))
        with pytest.raises(ValueError, match="attribute store"):
            index.add(colors_like(n=1, seed=7), attrs={"x": [1]})

    def test_upsert_and_remove_all(self, idx):
        index, data = idx
        row = colors_like(n=2, seed=8)
        index.upsert([3, 900], row)
        res = index.knn(row[0], 1)
        assert res.ids[0] == 3 and res.distances[0] == 0.0 and index.has_id(900)
        index.remove(index.ids())
        assert index.stats()["n_objects"] == 0
        assert len(index.knn(data[0], 5)) == 0 and len(index.search(data[0], 10.0)) == 0
        index.add(data[:10])
        np.testing.assert_array_equal(index.knn(data[3], 1).ids, [904])

    def test_compaction_is_deferred_and_keeps_ids(self):
        data = colors_like(n=200, seed=9)
        index = build_index(data, "euclidean", mutable=True, compact_threshold=0.25, device="cpu", **BUILD_KW)
        index.add(colors_like(n=80, seed=10))
        st = index.stats()
        assert st["pending_compaction"] and st["delta_rows"] == 80 and st["generation"] == 0
        index.remove(np.arange(0, 50))
        before, r_before = index.ids(), index.knn(data[100], 10)
        index.compact()
        st = index.stats()
        assert not st["pending_compaction"] and st["delta_rows"] == 0 and st["tombstones"] == 0
        assert st["base_rows"] == 230 and st["generation"] == 1 and st["compactions"] == 1
        np.testing.assert_array_equal(index.ids(), before)
        r_after = index.knn(data[100], 10)
        np.testing.assert_array_equal(r_before.ids, r_after.ids)
        np.testing.assert_array_equal(r_before.distances, r_after.distances)
        out = index.fit(colors_like(n=120, seed=13))
        assert out is index and np.array_equal(index.ids(), np.arange(120))
        assert index.stats()["delta_rows"] == 0 and index.stats()["generation"] == 2


@pytest.mark.parametrize("kind", KINDS)
def test_persistence_round_trips_both_ways(kind, tmp_path):
    """A dirty mutable index (delta, tombstones, attributes) saved by either
    package loads in the other and answers the same, filtered queries too;
    a reloaded index keeps mutating with the same next id."""
    port, ref, vecs = filtered_pair(kind)
    mutate([port, ref], vecs)
    port.save(tmp_path / "port")
    ref.save(tmp_path / "ref")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    from_port_self = load_index(tmp_path / "port", device="cpu")
    with enable_x64(True):
        from_port = rload(tmp_path / "port")
    assert type(from_ref) is MutableIndex and from_ref.attributes is not None
    np.testing.assert_array_equal(from_ref.ids(), ref.ids())
    q = np.random.default_rng(17).normal(size=(3, DIM))
    for spec in (Query.knn(9), Query.knn(10, where=PREDICATES["0.5"], filter_mode="pushdown")):
        want = ref.query(q, rquery(spec))
        for got in (from_ref.query(q, spec), from_port_self.query(q, spec), port.query(q, spec)):
            for g, w in zip(got, want):
                same(g, w)
        for g, w in zip(from_port.query(q, rquery(spec)), want):
            same(g, w)
    assert from_ref.stats() == from_port.stats()
    assert from_port_self.add(np.zeros((1, DIM)))[0] == port._next_id


def test_load_never_remeasures(tmp_path, monkeypatch):
    data = colors_like(n=110, seed=19)
    idx = build_index(data, "jensen_shannon", kind="nsimplex", mutable=True, device="cpu", **BUILD_KW)
    idx.add(colors_like(n=12, seed=20))
    idx.remove([3, 4, 5])
    idx.save(tmp_path / "jm.idx")
    from repro_torch.metrics import JensenShannonMetric

    def boom(*a, **k):
        raise AssertionError("metric evaluated during load")

    monkeypatch.setattr(JensenShannonMetric, "cross", boom)
    monkeypatch.setattr(JensenShannonMetric, "one_to_many", boom)
    loaded = load_index(tmp_path / "jm.idx", device="cpu")
    np.testing.assert_array_equal(loaded.ids(), idx.ids())


def test_mutable_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    data = colors_like(n=60, seed=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(data, n_pivots=4, mutable=True)
    build_index(data, n_pivots=4, mutable=True, device="cpu").save(tmp_path / "m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(tmp_path / "m")
