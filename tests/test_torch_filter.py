"""Filtered search in the port against the JAX package, on the CPU.

The same corpus (numpy seed 0, 300 x 12 normal rows), the same attribute
columns and the same predicates go through ``repro.api`` (built under
``enable_x64``, the n-simplex kind with ``use_kernel=True``, the algorithm
the port follows) and ``repro_torch.api`` on ``device="cpu"``.  Held:

* exact filtered k-NN and range under every strategy (the planner's choice
  and each forced ``filter_mode``), kind and selectivity: ids and tie order
  equal to the reference's and to a brute force over exactly the matching
  rows, distances within 1e-12, ``QueryStats`` counts equal, and the plan's
  ``explain()`` equal to the reference's;
* approximate filtered k-NN sound (a subset of the matching rows), and a
  match-all predicate equal to the unfiltered approximate answer;
* the id sugar (``Predicate.ids`` / ``exclude_ids``) equal to the legacy
  ``allow`` / ``deny`` tuples, including k above the matching rows;
* attribute stores and indexes carrying them saved by either package and
  loaded by the other, answering the same;
* the planner's predicate strategy and stage equal to the reference's for
  forced and automatic choices, also at the chip smoke run's colors-1M
  stats and attribute columns.
"""

import jax
import numpy as np
import pytest
import torch

from repro.api import Query as RQuery, build_index as rbuild, load_index as rload, plan as rplan
from repro.compat import enable_x64
from repro.filter import AttributeStore as RStore, Predicate as RPredicate
from repro.metrics import get_metric
from repro_torch.api import Query, build_index, load_index, plan
from repro_torch.filter import AttributeStore, Predicate

torch.set_num_threads(1)

DIM, N, PIVOTS = 12, 300, 8
KINDS = ("nsimplex", "laesa", "tree")
MODES = (None, "prefilter", "pushdown", "postfilter")
SCHEMA = {"bucket": "int", "price": "float", "flag": "bool", "color": "categorical"}
METRIC = get_metric("euclidean")

#: label -> predicate at that selectivity over ``bucket = id % 100``
PREDICATES = {
    "1.0": Predicate.between("bucket", lo=-1),
    "0.5": Predicate.between("bucket", lo=0, hi=49),
    "0.1": Predicate.isin("bucket", range(10)),
    "0.01": Predicate.eq("bucket", 7),
    "0.0": Predicate.eq("bucket", 777),
}


def _vectors(n=N, seed=0):
    return np.random.default_rng(seed).normal(size=(n, DIM))


def _attrs_for(ids):
    ids = np.asarray(ids, dtype=np.int64)
    return {
        "bucket": ids % 100,
        "price": (ids % 17).astype(np.float64) / 17.0,
        "flag": ids % 2 == 0,
        "color": np.asarray(["red", "green", "blue"])[ids % 3],
    }


def _stores(ids):
    """The same rows in a port store and a reference store."""
    port, ref = AttributeStore(SCHEMA), RStore(SCHEMA)
    port.put(ids, _attrs_for(ids))
    ref.put(ids, _attrs_for(ids))
    return port, ref


def rquery(spec: Query) -> RQuery:
    """The reference's spelling of a port ``Query`` (same fields)."""
    kw = {f: getattr(spec, f) for f in ("task", "k", "threshold", "mode", "dims", "refine", "allow", "deny",
                                         "budget", "filter_mode")}
    kw["where"] = None if spec.where is None else RPredicate.from_dict(spec.where.to_dict())
    return RQuery(**kw)


def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


def same(got, want, dists=True):
    """Port result == reference result: ids in order, distances within
    1e-12, the cost ledger equal."""
    np.testing.assert_array_equal(got.ids, want.ids)
    if dists and want.distances is not None:
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-12, atol=1e-12)
    assert _stats(got.stats) == _stats(want.stats)


def _build_pair(X, kind, ids, **kw):
    port_store, ref_store = _stores(ids)
    port = build_index(X, kind=kind, n_pivots=PIVOTS, seed=3, attributes=port_store, device="cpu", **kw)
    if "shards" in kw:
        # the device filter on as many CPU positions as the reference's mesh
        # has devices (one, or four when a module forcing a 4-device host
        # platform was imported first): slot overflows follow them
        port.configure_grid([torch.device("cpu")] * jax.device_count())
    with enable_x64(True):
        ref = rbuild(X, kind=kind, n_pivots=PIVOTS, seed=3, attributes=ref_store, use_kernel=True, **kw)
    return port, ref


def brute_knn(X, match, q, k):
    if len(match) == 0:
        return np.empty(0, dtype=np.int64)
    d = METRIC.one_to_many_np(q, X[match])
    return match[np.lexsort((match, d))[:k]]


def brute_range(X, match, q, t):
    if len(match) == 0:
        return np.empty(0, dtype=np.int64)
    return match[METRIC.one_to_many_np(q, X[match]) <= t]


@pytest.fixture(scope="module", params=KINDS)
def plain(request):
    X = _vectors()
    port, ref = _build_pair(X, request.param, np.arange(N, dtype=np.int64))
    return port, ref, X


@pytest.mark.parametrize("sel", sorted(PREDICATES))
@pytest.mark.parametrize("mode", MODES, ids=[m or "auto" for m in MODES])
def test_knn_equals_reference_and_brute_force(plain, sel, mode):
    port, ref, X = plain
    qs = np.random.default_rng(17).normal(size=(3, DIM))
    spec = Query(task="knn", k=10, where=PREDICATES[sel], filter_mode=mode)
    rspec = rquery(spec)
    assert port.plan(spec).explain() == ref.plan(rspec).explain()
    match = port.attributes.match(PREDICATES[sel])
    for q, g, w in zip(qs, port.query(qs, spec), ref.query(qs, rspec)):
        same(g, w)
        np.testing.assert_array_equal(g.ids, brute_knn(X, match, q, 10))
    same(port.query(qs[0], spec), ref.query(qs[0], rspec))


@pytest.mark.parametrize("sel", sorted(PREDICATES))
@pytest.mark.parametrize("mode", MODES, ids=[m or "auto" for m in MODES])
def test_range_equals_reference_and_brute_force(plain, sel, mode):
    port, ref, X = plain
    qs = np.random.default_rng(23).normal(size=(3, DIM))
    match = port.attributes.match(PREDICATES[sel])
    for t in (3.5, 5.0):
        spec = Query(task="range", threshold=t, where=PREDICATES[sel], filter_mode=mode)
        rspec = rquery(spec)
        assert port.plan(spec).explain() == ref.plan(rspec).explain()
        for q, g, w in zip(qs, port.query(qs, spec), ref.query(qs, rspec)):
            same(g, w)
            np.testing.assert_array_equal(np.sort(g.ids), brute_range(X, match, q, t))
        same(port.query(qs[1], spec), ref.query(qs[1], rspec))


def test_compound_predicate(plain):
    port, ref, X = plain
    pred = Predicate.between("bucket", lo=0, hi=49) & Predicate.eq("flag", True)
    q = np.random.default_rng(9).normal(size=DIM)
    match = port.attributes.match(pred)
    for mode in MODES:
        spec = Query(task="knn", k=10, where=pred, filter_mode=mode)
        got = port.query(q, spec)
        same(got, ref.query(q, rquery(spec)))
        np.testing.assert_array_equal(got.ids, brute_knn(X, match, q, 10))


def test_where_without_store_or_unknown_attribute_raises(plain):
    port, _, _ = plain
    bare = build_index(_vectors(80, seed=1), kind="laesa", n_pivots=PIVOTS, device="cpu")
    with pytest.raises(ValueError, match="attribute"):
        bare.query(np.zeros(DIM), Query(task="knn", k=3, where=PREDICATES["0.5"]))
    with pytest.raises(ValueError, match="nope"):
        port.query(np.zeros(DIM), Query(task="knn", k=3, where=Predicate.eq("nope", 1)))


@pytest.mark.parametrize("mode", ("pushdown", "postfilter"))
@pytest.mark.parametrize("sel", ("0.5", "0.1"))
def test_approx_subset_of_matching_rows(plain, sel, mode):
    port, _, _ = plain
    if port.stats()["kind"] == "tree":
        with pytest.raises(ValueError, match="truncatable"):
            port.query(np.zeros(DIM), Query(task="knn", k=10, mode="approx", dims=6, where=PREDICATES[sel],
                                            filter_mode=mode))
        return
    q = np.random.default_rng(31).normal(size=DIM)
    match = set(port.attributes.match(PREDICATES[sel]).tolist())
    res = port.query(q, Query(task="knn", k=10, mode="approx", dims=6, where=PREDICATES[sel], filter_mode=mode))
    assert res.approx == {"dims": 6, "refine": 64}
    assert len(res) == 10 and set(res.ids.tolist()) <= match


@pytest.mark.parametrize("mode", ("pushdown", "postfilter"))
def test_approx_match_all_is_identity(plain, mode):
    """A predicate matching every row reproduces the unfiltered approximate
    answer bit for bit on the mask-driven paths."""
    port, _, _ = plain
    if port.stats()["kind"] == "tree":
        with pytest.raises(ValueError, match="truncatable"):
            port.plan(Query(task="knn", k=10, mode="approx", dims=6, where=PREDICATES["1.0"], filter_mode=mode))
        return
    q = np.random.default_rng(37).normal(size=DIM)
    base = port.query(q, Query(task="knn", k=10, mode="approx", dims=6))
    res = port.query(q, Query(task="knn", k=10, mode="approx", dims=6, where=PREDICATES["1.0"], filter_mode=mode))
    np.testing.assert_array_equal(res.ids, base.ids)
    np.testing.assert_array_equal(res.distances, base.distances)


def test_sugar_folds_into_allow_deny():
    live = np.arange(N, dtype=np.int64)
    spec = Query(task="knn", k=5, where=Predicate.ids(live[:6]) & Predicate.exclude_ids(live[20:23]))
    assert spec.where is None
    assert spec.allow == tuple(int(i) for i in live[:6])
    assert spec.deny == tuple(int(i) for i in live[20:23])
    assert spec.to_dict() == rquery(spec).to_dict()
    spec = Query(task="knn", k=5, where=PREDICATES["0.5"].to_dict())
    assert spec.where == PREDICATES["0.5"] and spec.to_dict() == rquery(spec).to_dict()


def _sugar_pair(index, q, legacy, sugar):
    a, b = index.query(q, legacy), index.query(q, sugar)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.distances, b.distances)
    return a


@pytest.mark.parametrize("which", ("allow", "deny", "k_exceeds", "with_predicate"))
def test_sugar_equals_legacy_and_reference(plain, which):
    port, ref, X = plain
    rng = np.random.default_rng({"allow": 41, "deny": 43, "k_exceeds": 47, "with_predicate": 53}[which])
    q = rng.normal(size=DIM)
    if which == "allow":
        ids = rng.choice(N, size=25, replace=False).astype(np.int64)
        legacy, sugar = Query.knn(10, allow=tuple(ids.tolist())), Query.knn(10, where=Predicate.ids(ids))
        want = brute_knn(X, np.sort(ids), q, 10)
    elif which == "deny":
        ids = rng.choice(N, size=40, replace=False).astype(np.int64)
        legacy, sugar = Query.knn(10, deny=tuple(ids.tolist())), Query.knn(10, where=Predicate.exclude_ids(ids))
        want = brute_knn(X, np.setdiff1d(np.arange(N), ids), q, 10)
    elif which == "k_exceeds":
        ids = np.array([3, 77, 240], dtype=np.int64)
        legacy, sugar = Query.knn(10, allow=tuple(ids.tolist())), Query.knn(10, where=Predicate.ids(ids))
        want = brute_knn(X, ids, q, 10)
    else:
        ids = rng.choice(N, size=120, replace=False).astype(np.int64)
        pred = Predicate.between("bucket", lo=0, hi=49)
        legacy = Query.knn(10, where=pred, allow=tuple(ids.tolist()))
        sugar = Query.knn(10, where=pred & Predicate.ids(ids))
        want = brute_knn(X, np.intersect1d(port.attributes.match(pred), ids), q, 10)
    got = _sugar_pair(port, q, legacy, sugar)
    np.testing.assert_array_equal(got.ids, want)
    same(got, ref.query(q, rquery(sugar)))
    if which == "k_exceeds":
        assert len(got) == 3


def test_index_with_attributes_cross_loads_both_ways(plain, tmp_path):
    port, ref, _ = plain
    port.save(tmp_path / "port")
    ref.save(tmp_path / "ref")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    with enable_x64(True):
        from_port = rload(tmp_path / "port")
    assert from_ref.attributes is not None and from_port.attributes is not None
    q = np.random.default_rng(61).normal(size=(2, DIM))
    spec = Query(task="knn", k=10, where=PREDICATES["0.1"])
    for g, w in zip(from_ref.query(q, spec), ref.query(q, rquery(spec))):
        same(g, w)
    for g, w in zip(port.query(q, spec), from_port.query(q, rquery(spec))):
        same(g, w)


def test_store_semantics_and_format_equal_reference(tmp_path):
    """put / drop / subset / remap / view / copy / row_values, the stats,
    selectivity and match of both stores after the same operations, and
    each package's saved store read by the other."""
    port, ref = _stores(np.arange(50, dtype=np.int64))
    for s in (port, ref):
        s.put([3, 60, 61], _attrs_for([3, 60, 61]))
        s.drop([5, 6, 999])
    view = port.view()
    port.put([70], _attrs_for([70]))
    ref.put([70], _attrs_for([70]))
    assert len(view) == len(port) - 1 and port.version == ref.version
    pairs = [(port, ref), (port.subset([1, 2, 60, 70]), ref.subset([1, 2, 60, 70])),
             (port.remap({1: 10, 3: 2, 70: 0}), ref.remap({1: 10, 3: 2, 70: 0})), (port.copy(), ref.copy())]
    preds = [PREDICATES["0.5"], Predicate.eq("color", "red") & Predicate.between("price", 0.2, 0.8),
             Predicate.eq("flag", False), Predicate.isin("bucket", [1, 3, 61])]
    for p_, r_ in pairs:
        np.testing.assert_array_equal(p_.ids(), r_.ids())
        for name in SCHEMA:
            np.testing.assert_array_equal(p_.column(name), r_.column(name))
        assert p_.stats() == r_.stats()
        for pred in preds:
            rp = RPredicate.from_dict(pred.to_dict())
            np.testing.assert_array_equal(p_.match(pred), r_.match(rp))
            assert p_.selectivity(pred) == r_.selectivity(rp)
    got, want = port.row_values([1, 2, 5, 70]), ref.row_values([1, 2, 5, 70])
    np.testing.assert_array_equal(got[0], want[0])
    for name in SCHEMA:
        np.testing.assert_array_equal(got[1][name], want[1][name])
    port.save(tmp_path / "p")
    ref.save(tmp_path / "r")
    for loaded, other in ((RStore.load(tmp_path / "p"), port), (AttributeStore.load(tmp_path / "r"), ref)):
        np.testing.assert_array_equal(loaded.ids(), other.ids())
        for name in SCHEMA:
            np.testing.assert_array_equal(loaded.column(name), other.column(name))
        assert loaded.stats() == other.stats()
    assert AttributeStore.maybe_load(tmp_path / "missing") is None


def test_predicate_canonical_form_and_wire_format_equal_reference():
    p1 = Predicate.isin("bucket", [3, 1, 2]) & Predicate.eq("flag", True)
    p2 = Predicate.eq("flag", True) & Predicate.isin("bucket", [2, 3, 1])
    assert p1 == p2 and hash(Query.knn(5, where=p1)) == hash(Query.knn(5, where=p2))
    r1 = RPredicate.isin("bucket", [3, 1, 2]) & RPredicate.eq("flag", True)
    assert p1.to_dict() == r1.to_dict()
    assert Predicate.from_dict(r1.to_dict()) == p1
    assert p1.attrs == r1.attrs == ("bucket", "flag")
    with pytest.raises(ValueError, match="lo > hi"):
        Predicate.between("price", 2.0, 1.0)
    with pytest.raises(TypeError, match="scalars"):
        Predicate.eq("bucket", [1])


@pytest.fixture(scope="module")
def planner_pair():
    """A 12,288-row LAESA index in both packages: large enough that the
    10% predicate exceeds the prefilter floor (1024 rows)."""
    n = 12288
    X = _vectors(n=n, seed=89)
    return _build_pair(X, "laesa", np.arange(n, dtype=np.int64))


@pytest.mark.parametrize("sel", ("0.7", "0.5", "0.1", "0.01"))
@pytest.mark.parametrize("mode", MODES, ids=[m or "auto" for m in MODES])
@pytest.mark.parametrize("task", ("knn", "range"))
def test_plan_explain_equals_reference(planner_pair, sel, mode, task):
    port, ref = planner_pair
    pred = Predicate.between("bucket", lo=0, hi=69) if sel == "0.7" else PREDICATES[sel]
    kw = dict(k=10) if task == "knn" else dict(threshold=2.5)
    for extra in ({}, dict(mode="approx", dims=4), dict(deny=(1, 2))):
        spec = Query(task=task, where=pred, filter_mode=mode, **kw, **extra)
        got = port.plan(spec).explain()
        assert got == ref.plan(rquery(spec)).explain()
        stage = next(s for s in got["stages"] if s["stage"] == "predicate_filter")
        assert stage["forced"] is (mode is not None)
        if mode is None and extra == {}:
            # euclidean at dim 12 / 8 pivots: the direct scan undercuts the
            # masked scan at every selectivity
            assert got["filter"] == "predicate_prefilter"


def test_auto_choices_track_selectivity_expensive_metric():
    """An expensive metric on a corpus large enough that the direct scan
    loses: the automatic choice walks prefilter -> pushdown -> postfilter as
    selectivity grows, in both packages."""
    ids = np.arange(1000, dtype=np.int64)
    stores = AttributeStore({"bucket": "int"}), RStore({"bucket": "int"})
    for s in stores:
        s.put(ids, {"bucket": ids % 100})
    stats = {"kind": "nsimplex", "metric": "jensen_shannon", "n_objects": 200_000, "dim": 64, "n_pivots": 16}

    def fake(store):
        return type("FakeIndex", (), {"attributes": store, "stats": staticmethod(lambda: dict(stats))})()

    cases = {
        "0.01": (PREDICATES["0.01"], "predicate_prefilter"),
        "0.3": (Predicate.between("bucket", lo=0, hi=29), "predicate_pushdown"),
        "0.7": (Predicate.between("bucket", lo=0, hi=69), "predicate_postfilter"),
    }
    for sel, (pred, want) in cases.items():
        spec = Query(task="knn", k=10, where=pred)
        got = plan(fake(stores[0]), spec).explain()
        assert got == rplan(fake(stores[1]), rquery(spec)).explain(), sel
        assert got["filter"] == want, sel


def test_attributes_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    store, _ = _stores(np.arange(40, dtype=np.int64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(_vectors(40), n_pivots=4, attributes=store)


def _masked_knn_300(n_pivots, allowed_share):
    """Port and reference exact k-NN at k = 300 over 5,000 colors rows under
    a row mask allowing ``allowed_share`` of them: the number of queries each
    package sends to its per-query route, and the answers held equal."""
    from repro.data import colors_like

    X = colors_like(n=5016, seed=41)
    data, qs = X[:5000], X[5000:]
    mask = np.random.default_rng(3).random(5000) < allowed_share
    with enable_x64(True):
        ref = rbuild(data, "euclidean", n_pivots=n_pivots, seed=3, use_kernel=True)
    port = build_index(data, "euclidean", n_pivots=n_pivots, seed=3, device="cpu")
    got = port._inner.knn_batch(qs, 300, rowmask=mask)
    dense, one = [], ref._inner._knn_one
    ref._inner._knn_one = lambda *a, **k: (dense.append(1), one(*a, **k))[1]
    want = ref._inner.knn_batch(qs, 300, rowmask=mask)
    assert port._inner.overflow_queries == len(dense)
    allowed = np.flatnonzero(mask)
    for q, (gi, gd, gs), (wi, wd, ws) in zip(qs, got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e-12)
        assert set(gi.tolist()) <= set(allowed.tolist())
        assert gs.original_calls == ws.original_calls
        assert abs(gs.candidates - ws.candidates) <= 0.002 * ws.candidates
        d = METRIC.one_to_many_np(q, data[allowed])
        np.testing.assert_array_equal(gi, allowed[np.lexsort((allowed, d))[:300]])
    return len(dense), len(qs)


def test_masked_overflow_route_equals_reference():
    """A masked exact k-NN batch at k = 300 (pass B's cap 16k = 4,800, past
    4,096): K3 runs at that cap, as the reference's, and exactly the queries
    whose masked count exceeds it take the overflow route (K3 again at a
    width that holds them; here, 30% of the rows allowed, none does); the row mask is applied before the k-th upper bound and the
    candidate filter, so a masked row never sets the radius.  Ids,
    distances and ``original_calls`` equal the reference's; ``candidates``
    may differ by a boundary row, since the reference's interpret-mode
    bounds and the port's plain bounds differ in the last f32 ulp (ROADMAP
    queue 3), so it is held within 0.2%."""
    _masked_knn_300(8, 0.3)


def test_masked_overflow_route_past_the_cap():
    """The same with 4 pivots and 98% of the rows allowed: some queries'
    masked counts exceed 4,800 and take the overflow route with the
    mask, the others stay on K3's selection, in both packages alike."""
    dense, n = _masked_knn_300(4, 0.98)
    assert 0 < dense < n


#: the chip smoke run's filtered phase: its planner stats (colors-1M, 20
#: pivots) and, per metric, the strategy its four predicates take
COLORS_1M_STATS = {"kind": "nsimplex", "n_objects": 1_000_000, "dim": 112, "n_pivots": 20}
COLORS_1M_AUTO = {
    "euclidean": {"shop_top": "prefilter", "recent_in_stock": "prefilter", "in_stock": "postfilter",
                  "shop_rare10": "prefilter"},
    "jensen_shannon": {"shop_top": "prefilter", "recent_in_stock": "pushdown", "in_stock": "postfilter",
                       "shop_rare10": "prefilter"},
}


@pytest.fixture(scope="module")
def colors_1m_stores():
    """The chip smoke run's 1M-row attribute columns (its generator and
    seed) in a port store and a reference store, and its four predicates."""
    import importlib.util
    from pathlib import Path

    from repro_torch import filter as filter_mod

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    attrs = smoke.make_attributes(smoke.N_ROWS, smoke.SEED)
    ids = np.arange(smoke.N_ROWS)
    port, ref = AttributeStore(smoke.ATTR_SCHEMA), RStore(smoke.ATTR_SCHEMA)
    port.put(ids, attrs)
    ref.put(ids, attrs)
    preds = {name: pred for name, (pred, _) in smoke.filter_predicates(filter_mod, attrs).items()}
    return port, ref, preds


@pytest.mark.parametrize("metric", sorted(COLORS_1M_AUTO))
@pytest.mark.parametrize("pname", ["shop_top", "recent_in_stock", "in_stock", "shop_rare10"])
def test_plan_at_the_chip_phase_stats_equals_reference(colors_1m_stores, metric, pname):
    """The filtered phase's automatic strategy on the card is the
    reference's: the plan depends on the store and ``stats()`` alone, so the
    port's ``explain()`` is held to the JAX package's at the phase's own
    stats and columns, and the choice to the one the phase prints."""
    port, ref, preds = colors_1m_stores
    stats = dict(COLORS_1M_STATS, metric=metric)

    def fake(store):
        return type("FakeIndex", (), {"attributes": store, "stats": staticmethod(lambda: dict(stats))})()

    spec = Query(task="knn", k=10, where=preds[pname])
    got = plan(fake(port), spec).explain()
    assert got == rplan(fake(ref), rquery(spec)).explain()
    assert got["filter"] == f"predicate_{COLORS_1M_AUTO[metric][pname]}"


# -- the sharded composite (tests/test_filter.py's sharded cases) ---------------
def _mutate(index, vecs):
    """``tests/test_filter.py::_mutate``: adds, removes and upserts with
    attributes; ``vecs`` (logical id -> row) follows them."""
    rng = np.random.default_rng(77)
    new_ids = np.arange(N, N + 40, dtype=np.int64)
    new_rows = rng.normal(size=(40, DIM))
    index.add(new_rows, ids=new_ids, attrs=_attrs_for(new_ids))
    gone = np.array([5, 107, 211, N + 3], dtype=np.int64)
    index.remove(gone)
    up_ids = np.array([8, 42, N + 10], dtype=np.int64)
    up_rows = rng.normal(size=(3, DIM))
    index.upsert(up_ids, up_rows, attrs=_attrs_for(up_ids))
    if vecs is not None:
        vecs.update({int(i): r for i, r in zip(new_ids, new_rows)})
        for i in gone:
            vecs.pop(int(i))
        vecs.update({int(i): r for i, r in zip(up_ids, up_rows)})


@pytest.fixture(scope="module", params=[("laesa", True, 2), ("laesa", False, 2), ("nsimplex", True, 0),
                                        ("nsimplex", False, 0)],
                ids=["laesa-mutable", "laesa-plain", "nsimplex-mutable-seq", "nsimplex-plain-seq"])
def sharded(request):
    """``_fresh_sharded``: 2 shards, mutated when mutable; the reference the
    same.  Counts are compared under sequential fan-out (``fanout_workers=0``)
    only: overlapped counts depend on completion order in both packages."""
    kind, mutable, workers = request.param
    X = _vectors(seed=13)
    port, ref = _build_pair(X, kind, np.arange(N, dtype=np.int64), shards=2, mutable=mutable,
                            fanout_workers=workers)
    vecs = {i: X[i] for i in range(N)}
    if mutable:
        _mutate(port, vecs)
        _mutate(ref, None)
    return port, ref, vecs, workers == 0


def _same_or_ids(got, want, counts, dists=True):
    """``same`` under sequential fan-out; ids and distances alone under an
    overlapped one, whose counts depend on completion order."""
    if counts:
        same(got, want, dists=dists)
        return
    np.testing.assert_array_equal(got.ids, want.ids)
    if dists and want.distances is not None:
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-12, atol=1e-12)


def _brute_over(vecs, match, q, k=None, t=None):
    match = np.asarray(match, dtype=np.int64)
    if not len(match):
        return match
    d = METRIC.one_to_many_np(q, np.stack([vecs[int(i)] for i in match]))
    return match[np.lexsort((match, d))[:k]] if t is None else match[d <= t]


@pytest.mark.parametrize("sel", sorted(PREDICATES))
@pytest.mark.parametrize("mode", MODES, ids=[m or "auto" for m in MODES])
def test_sharded_filtered_equals_reference_and_brute_force(sharded, sel, mode):
    port, ref, vecs, counts = sharded
    q = np.random.default_rng(3).normal(size=(2, DIM))
    live = np.sort(np.fromiter(vecs, dtype=np.int64))
    match = np.intersect1d(port.attributes.match(PREDICATES[sel]), live)
    np.testing.assert_array_equal(match, np.intersect1d(ref.attributes.match(rquery(
        Query.knn(1, where=PREDICATES[sel])).where), ref.ids()))
    for spec in (Query(task="knn", k=10, where=PREDICATES[sel], filter_mode=mode),
                 Query(task="range", threshold=4.5, where=PREDICATES[sel], filter_mode=mode)):
        rspec = rquery(spec)
        assert port.plan(spec).explain() == ref.plan(rspec).explain()
        for qi, (g, w) in enumerate(zip(port.query(q, spec), ref.query(q, rspec))):
            _same_or_ids(g, w, counts, dists=spec.task == "knn")
            if spec.task == "knn":
                np.testing.assert_array_equal(g.ids, _brute_over(vecs, match, q[qi], k=10))
            else:
                np.testing.assert_array_equal(np.sort(g.ids), _brute_over(vecs, match, q[qi], t=4.5))


def test_sharded_sugar_equals_legacy_and_reference(sharded):
    port, ref, vecs, counts = sharded
    rng = np.random.default_rng(59)
    live = np.sort(np.fromiter(vecs, dtype=np.int64))
    allow = rng.choice(live, size=20, replace=False).astype(np.int64)
    deny = np.setdiff1d(live, allow)[:15]
    q = rng.normal(size=DIM)
    for legacy, sugar, want in (
        (Query.knn(10, allow=tuple(int(i) for i in allow)), Query.knn(10, where=Predicate.ids(allow)), np.sort(allow)),
        (Query.knn(10, deny=tuple(int(i) for i in deny)), Query.knn(10, where=Predicate.exclude_ids(deny)),
         np.setdiff1d(live, deny)),
    ):
        got = _sugar_pair(port, q, legacy, sugar)
        np.testing.assert_array_equal(got.ids, _brute_over(vecs, want, q, k=10))
        _same_or_ids(got, ref.query(q, rquery(sugar)), counts)


def test_sharded_save_load_with_attributes_both_ways(sharded, tmp_path):
    port, ref, vecs, _ = sharded
    port.save(tmp_path / "port")
    ref.save(tmp_path / "ref")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    from_ref.configure_grid([torch.device("cpu")] * jax.device_count())
    with enable_x64(True):
        from_port = rload(tmp_path / "port")
    assert from_ref.attributes is not None and from_port.attributes is not None
    q = np.random.default_rng(61).normal(size=(2, DIM))
    for pred in (PREDICATES["0.1"], PREDICATES["0.5"]):
        spec = Query(task="knn", k=10, where=pred)
        for a, b in ((from_ref, ref), (port, from_port)):
            for g, w in zip(a.query(q, spec), b.query(q, rquery(spec))):
                np.testing.assert_array_equal(g.ids, w.ids)
                np.testing.assert_allclose(g.distances, w.distances, rtol=1e-12, atol=1e-12)
