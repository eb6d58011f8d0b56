"""The sharded composite in the port against the JAX package, on the CPU.

The contracts of ``tests/test_sharded.py`` and ``tests/test_scaleout.py``,
each held against ``repro.api``'s answer for the same build (the reference
built under ``enable_x64`` with ``use_kernel=True``, the algorithm the port
follows) and against a brute force: 480 colors rows in float64, 6 pivots,
3 or 4 shards.

* k-NN at k = 1 / 10 / 100, range at two quantiles, per-query thresholds and
  the approximate path: ids (in (distance, id) order) and distances equal to
  the reference's for the nsimplex, laesa and tree kinds, plain and mutable;
* the device filter engages (K3 per grid position) and equals the host
  fan-out; a slot overflow falls back exactly;
* ``QueryStats`` counts equal to the reference's under ``fanout_workers=0``
  (overlapped counts depend on completion order in both packages); on the
  device-filter path only where no f32 bound lies within 1e-5 relative of
  ``t_hi`` / ``t_lo``, asserted before comparing;
* mutations equal to the reference's and to a fresh rebuild, atomic, adds to
  the least-loaded shard, ``fit`` invalidating read views, the pivots
  charged once per query across shards and sides, ``TopKMerge`` under any
  push order, overlapped fan-out equal to sequential under any completion
  order;
* stats, plan (``explain()`` equal to the reference's) and layout fields;
  save / load in either package and loaded by the other;
* layouts on a grid of four CPU devices (the reference runs these on a forced
  4-device host platform) equal to the reference's one-device answer and
  to the brute force.
"""

import time

import jax
import numpy as np
import pytest
import torch

from repro.api import Query as RQuery, build_index as rbuild, load_index as rload
from repro.compat import enable_x64
from repro.data import colors_like
from repro.index.knn import knn_select
from repro.metrics import get_metric as rmetric
from repro_torch.api import Query, ShardedIndex, build_index, load_index
from repro_torch.api.fanout import TopKMerge
from repro_torch.core import bounds as tb
from repro_torch.launch.service import SearchService
from repro_torch.metrics import get_metric

torch.set_num_threads(1)

KINDS = ("nsimplex", "laesa", "tree")
M = rmetric("euclidean")
CPU = torch.device("cpu")
KW = dict(n_pivots=6, seed=2)


def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


def same(got, want, dists=True, counts=True):
    np.testing.assert_array_equal(got.ids, want.ids)
    if dists and want.distances is not None:
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-12, atol=1e-12)
    if counts:
        assert _stats(got.stats) == _stats(want.stats)


def same_grid(port):
    """The port's device filter on as many CPU positions as the reference's
    mesh has devices: jax may run on one host device or, when a module that
    forces a 4-device host platform was imported first, on four, and the
    slot overflows (so the counts) follow the per-device rows."""
    port.configure_grid([CPU] * jax.device_count())
    return port


def pair(data, kind="nsimplex", **kw):
    """(port, reference) of one sharded build, fan-out sequential unless
    the caller says otherwise."""
    kw = {"fanout_workers": 0, **KW, **kw}
    with enable_x64(True):
        ref = rbuild(data, "euclidean", kind=kind, use_kernel=True, **kw)
    return same_grid(build_index(data, "euclidean", kind=kind, device="cpu", **kw)), ref


def brute_knn(q, data, k):
    d = M.one_to_many_np(q, data)
    return knn_select(d, np.arange(len(d), dtype=np.int64), min(k, len(d)))


def brute_range(q, data, t):
    return np.where(M.one_to_many_np(q, data) <= t)[0]


def quantile_t(data, q, quantile):
    """A threshold between two neighbour distances of ``q``."""
    d = np.sort(M.one_to_many_np(q, data))
    i = int(quantile * len(d))
    return float(0.5 * (d[i] + d[i + 1]))


def assert_device_bands_separated(port, queries, thresholds, rel=1e-5):
    """No f32 bound of the flat table lies within ``rel`` of a query's
    device-filter bands ``t (1 ± eps_eff)``: there the port's GEMM form and
    the reference's may round a decision apart."""
    table, _, _, row_sq = port._flat_state()
    qd = get_metric("euclidean").cross(torch.as_tensor(queries), port._projector.pivots_t)
    apexes = port._projector.project_distances(qd)
    thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (len(queries),))
    t_min = float(thresholds.min())
    eps_eff = port._eps + port._fp32_slack(row_sq, apexes, t_min) / t_min
    lwb, upb = (b.numpy() for b in tb.two_sided(apexes.float()[:, None, :], table[None, :, :]))
    for t_q, l, u in zip(thresholds, lwb, upb):
        for band in (t_q * (1 + eps_eff), t_q * (1 - eps_eff)):
            assert not np.any(np.abs(np.concatenate([l, u]) - band) <= rel * band)


@pytest.fixture(scope="module")
def corpus():
    X = colors_like(n=488, seed=31).astype(np.float64)
    return X[:480], X[480:488]


@pytest.fixture(scope="module", params=[(k, m) for k in KINDS for m in (False, True)],
                ids=[f"{k}-{'mutable' if m else 'plain'}" for k in KINDS for m in (False, True)])
def sharded(request, corpus):
    kind, mutable = request.param
    data, _ = corpus
    port, ref = pair(data, kind, shards=3, mutable=mutable, compact_threshold=None)
    return port, ref, data


# -- exactness -----------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 10, 100])
def test_knn_equals_reference_and_brute_force(sharded, corpus, k):
    port, ref, data = sharded
    _, queries = corpus
    got, want = port.knn_batch(queries, k), ref.knn_batch(queries, k)
    for qi, q in enumerate(queries):
        same(got[qi], want[qi])
        want_ids, want_d = brute_knn(q, data, k)
        np.testing.assert_array_equal(got[qi].ids, want_ids)
        np.testing.assert_allclose(got[qi].distances, want_d, rtol=1e-12, atol=1e-12)
        same(port.knn(q, k), ref.knn(q, k))


@pytest.mark.parametrize("quantile", [0.01, 0.1])
def test_range_equals_reference_and_brute_force(sharded, corpus, quantile):
    port, ref, data = sharded
    _, queries = corpus
    t = quantile_t(data, queries[0], quantile)
    if port._use_device_filter(np.full(len(queries), t)):
        assert_device_bands_separated(port, queries, t)
    got, want = port.search_batch(queries, t), ref.search_batch(queries, t)
    for qi, q in enumerate(queries):
        same(got[qi], want[qi])
        np.testing.assert_array_equal(got[qi].ids, brute_range(q, data, t))
    same(port.search(queries[1], t), ref.search(queries[1], t))
    assert (port._filter_fn is not None) == (port.inner_kind == "nsimplex")


def test_stats_aggregate(sharded):
    port, ref, data = sharded
    st, rst = port.stats(), ref.stats()
    assert st["kind"] == "sharded" and st["n_objects"] == len(data)
    assert sum(st["shard_objects"]) == len(data)
    for key in ("inner_kind", "n_shards", "mutable", "shard_objects", "device_filter", "shared_projector",
                "fanout_workers", "fanout_overlap", "layout", "n_objects", "dim", "metric"):
        assert st[key] == rst[key], key
    assert set(rst) <= set(st)


SPECS = [
    dict(task="knn", k=10),
    dict(task="range", threshold=0.1),
    dict(task="range", threshold=(0.1, 0.2)),
    dict(task="range", threshold=1e-9),
    dict(task="knn", k=5, mode="exact"),
    dict(task="knn", k=5, budget=10),
    dict(task="knn", k=5, deny=(3, 1)),
    dict(task="knn", k=5, allow=(1, 2, 3)),
]


@pytest.mark.parametrize("kw", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_explain_equals_reference(sharded, kw):
    port, ref, _ = sharded
    assert port.plan(Query(**kw)).explain() == ref.plan(RQuery(**kw)).explain()


def test_ties_broken_by_global_id():
    """Duplicate rows land in DIFFERENT shards; the merge still orders ties
    by global id exactly like a single index."""
    base = colors_like(n=60, seed=33).astype(np.float64)
    data = np.concatenate([base, base, base])
    port = build_index(data, "euclidean", n_pivots=5, seed=1, shards=3, device="cpu")
    for k in (1, 3, 61, 120):
        for q in base[:3]:
            want_ids, want_d = brute_knn(q, data, k)
            res = port.knn(q, k)
            np.testing.assert_array_equal(res.ids, want_ids)
            np.testing.assert_allclose(res.distances, want_d, rtol=1e-12)


# -- the device filter -----------------------------------------------------------
@pytest.fixture(scope="module")
def device_pair(corpus):
    data, _ = corpus
    return pair(data, shards=4)


def test_device_filter_engages_and_equals_host(device_pair, corpus):
    data, queries = corpus
    port, ref = device_pair
    t = quantile_t(data, queries[0], 0.03)
    assert port._use_device_filter(np.full(len(queries), t))
    assert_device_bands_separated(port, queries, t)
    dev = port.search_batch(queries, t)
    assert port._filter_fn is not None and port._mesh_data == jax.device_count() and port._mesh_replicas == 1
    host = build_index(data, "euclidean", shards=4, device_filter=False, device="cpu", **KW).search_batch(queries, t)
    for qi, q in enumerate(queries):
        np.testing.assert_array_equal(dev[qi].ids, host[qi].ids)
        np.testing.assert_array_equal(dev[qi].ids, brute_range(q, data, t))
    for g, w in zip(dev, ref.search_batch(queries, t)):
        same(g, w)
    assert port.plan(Query.range(t)).explain()["stages"][0] == {
        "stage": "shard_fanout", "device_filter": True, "layout": port.layout, "overlap": False, "shards": 4,
        "workers": 0}


def test_slot_overflow_falls_back_exactly(corpus):
    data, queries = corpus
    port, ref = pair(data, shards=2, max_candidates=4)
    t = quantile_t(data, queries[0], 0.2)
    calls = []
    host = port._host_search_batch
    port._host_search_batch = lambda *a, **k: calls.append(len(a[0])) or host(*a, **k)
    got = port.search_batch(queries, t)
    assert calls and sum(calls) == len(queries)   # every query overflows 4 slots, in one fan-out
    for g, w, q in zip(got, ref.search_batch(queries, t), queries):
        same(g, w)
        np.testing.assert_array_equal(g.ids, brute_range(q, data, t))


def test_per_query_thresholds(device_pair, corpus):
    data, queries = corpus
    port, ref = device_pair
    t0 = quantile_t(data, queries[0], 0.05)
    ts = np.linspace(0.5 * t0, 1.5 * t0, len(queries))
    assert_device_bands_separated(port, queries, ts)
    got = port.search_batch(queries, ts)
    for qi, q in enumerate(queries):
        np.testing.assert_array_equal(got[qi].ids, brute_range(q, data, ts[qi]))
    for g, w in zip(got, ref.search_batch(queries, ts)):
        same(g, w)


def test_threshold_below_the_gate_fans_out_on_host(device_pair, corpus):
    """``MIN_DEVICE_THRESHOLD``: a near-zero threshold takes the host
    fan-out, as the plan's stage says, and charges the pivots once."""
    _, queries = corpus
    port, ref = device_pair
    assert not port._use_device_filter(np.full(len(queries), 1e-9))
    for g, w in zip(port.search_batch(queries, 1e-9), ref.search_batch(queries, 1e-9)):
        same(g, w)
        assert pivot_charge(g.stats) == KW["n_pivots"]


@pytest.mark.parametrize("quantile", [0.05, 0.3])
def test_approx_equals_reference_and_single_index(corpus, quantile):
    """``apex_dims`` builds fan out on host; with ``refine`` the corpus size
    every straddler is re-ranked, so the answers are exact."""
    data, queries = corpus
    kw = dict(n_pivots=8, apex_dims=4, refine=len(data))
    port, ref = pair(data, shards=4, **kw)
    single = build_index(data, "euclidean", seed=2, device="cpu", **kw)
    got, want, one = port.knn_batch(queries, 10), ref.knn_batch(queries, 10), single.knn_batch(queries, 10)
    for g, w, o in zip(got, want, one):
        assert g.approx == {"dims": 4, "refine": len(data)}
        same(g, w)
        same(g, o, counts=False)
    t = quantile_t(data, queries[0], quantile)
    for g, w, q in zip(port.search_batch(queries, t), ref.search_batch(queries, t), queries):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.ids, brute_range(q, data, t))
    assert port.plan(Query.range(t)).explain() == ref.plan(RQuery.range(t)).explain()


# -- fan-out ---------------------------------------------------------------------
def _corpus_ties():
    base = colors_like(n=160, seed=61).astype(np.float64)
    return np.concatenate([base, base, colors_like(n=320, seed=62).astype(np.float64)]), \
        colors_like(n=7, seed=63).astype(np.float64)


@pytest.mark.parametrize("kind", ["nsimplex", "laesa"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_overlapped_fanout_equals_sequential_and_single(kind, k):
    data, queries = _corpus_ties()
    single = build_index(data, "euclidean", kind=kind, device="cpu", **KW)
    seq = build_index(data, "euclidean", kind=kind, shards=4, fanout_workers=0, device="cpu", **KW)
    over = build_index(data, "euclidean", kind=kind, shards=4, fanout_workers=4, device="cpu", **KW)
    want = single.knn_batch(queries, k)
    for idx in (seq, over):
        got = idx.knn_batch(queries, k)
        for qi in range(len(queries)):
            same(got[qi], want[qi], counts=False)
            same(idx.knn(queries[qi], k), want[qi], counts=False)


def test_shuffled_completion_order():
    """Per-shard delays permute completion order; ids and distances do not
    move (counts may: hinted shards measure fewer true distances)."""
    data, queries = _corpus_ties()
    idx = build_index(data, "euclidean", shards=4, fanout_workers=4, device="cpu", **KW)
    want = build_index(data, "euclidean", shards=4, fanout_workers=0, device="cpu", **KW).knn_batch(queries, 20)
    originals = [s._exec_knn_batch for s in idx._shards]

    def delayed(orig, delay):
        def run(queries, k, cfg=None, qpd=None, radius_hint=None):
            time.sleep(delay)
            return orig(queries, k, cfg=cfg, qpd=qpd, radius_hint=radius_hint)
        return run

    rng = np.random.default_rng(0)
    for _ in range(3):
        delays = rng.permutation([0.0, 0.004, 0.008, 0.012])
        for s, shard in enumerate(idx._shards):
            shard._exec_knn_batch = delayed(originals[s], delays[s])
        got = idx.knn_batch(queries, 20)
        for g, w in zip(got, want):
            same(g, w, counts=False)


def test_topk_merge_under_any_push_order():
    rng = np.random.default_rng(3)
    d = np.round(rng.random(200), 2)            # heavy ties
    ids = rng.permutation(200).astype(np.int64)
    want_ids, want_d = knn_select(d, ids, 10)
    for trial in range(10):
        merge = TopKMerge(10)
        chunks_d, chunks_i = np.array_split(d, 4), np.array_split(ids, 4)
        radii = []
        for c in rng.permutation(4):
            merge.push(chunks_d[c], chunks_i[c])
            radii.append(merge.radius())
        got_ids, got_d = merge.result()
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_d, want_d)
        assert all(a >= b for a, b in zip(radii, radii[1:]))  # monotone


def test_topk_merge_cap_drops_only_beyond_boundary():
    merge = TopKMerge(4, cap=0.2)
    merge.push(np.array([0.1, 0.2, 0.2, 0.3]), np.arange(4, dtype=np.int64))
    got_ids, got_d = merge.result()
    np.testing.assert_array_equal(got_ids, [0, 1, 2])   # boundary ties kept
    np.testing.assert_array_equal(got_d, [0.1, 0.2, 0.2])


def test_fanout_workers_follow_the_reference_variable(monkeypatch):
    from repro.api import fanout as rfanout
    from repro_torch.api import fanout

    for value in ("3", "0"):
        monkeypatch.setenv("REPRO_FANOUT_WORKERS", value)
        assert fanout.default_fanout_workers() == rfanout.default_fanout_workers() == int(value)
    assert fanout.shared_pool() is None          # 0 workers: every fan-out is sequential


# -- pivots measured once ----------------------------------------------------------
class CountingMetric:
    """Delegating wrapper that counts true-distance evaluations."""

    def __init__(self, inner):
        self._inner = inner
        self.pair_evals = 0

    def cross(self, A, B):
        self.pair_evals += torch.atleast_2d(A).shape[0] * torch.atleast_2d(B).shape[0]
        return self._inner.cross(A, B)

    def one_to_many(self, q, X):
        self.pair_evals += X.shape[0]
        return self._inner.one_to_many(q, X)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def pivot_charge(st):
    """``original_calls`` less the rechecks: the pivot distances charged.
    (The f32 slack of the kernel path rechecks rows even at t = 1e-9, where
    the reference's host path, which this test restates, rechecks none.)"""
    return st.original_calls - (st.candidates - st.accepted_no_check)


def test_threshold_counts_pivots_once_across_shards_and_sides():
    data, queries = _corpus_ties()
    plain = build_index(data, "euclidean", shards=4, device_filter=False, device="cpu", **KW)
    online = build_index(data, "euclidean", shards=3, mutable=True, device_filter=False, compact_threshold=None,
                         device="cpu", **KW)
    online.add(colors_like(n=30, seed=65).astype(np.float64))
    for idx in (plain, online):
        assert pivot_charge(idx.search(queries[0], 1e-9).stats) == KW["n_pivots"]
        for r in idx.search_batch(queries, 1e-9):
            assert pivot_charge(r.stats) == KW["n_pivots"]


def test_evals_match_reported_stats():
    """With a counting metric: the true-distance evaluations of a sharded
    range batch equal one segment's, and a k-NN batch's equal the reported
    ``original_calls`` (a shard re-measuring the pivots would add
    (shards - 1) x n_pivots per query)."""
    data, queries = _corpus_ties()
    cm_single, cm_shard = CountingMetric(get_metric("euclidean")), CountingMetric(get_metric("euclidean"))
    single = build_index(data, cm_single, device="cpu", **KW)
    shard = build_index(data, cm_shard, shards=4, device_filter=False, device="cpu", fanout_workers=0, **KW)
    t = quantile_t(data, queries[0], 0.05)
    cm_single.pair_evals = cm_shard.pair_evals = 0
    single.search_batch(queries, t)
    shard.search_batch(queries, t)
    assert cm_shard.pair_evals == cm_single.pair_evals
    cm_shard.pair_evals = 0
    batch = shard.knn_batch(queries, 10)
    assert cm_shard.pair_evals == sum(r.stats.original_calls for r in batch)
    cm_shard.pair_evals = 0
    one = shard.knn(queries[0], 10)
    assert cm_shard.pair_evals == one.stats.original_calls


# -- mutations -------------------------------------------------------------------
def _fresh(oracle, kind):
    live = np.array(sorted(oracle), dtype=np.int64)
    logical = np.stack([oracle[int(i)] for i in live])
    return live, logical, build_index(logical, "euclidean", kind=kind, n_pivots=6, seed=7, device="cpu")


@pytest.mark.parametrize("kind", ["nsimplex", "laesa", "tree"])
def test_mutations_equal_reference_and_fresh_rebuild(kind):
    data = colors_like(n=400, seed=41).astype(np.float64)
    extra = colors_like(n=200, seed=42).astype(np.float64)
    queries = colors_like(n=6, seed=43).astype(np.float64)
    port, ref = pair(data, kind, shards=3, mutable=True, compact_threshold=None)
    oracle = {i: r for i, r in enumerate(data)}
    for idx in (port, ref):
        ids = idx.add(extra[:90])
        idx.remove(np.arange(50, 120))
        idx.upsert(np.arange(10), extra[90:100])
    for i, r in zip(ids, extra[:90]):
        oracle[int(i)] = r
    for i in range(50, 120):
        oracle.pop(i)
    for i, r in zip(range(10), extra[90:100]):
        oracle[i] = r
    live, logical, fresh = _fresh(oracle, kind)
    np.testing.assert_array_equal(port.ids(), live)
    np.testing.assert_array_equal(port.data.numpy(), logical)
    for stage in ("dirty", "compacted"):
        for k in (1, 10, 100):
            got, want = port.knn_batch(queries, k), ref.knn_batch(queries, k)
            for qi, q in enumerate(queries):
                same(got[qi], want[qi], counts=kind != "tree" or stage == "dirty")
                np.testing.assert_array_equal(got[qi].ids, live[fresh.knn(q, k).ids])
        t = quantile_t(logical, queries[0], 0.05)
        got, want = port.search_batch(queries, t), ref.search_batch(queries, t)
        for qi, q in enumerate(queries):
            np.testing.assert_array_equal(got[qi].ids, live[brute_range(q, logical, t)])
            same(got[qi], want[qi], counts=kind != "tree" or stage == "dirty")
        port.compact()
        ref.compact()
        for st in (s.stats() for s in port._shards):
            assert st["delta_rows"] == 0 and st["tombstones"] == 0


def _mutable(kind="laesa", n=120, seed=70):
    data = colors_like(n=n, seed=seed).astype(np.float64)
    return build_index(data, "euclidean", kind=kind, n_pivots=5, seed=2, shards=3, mutable=True,
                       compact_threshold=None, device="cpu"), data


def test_adds_route_to_least_loaded():
    idx, _ = _mutable(n=300, seed=44)
    idx.remove(np.arange(0, 60))               # shard 0 shrinks to 40
    idx.add(colors_like(n=30, seed=45).astype(np.float64))
    assert idx.stats()["shard_objects"][0] == 70
    assert idx.stats()["n_objects"] == 270


def test_rejected_mutations_change_nothing():
    idx, data = _mutable()
    before, rows = idx.ids(), idx.data.clone()
    with pytest.raises(ValueError, match="duplicate"):
        idx.remove([3, 7, 3])
    with pytest.raises(KeyError):
        idx.remove([5, 999])                    # 5 is live, 999 is not
    with pytest.raises(KeyError, match="555"):
        idx.remove(555)
    with pytest.raises(ValueError, match="duplicate"):
        idx.add(data[:2], ids=[500, 500])
    with pytest.raises(ValueError, match="duplicate"):
        idx.upsert([4, 4], data[:2])
    with pytest.raises(ValueError):
        idx.upsert([4, 90], np.stack([data[0], np.full(data.shape[1], np.nan)]))   # two shards
    with pytest.raises(ValueError):
        idx.add(np.full((3, data.shape[1]), np.nan))
    with pytest.raises(ValueError):
        idx.add(np.zeros((2, data.shape[1] + 1)))
    np.testing.assert_array_equal(idx.ids(), before)
    assert torch.equal(idx.data, rows) and idx._next_id == 120
    np.testing.assert_array_equal(idx.add(data[:2]), [120, 121])      # nothing leaked


def test_add_id_live_in_sibling_shard_raises():
    idx, data = _mutable()
    idx.remove(np.arange(10))              # shard 0 becomes least-loaded
    with pytest.raises(KeyError, match="upsert"):
        idx.add(data[:1], ids=[70])        # id 70 lives in shard 1
    assert int((idx.ids() == 70).sum()) == 1


def test_upsert_mixed_new_and_existing():
    idx, _ = _mutable()
    rows = colors_like(n=3, seed=71).astype(np.float64)
    np.testing.assert_array_equal(idx.upsert([4, 200, 90], rows), [4, 200, 90])
    assert idx._next_id == 201
    for i, want in zip([4, 200, 90], rows):
        res = idx.knn(want, 1)
        assert res.ids[0] == i and res.distances[0] == 0.0


def test_immutable_sharded_rejects_mutation(device_pair):
    port, _ = device_pair
    with pytest.raises(TypeError, match="mutable=True"):
        port.add(np.zeros((1, 112)))


def test_fit_invalidates_read_views(corpus):
    data, queries = corpus
    idx = build_index(data[:300], "euclidean", shards=3, mutable=True, compact_threshold=None, device="cpu", **KW)
    shard0 = idx._shards[0]
    gen0, ver0 = shard0.generation, shard0.version
    view = shard0.read_view()
    old_view_ids = view.ids().copy()
    new_data = colors_like(n=330, seed=72).astype(np.float64)
    idx.fit(new_data)
    assert shard0.generation > gen0 and shard0.version > ver0
    np.testing.assert_array_equal(idx.ids(), np.arange(330))
    assert idx._next_id == 330
    np.testing.assert_array_equal(view.ids(), old_view_ids)    # the pinned view serves the pre-fit rows
    fresh = build_index(new_data, "euclidean", n_pivots=6, seed=9, device="cpu")
    for qi, q in enumerate(queries):
        np.testing.assert_array_equal(idx.knn_batch(queries, 10)[qi].ids, fresh.knn(q, 10).ids)
    np.testing.assert_array_equal(idx.add(new_data[:2]), [330, 331])


# -- stats, plan, service --------------------------------------------------------
def test_stats_expose_fanout_and_layout(corpus):
    data, _ = corpus
    idx = build_index(data, "euclidean", shards=3, fanout_workers=2, layout={"replicas": 2}, device="cpu", **KW)
    st = idx.stats()
    assert st["fanout_workers"] == 2 and st["fanout_overlap"] is True and st["layout"]["replicas"] == 2
    stage = next(s for s in idx.plan(Query.range(0.3)).explain()["stages"] if s["stage"] == "shard_fanout")
    assert stage["workers"] == 2 and stage["overlap"] is True and stage["layout"] == {"replicas": 2}
    seq = build_index(data, "euclidean", shards=3, fanout_workers=0, device="cpu", **KW)
    assert seq.stats()["fanout_workers"] == 0 and seq.stats()["fanout_overlap"] is False
    assert seq.stats()["layout"]["rows"] == "partitioned"
    with pytest.raises(ValueError, match="shards"):
        build_index(data, "euclidean", fanout_workers=2, device="cpu", **KW)
    with pytest.raises(ValueError, match="shards"):
        build_index(data, "euclidean", layout={"replicas": 2}, device="cpu", **KW)
    with pytest.raises(ValueError, match="shards"):
        build_index(data, "euclidean", shards=0, device="cpu", **KW)


def test_search_service_forwards_fanout_workers(corpus):
    data, queries = corpus
    idx = build_index(data, "euclidean", shards=3, device="cpu", **KW)
    assert idx.stats()["fanout_overlap"] is True
    with SearchService(idx, max_batch=4, max_wait_s=0.01, fanout_workers=0) as svc:
        assert idx.fanout_workers == 0 and idx.stats()["fanout_overlap"] is False
        results = [f.result(timeout=60) for f in [svc.submit(q, Query.knn(5)) for q in queries]]
    for r, w in zip(results, idx.knn_batch(queries, 5)):
        same(r, w)                           # sequential both: the counts are equal too


# -- persistence -----------------------------------------------------------------
@pytest.mark.parametrize("mutable", [False, True], ids=["plain", "mutable"])
def test_save_load_cross_loads_both_ways(corpus, tmp_path, mutable):
    data, queries = corpus
    port, ref = pair(data, shards=3, mutable=mutable, compact_threshold=None, layout={"rows": "replicated"})
    if mutable:
        extra = colors_like(n=25, seed=47).astype(np.float64)
        for idx in (port, ref):
            idx.add(extra)
            idx.remove([1, 2, 3])
    port.save(tmp_path / "port")
    ref.save(tmp_path / "ref")
    from_ref = same_grid(load_index(tmp_path / "ref", device="cpu"))
    from_port_self = same_grid(load_index(tmp_path / "port", device="cpu"))
    with enable_x64(True):
        from_port = rload(tmp_path / "port")
    assert type(from_ref) is ShardedIndex and from_ref.layout["rows"] == "replicated"
    assert from_ref.fanout_workers == 0 and from_port.fanout_workers == 0
    np.testing.assert_array_equal(from_ref.ids(), ref.ids())
    np.testing.assert_array_equal(from_port.ids(), port.ids())
    t = quantile_t(data, queries[0], 0.02)
    for a, b in ((from_ref, ref), (from_port_self, port)):
        for g, w in zip(a.search_batch(queries, t), b.search_batch(queries, t)):
            same(g, w)
        for g, w in zip(a.knn_batch(queries, 9), b.knn_batch(queries, 9)):
            same(g, w)
    for g, w in zip(from_port.knn_batch(queries, 9), port.knn_batch(queries, 9)):
        same(g, w, counts=False)
    for g, w in zip(from_port.search_batch(queries, t), port.search_batch(queries, t)):
        np.testing.assert_array_equal(g.ids, w.ids)


def test_load_never_remeasures(tmp_path, monkeypatch):
    from repro_torch.metrics.supermetrics import JensenShannonMetric

    data = colors_like(n=160, seed=48).astype(np.float64)
    idx = build_index(data, "jensen_shannon", n_pivots=5, seed=2, shards=2, mutable=True, device="cpu")
    idx.add(colors_like(n=10, seed=49).astype(np.float64))
    idx.save(tmp_path / "js.idx")

    def boom(*a, **k):
        raise AssertionError("metric evaluated during load")

    monkeypatch.setattr(JensenShannonMetric, "cross", boom)
    monkeypatch.setattr(JensenShannonMetric, "one_to_many", boom)
    back = load_index(tmp_path / "js.idx", device="cpu")
    np.testing.assert_array_equal(back.ids(), idx.ids())


# -- layouts on a grid of four CPU devices ----------------------------------------
@pytest.fixture(scope="module")
def mesh_corpus():
    X = colors_like(n=487, seed=80).astype(np.float64)
    return X[:480], X[480:487]       # Q = 7: exercises the replica padding


@pytest.mark.parametrize("layout", [None, {"replicas": 2}, {"rows": "replicated"}],
                         ids=["partitioned", "replica-groups", "replicated-rows"])
def test_layouts_on_four_devices_equal_reference_and_brute_force(mesh_corpus, layout):
    data, queries = mesh_corpus
    port, ref = pair(data, shards=4, layout=layout)
    port.configure_grid([CPU] * 4)
    t = quantile_t(data, queries[0], 0.03)
    assert port._use_device_filter(np.full(len(queries), t))
    assert_device_bands_separated(port, queries, t)
    got = port.search_batch(queries, t)
    shape = {None: (1, 4), "replicas": (2, 2), "rows": (4, 1)}[None if layout is None else next(iter(layout))]
    assert (port._mesh_replicas, port._mesh_data) == shape
    for g, w, q in zip(got, ref.search_batch(queries, t), queries):
        same(g, w)
        np.testing.assert_array_equal(g.ids, brute_range(q, data, t))
    ts = np.linspace(0.5 * t, 1.5 * t, len(queries))
    assert_device_bands_separated(port, queries, ts)
    for g, w, q, t_q in zip(port.search_batch(queries, ts), ref.search_batch(queries, ts), queries, ts):
        same(g, w)
        np.testing.assert_array_equal(g.ids, brute_range(q, data, t_q))


def test_layouts_clamp_to_one_device(mesh_corpus):
    """On one device (the CPU, or one card) both layouts clamp to the 1 x 1
    grid, as the reference does on its one device, and answer alike."""
    data, queries = mesh_corpus
    t = quantile_t(data, queries[0], 0.03)
    answers = []
    for layout in ({"replicas": 2}, {"rows": "replicated"}):
        idx = build_index(data, "euclidean", shards=4, layout=layout, device="cpu", **KW)
        answers.append(idx.search_batch(queries, t))
        assert (idx._mesh_data, idx._mesh_replicas) == (1, 1)
    for a, b in zip(*answers):
        same(a, b)
