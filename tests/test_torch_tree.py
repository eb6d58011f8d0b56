"""The port's hyperplane tree (``kind="tree"``) against the JAX package's, on
the CPU, for all five metrics; and tie order on duplicated rows for the
``laesa`` and ``tree`` kinds.

Both packages build over the same float64 corpus (1000 rows, dim 24) with
the same seed, so they draw the same pivots in the same order.  Answers are
held to identical ids in (distance, id) order with distances within 1e-12.
The tree's structure (``to_arrays``) and its call counts are held equal
too, except for the cosine chord: there a row against itself comes out as
0 or as ~2e-8 depending on how ``2 - 2 cos`` rounds (the reference's numpy
product gave 0 for row 618 and pivot 2 at this seed, the port's ~2.1e-8),
which moves the ``d > 1e-12`` pivot draw and so the shape of the tree.  For
every metric a tree carried across from the reference through
``from_arrays`` is held to the reference's counts, which isolates the
traversal from the build.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.compat import enable_x64
from repro.data import colors_like
from repro.metrics import get_metric as rget
from repro.metrics.supermetrics import QuadraticFormMetric as RQuadratic
from repro_torch.api import Query, build_index, load_index
from repro_torch.index import HyperplaneTree
from repro_torch.index.knn import knn_select
from repro_torch.metrics import get_metric

# small shapes: one intra-op thread keeps these tests from crowding the
# other pytest workers
torch.set_num_threads(1)

N, Q, DIM, LEAF, SEED = 1000, 6, 24, 64, 3
METRICS = ["euclidean", "cosine", "jensen_shannon", "triangular", "quadratic_form"]
#: metrics whose self-distance is exactly 0 in both packages at this seed
SAME_SHAPE = [m for m in METRICS if m != "cosine"]
F64 = dict(rtol=1e-12, atol=1e-12)


def _stats(s):
    return dataclasses.astuple(s)[:4]


def metric_pair(name):
    if name == "quadratic_form":
        W = RQuadratic.random(DIM, seed=4).W
        return get_metric(name, W=np.asarray(W)), RQuadratic(W)
    return get_metric(name), rget(name)


@pytest.fixture(scope="module")
def corpus():
    X = colors_like(n=N + Q, dim=DIM, seed=19).astype(np.float64)
    return X[:N], X[N:]


@pytest.fixture(scope="module", params=METRICS)
def trees(request, corpus):
    data, queries = corpus
    pm, rm = metric_pair(request.param)
    with enable_x64(True):
        ref = rapi.build_index(data, rm, kind="tree", leaf_size=LEAF, seed=SEED)
        d = np.sort(rm.one_to_many_np(queries[0], data))
    port = build_index(data, pm, kind="tree", leaf_size=LEAF, seed=SEED, device="cpu")
    t = float(0.5 * (d[30] + d[31]))
    return request.param, port, ref, queries, t


def _same(got, want, stats=True, dists=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        if dists:
            np.testing.assert_allclose(g.distances, w.distances, **F64)
        if stats:
            assert _stats(g.stats) == _stats(w.stats)


@pytest.mark.parametrize("trees", SAME_SHAPE, indirect=True)
def test_structure_equals_reference(trees):
    _, port, ref, *_ = trees
    got, want = port._tree.to_arrays(), ref._tree.to_arrays()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if w.dtype == np.int64:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], w, err_msg=key, **F64)
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("k", [1, 10, 100])
def test_knn_equals_reference(trees, k):
    name, port, ref, queries, _ = trees
    with enable_x64(True):
        want = list(ref.query(queries, rapi.Query.knn(k))) + [ref.query(queries[0], rapi.Query.knn(k))]
    got = list(port.query(queries, Query.knn(k))) + [port.query(queries[0], Query.knn(k))]
    _same(got, want, stats=name in SAME_SHAPE)


def test_range_equals_reference(trees):
    name, port, ref, queries, t = trees
    with enable_x64(True):
        want = list(ref.query(queries, rapi.Query.range(t))) + [ref.query(queries[0], rapi.Query.range(t))]
    got = list(port.query(queries, Query.range(t))) + [port.query(queries[0], Query.range(t))]
    _same(got, want, stats=name in SAME_SHAPE)


def test_carried_tree_counts_equal_reference(trees, tmp_path):
    """A reference-saved directory loads into the port (``from_arrays``, no
    re-measuring) and answers and counts as the reference; a port-saved one
    loads into the reference and answers as the port."""
    name, port, ref, queries, t = trees
    ref.save(tmp_path / "ref")
    port.save(tmp_path / "port")
    carried = load_index(tmp_path / "ref", device="cpu")
    for key, w in ref._tree.to_arrays().items():
        np.testing.assert_array_equal(carried._tree.to_arrays()[key], w)
    with enable_x64(True):
        back = rapi.load_index(tmp_path / "port")
        assert carried.stats() == rapi.load_index(tmp_path / "ref").stats()
        for spec, rspec in ((Query.knn(10), rapi.Query.knn(10)), (Query.range(t), rapi.Query.range(t))):
            _same(list(carried.query(queries, spec)), list(ref.query(queries, rspec)))
            _same(list(back.query(queries, rspec)), list(port.query(queries, spec)))


def test_rowmask_post_filter_equals_reference(trees):
    _, port, ref, queries, t = trees
    mask = np.zeros(N, dtype=bool)
    mask[1::4] = True
    with enable_x64(True):
        want = [ref._exec_knn(q, 10, None, rowmask=mask) for q in queries[:2]]
        want.append(ref._exec_search(queries[0], t, None, rowmask=mask))
    got = [port._exec_knn(q, 10, None, rowmask=mask) for q in queries[:2]]
    got.append(port._exec_search(queries[0], t, None, rowmask=mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.distances, w.distances, **F64)


def test_tree_has_no_approximate_path(trees):
    _, port, _, queries, _ = trees
    with pytest.raises(ValueError, match="truncatable"):
        port.query(queries, Query.knn(3, mode="approx", dims=2))
    with pytest.raises(ValueError, match="approximate"):
        port._exec_knn(queries[0], 3, {"dims": 2, "refine": 5})


def test_generic_tree_over_a_table_space():
    """The tree over rows with a Chebyshev distance and no Hilbert rule
    (the L_rei configuration): structure and answers as the reference."""
    from repro.index.hyperplane_tree import HyperplaneTree as RTree

    rows = np.random.default_rng(7).random((700, 6))
    ref = RTree(rows, lambda q, r: np.max(np.abs(r - q[None, :]), axis=1), supermetric=False, leaf_size=8, seed=1)
    port = HyperplaneTree(torch.tensor(rows), lambda q, r: (r - q[None, :]).abs().amax(dim=1),
                          supermetric=False, leaf_size=8, seed=1)
    for key, w in ref.to_arrays().items():
        np.testing.assert_array_equal(port.to_arrays()[key], w)
    assert port.build_calls == ref.build_calls
    for q in rows[:5] + 0.01:
        for got, want in ((port.knn(q, 7), ref.knn(q, 7)), (port.query_with_distances(q, 0.2),
                                                            ref.query_with_distances(q, 0.2))):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert _stats(got[2]) == _stats(want[2])


@pytest.mark.parametrize("kind", ["laesa", "tree"])
def test_ties_broken_by_id(kind):
    """Duplicate rows force exact distance ties at the k-th position; the
    (distance, id) order must match the oracle and the reference (the JAX
    package's own test corpus and seed)."""
    base = colors_like(n=80, seed=11)
    data = np.concatenate([base, base, base[:40]])      # every row duplicated
    rm = rget("euclidean")
    port = build_index(data, "euclidean", kind=kind, n_pivots=6, seed=1, device="cpu")
    ref = rapi.build_index(data, rm, kind=kind, n_pivots=6, seed=1)
    queries = np.concatenate([base[:4], colors_like(n=90, seed=12)[80:84]])
    for k in (1, 3, 80, 100):
        for q in queries:
            d = rm.one_to_many_np(q, data)
            want_ids, want_d = knn_select(d, np.arange(len(d), dtype=np.int64), k)
            got = port.query(q, Query.knn(k))
            np.testing.assert_array_equal(got.ids, want_ids)
            np.testing.assert_array_equal(got.ids, ref.knn(q, k).ids)
            np.testing.assert_allclose(got.distances, want_d, rtol=1e-6)
