"""The LAESA index, the hyperplane tree and the five-mechanism engine on the
card, against the same structures on the CPU (which the CPU tests hold to
the JAX package).

Marked ``gpu``; without a CUDA device every test skips (the decision is
taken inside the ``cuda`` fixture).  Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_mechanisms.py

LAESA's bounds use only correctly rounded float64 operations, so the card's
equal the CPU's bit for bit; answers are exact on both devices (ids in
(distance, id) order; range thresholds sit between two neighbour distances).
"""

import numpy as np
import pytest
import torch

from repro_torch.api import Query, build_index
from repro_torch.data import colors_like
from repro_torch.index import HyperplaneTree, LaesaIndex
from repro_torch.kernels import LAUNCHES
from repro_torch.search import MECHANISMS, ExactSearchEngine

pytestmark = pytest.mark.gpu

N, Q = 20_000, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def corpus():
    X = colors_like(n=N + Q, dim=112, seed=29)
    return X[:N], X[N:]


def _threshold(index, q, rank=60):
    d = np.sort(index.metric.one_to_many(torch.as_tensor(q), index.data.cpu()).numpy())
    return float(0.5 * (d[rank] + d[rank + 1]))


@pytest.mark.parametrize("name", ["euclidean", "jensen_shannon"])
def test_laesa_on_the_card_equals_the_cpu(cuda, corpus, name):
    data, queries = corpus
    host = build_index(data, name, kind="laesa", n_pivots=20, seed=5, device="cpu")
    card = LaesaIndex.from_state(host._inner.state_arrays(), host.metric, device=cuda)
    qd = host._inner.query_distances_batch(queries)
    for dims in (None, 10):
        qd_ = qd if dims is None else qd[:, :dims]
        for g, w in zip(card.bounds_batch(qd_.to(cuda), dims=dims), host._inner.bounds_batch(qd_, dims=dims)):
            assert torch.equal(g.cpu(), w)
    t = _threshold(host._inner, queries[0])
    for got, want in zip(card.knn_batch(queries, 10, qpd=qd), host._inner.knn_batch(queries, 10, qpd=qd)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[2].candidates == want[2].candidates
    for got, want in zip(card.search_batch(queries, t, qpd=qd), host._inner.search_batch(queries, t, qpd=qd)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1].candidates == want[1].candidates
    qd10 = qd[:, :10]
    for got, want in zip(card.search_approx_batch(queries, t, dims=10, refine=16, qpd=qd10),
                         host._inner.search_approx_batch(queries, t, dims=10, refine=16, qpd=qd10)):
        np.testing.assert_array_equal(got[0], want[0])
    for got, want in zip(card.knn_approx_batch(queries, 10, dims=10, refine=64, qpd=qd10),
                         host._inner.knn_approx_batch(queries, 10, dims=10, refine=64, qpd=qd10)):
        np.testing.assert_array_equal(got[0], want[0])


def test_tree_carried_to_the_card_counts_as_on_the_cpu(cuda, corpus):
    data, queries = corpus
    host = build_index(data[:5000], "jensen_shannon", kind="tree", device="cpu")
    rows = host.data.to(cuda)
    card = HyperplaneTree.from_arrays(rows, lambda q, r: host.metric.one_to_many(q, r), host._tree.to_arrays())
    before = LAUNCHES["jsd_pairwise"]
    for q in queries[:3]:
        for got, want in ((card.knn(q, 10), host._tree.knn(q, 10)),
                          (card.query_with_distances(q, 0.2), host._tree.query_with_distances(q, 0.2))):
            np.testing.assert_array_equal(got[0], want[0])
            assert got[2].surrogate_calls == want[2].surrogate_calls
    assert LAUNCHES["jsd_pairwise"] > before


@pytest.mark.parametrize("name", ["euclidean", "jensen_shannon"])
def test_engine_on_the_card_is_exact(cuda, corpus, name):
    data, queries = corpus
    eng = ExactSearchEngine(data[:8000], name, n_pivots=20, seed=5, device=cuda)
    assert eng.data.is_cuda and eng.laesa.table.is_cuda and eng.nsimplex.table.is_cuda
    host = eng.metric.one_to_many
    d_all = [host(torch.as_tensor(q), torch.as_tensor(data[:8000])).double().numpy() for q in queries]
    t = float(np.sort(d_all[0])[40])
    for mech in MECHANISMS:
        for q, d, rep in zip(queries, d_all, eng.knn_batch(mech, queries, 10)):
            want = np.lexsort((np.arange(d.shape[0]), d))[:10]
            np.testing.assert_allclose(d[rep.results], d[want], rtol=1e-5, atol=1e-7)
        for d, rep in zip(d_all, eng.search_batch(mech, queries, t)):
            diff = np.setxor1d(rep.results, np.flatnonzero(d <= t))
            assert np.all(np.abs(d[diff] - t) <= 1e-6), mech


def test_laesa_build_index_defaults_to_the_card(cuda, corpus):
    data, queries = corpus
    idx = build_index(data[:3000], "euclidean", kind="laesa", n_pivots=8)
    assert idx.device.type == "cuda" and idx.table.is_cuda
    assert len(idx.query(queries, Query.knn(5))) == Q
