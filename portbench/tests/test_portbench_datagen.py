import numpy as np

from portbench.datagen import corpus_rows, query_rows

GEN = {"mixture_seed": 20170726, "n_clusters": 24, "latent": 10, "noise": 0.002}


def test_same_seed_same_queries_and_one_corpus_for_every_seed():
    assert np.array_equal(query_rows(2**31 + 17, 40, **GEN), query_rows(2**31 + 17, 40, **GEN))
    assert not np.array_equal(query_rows(2**31 + 17, 40, **GEN), query_rows(2**31 + 18, 40, **GEN))
    assert np.array_equal(corpus_rows(500, **GEN), corpus_rows(500, **GEN))
    assert not np.array_equal(corpus_rows(500, **GEN), corpus_rows(500, **dict(GEN, mixture_seed=1)))


def test_corpus_does_not_depend_on_the_query_count_or_the_seed():
    X = corpus_rows(800, **GEN)
    query_rows(7, 10, **GEN)
    assert np.array_equal(X, corpus_rows(800, **GEN))
    assert query_rows(7, 10, **GEN).shape == (10, 112) and query_rows(7, 300, **GEN).shape == (300, 112)


def test_rows_are_histograms_and_queries_are_held_out_of_the_mixture():
    X = corpus_rows(2000, **GEN)
    Q = query_rows(3, 200, **GEN)
    for A in (X, Q):
        assert A.dtype == np.float32 and np.all(A > 0)
        assert np.allclose(A.sum(axis=1), 1.0, atol=1e-5)
    assert not any(np.array_equal(q, x) for q in Q[:20] for x in X)
    # held-out queries lie near the corpus: their nearest row is far closer
    # than a typical pair
    d_nn = np.sqrt(((Q[:50, None, :] - X[None, :, :]) ** 2).sum(-1)).min(axis=1)
    d_typ = np.sqrt(((X[:50] - X[50:100]) ** 2).sum(-1))
    assert np.median(d_nn) < 0.5 * np.median(d_typ)
