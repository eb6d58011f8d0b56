"""A 0-row query block answers an empty ``BatchQueryResult`` on every kind
and composite of the port: ``kind="nsimplex"``, ``"laesa"``, ``"tree"``,
``mutable=True``, ``shards=2`` and ``durable=True``; exact and approximate
(the tree, which has none, refuses ``mode="approx"`` as the JAX package
does); k-NN and range; through
``query()`` and the ``knn_batch`` / ``search_batch`` shims.  Each case
asserts no exception, no results and zero cost totals.  Where the JAX
package's default path answers (every case but its sharded range, which
raises on a 0-row block), the port's result is held against it.
"""

import numpy as np
import pytest

from repro.api import Query as RQuery, build_index as rbuild
from repro_torch.api import Query, build_index

D = 8
KINDS = {
    "nsimplex": dict(kind="nsimplex"),
    "laesa": dict(kind="laesa"),
    "tree": dict(kind="tree"),
    "mutable": dict(mutable=True),
    "shards2": dict(shards=2),
    "durable": dict(durable=True),
}
#: the reference's sharded range raises on a 0-row block (its device
#: filter's min over no thresholds); the port answers empty
REFERENCE_RAISES = {("shards2", "range")}


@pytest.fixture(scope="module")
def corpus():
    return np.random.default_rng(21).random((300, D))


@pytest.fixture(scope="module", params=sorted(KINDS))
def pair(request, corpus, tmp_path_factory):
    kind = request.param
    kw = dict(KINDS[kind])
    rkw = dict(kw)
    if kind == "durable":
        kw["wal_dir"] = str(tmp_path_factory.mktemp("port") / "wal")
        rkw["wal_dir"] = str(tmp_path_factory.mktemp("ref") / "wal")
    port = build_index(corpus, "euclidean", n_pivots=8, device="cpu", **kw)
    ref = rbuild(corpus, "euclidean", n_pivots=8, **rkw)
    yield kind, port, ref
    for idx in (port, ref):
        if hasattr(idx, "close"):
            idx.close()


def _assert_empty(res):
    assert len(res) == 0 and res.results == []
    assert (res.total_original_calls, res.total_surrogate_calls, res.total_accepted_no_check,
            res.total_candidates) == (0, 0, 0, 0)


@pytest.mark.parametrize("task", ["knn", "range"])
@pytest.mark.parametrize("mode", ["exact", "approx"])
def test_empty_block_answers_empty(pair, mode, task):
    kind, port, ref = pair
    empty = np.empty((0, D))
    extra = dict(mode="approx", dims=4) if mode == "approx" else {}
    spec = Query.knn(5, **extra) if task == "knn" else Query.range(0.3, **extra)
    rspec = RQuery.knn(5, **extra) if task == "knn" else RQuery.range(0.3, **extra)
    if kind == "tree" and mode == "approx":
        # the tree has no approximate mode: both packages refuse the plan
        for idx, s in ((port, spec), (ref, rspec)):
            with pytest.raises(ValueError, match="truncatable surrogate table"):
                idx.query(empty, s)
        return
    got = port.query(empty, spec)
    _assert_empty(got)
    if (kind, task) in REFERENCE_RAISES:
        return
    want = ref.query(empty, rspec)
    assert len(want) == len(got) == 0


@pytest.mark.parametrize("shim", ["knn_batch", "search_batch"])
def test_empty_block_through_the_shims(pair, shim):
    kind, port, ref = pair
    empty = np.empty((0, D))
    got = port.knn_batch(empty, 5) if shim == "knn_batch" else port.search_batch(empty, 0.3)
    _assert_empty(got)
    want = ref.knn_batch(empty, 5) if shim == "knn_batch" else ref.search_batch(empty, 0.3)
    assert len(want) == 0


def test_a_block_after_an_empty_one_still_answers(pair, corpus):
    """The empty block leaves no state behind: the next block answers as
    the reference does."""
    kind, port, ref = pair
    port.query(np.empty((0, D)), Query.knn(5))
    got = port.query(corpus[:3], Query.knn(5))
    want = ref.query(corpus[:3], RQuery.knn(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
