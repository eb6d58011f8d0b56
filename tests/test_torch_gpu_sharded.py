"""The sharded composite and its distributed filter on the card.

Marked ``gpu``; without a CUDA device every test skips (decided inside the
``cuda`` fixture).  Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_sharded.py

Held: the distributed filter's K3 slots, codes and histogram bit-equal to
its plain version on the card (``selection="sort"``: K1's own f32 bounds and
a stable sort), at slot counts on both sides of a device's row count and of
K3's 4,096 (its global-memory plan above), on grids of one and two positions of the card; a sharded index
built on the card (nsimplex, laesa and tree; plain and mutable) answering
k-NN and range exactly as the same index on the CPU, with the same counts,
and its range batches launching K3 from the device filter.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import build_index
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.search import distributed
from repro_torch.sharding import ShardLayout, make_scaleout_mesh

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


def _apexes(N, n, seed, device):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(N, n)) * 0.3
    a[:, -1] = np.abs(a[:, -1])
    return torch.tensor(a, dtype=torch.float32, device=device)


#: (rows, grid positions, slots): slots on both sides of each position's
#: rows (3,001 or 6,001) and of K3's 4,096
CASES = [(6002, 2, k) for k in (1, 256, 3000, 3001, 3002)] + [(12_002, 2, k) for k in (4095, 4096, 4097, 6000)] + [
    (6001, 1, k) for k in (4096, 6000, 6001, 6002)]


@pytest.mark.parametrize("rows,positions,k", CASES)
def test_filter_slots_bit_equal_to_plain(cuda, rows, positions, k):
    table = _apexes(rows, 20, 1, cuda)
    queries = _apexes(64, 20, 2, cuda)
    lwb, _ = ops.apex_bounds_batch(table, queries)
    # per query a threshold at its (k // 2)-th and (2k)-th lower bound in turn
    srt = torch.sort(lwb, dim=1).values
    pick = torch.tensor([max(0, min(rows - 1, (k // 2 if q % 2 else 2 * k))) for q in range(64)], device=cuda)
    t = srt[torch.arange(64, device=cuda), pick].contiguous()
    mesh = make_scaleout_mesh(ShardLayout(), [cuda] * positions)
    before = LAUNCHES["apex_threshold"]
    got = distributed.build_distributed_filter(mesh, max_candidates=k)(table, queries, t)
    k3 = LAUNCHES["apex_threshold"] - before
    assert k3 == positions                        # K3 at every width, as the reference's lax.top_k
    want = distributed.build_distributed_filter(mesh, max_candidates=k, selection="sort")(table, queries, t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[0].sum(dim=1) == rows).all())


def test_replica_groups_on_the_card_equal_one_group(cuda):
    table, queries = _apexes(8000, 20, 3, cuda), _apexes(64, 20, 4, cuda)
    t = torch.full((64,), 1.0, device=cuda)
    one = distributed.build_distributed_filter(make_scaleout_mesh(ShardLayout(), [cuda] * 2), max_candidates=512)
    two = distributed.build_distributed_filter(make_scaleout_mesh(ShardLayout(replicas=2), [cuda] * 4),
                                               max_candidates=512)
    for g, w in zip(one(table, queries, t), two(table, queries, t)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind,mutable", [("nsimplex", False), ("nsimplex", True), ("laesa", False),
                                          ("laesa", True), ("tree", False)])
def test_sharded_index_on_card_equals_cpu(cuda, kind, mutable):
    rng = np.random.default_rng(5)
    X = rng.random((4008, 24))
    data, queries = X[:4000], X[4000:]
    kw = dict(kind=kind, n_pivots=12, seed=3, shards=4, mutable=mutable, fanout_workers=0)
    card = build_index(data, "euclidean", device="cuda", **kw)
    host = build_index(data, "euclidean", device="cpu", **kw)
    if mutable:
        for idx in (card, host):
            idx.add(X[:64] + 0.01)
            idx.remove(np.arange(100, 164))
    for k in (1, 10, 100):
        for g, w in zip(card.knn_batch(queries, k), host.knn_batch(queries, k)):
            np.testing.assert_array_equal(g.ids, w.ids)
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-12, atol=1e-12)
    d = np.linalg.norm(data - queries[0], axis=1)
    t = float(np.sort(d)[40] + np.sort(d)[41]) / 2
    before = LAUNCHES["apex_threshold"]
    got, want = card.search_batch(queries, t), host.search_batch(queries, t)
    if kind == "nsimplex":
        assert card._filter_fn is not None and LAUNCHES["apex_threshold"] > before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert g.stats.original_calls == w.stats.original_calls
