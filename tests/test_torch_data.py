"""The port's data generators, neighbour sampler and batch pipeline
(``repro_torch.data``) against the JAX package's ``repro.data``.

* Every synthetic generator gives arrays bit-equal to the reference's for
  the same arguments and seed (numpy ``default_rng`` code in both).
* ``NeighborSampler`` draws the reference's neighbours.
* Twin of ``tests/test_extended.py::TestPipelineDeterminism``: the same
  (seed, step) gives the same batch, two processes' slices make the
  one-process batch, and each slice equals the reference's; a placed
  batch lies on the grid's devices, rows split over ``data`` and
  replicated across replica groups.
"""

import numpy as np
import pytest
import torch

from repro.data import synthetic as rsyn
from repro.data.graph_sampler import NeighborSampler as RSampler
from repro.data.pipeline import ShardedBatchPipeline as RPipeline
from repro_torch.data import NeighborSampler, ShardedBatchPipeline, synthetic as syn
from repro_torch.sharding import ShardLayout, make_scaleout_mesh

GENERATOR_CASES = [
    ("uniform_cube", dict(n=500, dim=12, seed=3)),
    ("uniform_cube", dict()),
    ("colors_like", dict(n=400, seed=9)),
    ("token_stream", dict(batch=3, seq_len=40, vocab=512, seed=1)),
    ("token_stream", dict(batch=2, seq_len=17, vocab=151_936, seed=0)),
    ("criteo_like_batch", dict(batch=64, seed=2)),
    ("criteo_like_batch", dict(batch=16, n_sparse=6, vocab_sizes=np.array([50, 40, 30, 20, 10, 8]), seed=5)),
    ("default_vocab_sizes", dict(n_sparse=39)),
    ("default_vocab_sizes", dict(n_sparse=6)),
    ("default_vocab_sizes", dict(n_sparse=60)),
    ("user_history_batch", dict(batch=9, seq_len=12, n_items=500, seed=4)),
    ("random_graph", dict(n_nodes=300, n_edges=1200, d_feat=16, n_classes=5, seed=6)),
    ("cora_like", dict(seed=0)),
    ("molecule_batch", dict(batch=8, n_nodes=12, n_edges=20, d_feat=32, seed=7)),
]


def _flatten(out):
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, tuple):
        return list(out)
    return [out]


@pytest.mark.parametrize("name,kw", GENERATOR_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(GENERATOR_CASES)])
def test_generator_arrays_bit_equal(name, kw):
    got, want = _flatten(getattr(syn, name)(**kw)), _flatten(getattr(rsyn, name)(**kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_neighbor_sampler_equal_reference():
    """Uniform in-neighbour draws, self-fill for a node with none."""
    _, ei, _ = rsyn.random_graph(400, 1500, 4, seed=8)
    ei = ei[:, ei[1] != 7]                        # node 7 has no in-neighbours
    got, want = NeighborSampler(ei, 400, seed=3), RSampler(ei, 400, seed=3)
    nodes = np.array([7, 0, 1, 399, 7])
    np.testing.assert_array_equal(got.sample_neighbors(nodes, 6), want.sample_neighbors(nodes, 6))
    assert (got.sample_neighbors(np.array([7]), 3) == 7).all()
    want.sample_neighbors(np.array([7]), 3)
    for a, b in zip(got.sample_batch(np.arange(16), [4, 2]), want.sample_batch(np.arange(16), [4, 2])):
        np.testing.assert_array_equal(a, b)


def _make(gb, seed, step):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(gb, 4)).astype(np.float32), "y": rng.integers(0, 9, size=gb)}


def test_same_step_same_batch():
    p1 = ShardedBatchPipeline(64, _make, seed=3)
    p2 = ShardedBatchPipeline(64, _make, seed=3, process_index=0, process_count=1)
    np.testing.assert_array_equal(p1.local_slice(7)["x"], p2.local_slice(7)["x"])
    assert not np.array_equal(p1.local_slice(7)["x"], p1.local_slice(8)["x"])
    ref = RPipeline(64, _make, seed=3, process_index=0, process_count=1)
    for k in ("x", "y"):
        np.testing.assert_array_equal(p1.local_slice(7)[k], ref.local_slice(7)[k])


def test_elastic_reslice_covers_global_batch():
    """2 processes' slices == 1 process's full batch, each slice equal to
    the reference's."""
    full = ShardedBatchPipeline(32, _make, seed=1, process_index=0, process_count=1)
    parts = [ShardedBatchPipeline(32, _make, seed=1, process_index=i, process_count=2) for i in range(2)]
    combined = np.concatenate([p.local_slice(5)["x"] for p in parts])
    np.testing.assert_array_equal(combined, full.local_slice(5)["x"])
    for i, p in enumerate(parts):
        ref = RPipeline(32, _make, seed=1, process_index=i, process_count=2)
        np.testing.assert_array_equal(p.local_slice(5)["x"], ref.local_slice(5)["x"])
    with pytest.raises(ValueError, match="divide evenly"):
        ShardedBatchPipeline(33, _make, process_count=2)


@pytest.mark.parametrize("replicas", [1, 2])
def test_placed_batch_on_the_grid(replicas):
    """The JAX package assembles the global array from each process's slice
    (``make_array_from_process_local_data``); the port places the slice on
    its one-process grid: rows over ``data``, replicated over replicas."""
    grid = make_scaleout_mesh(ShardLayout(replicas=replicas), devices=[torch.device("cpu")] * 4)
    pipe = ShardedBatchPipeline(32, _make, seed=2, sharding=grid, process_index=1, process_count=2)
    placed, local = pipe(3), pipe.local_slice(3)
    for k in ("x", "y"):
        assert len(placed[k]) == replicas and len(placed[k][0]) == 4 // replicas
        for group in placed[k]:
            np.testing.assert_array_equal(torch.cat(group).numpy(), local[k])
    with pytest.raises(ValueError, match="multiple of the data axis"):
        ShardedBatchPipeline(7, _make, sharding=grid)(0)
