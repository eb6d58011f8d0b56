"""Checkpoints of the port (``repro_torch.train.CheckpointManager``) on the
CPU: the twins of ``tests/test_train_infra.py::TestCheckpoint`` (keep-k,
corrupt and uncommitted directories, placement on restore), the on-disk
layout shared with the JAX package (a dict tree of f32 and int32 leaves
written by either package restores in the other bit for bit), a bf16
checkpoint written by the reference's ``save`` restored by the port bit for
bit, and a ``Params`` round trip.  Every comparison is exact."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import CheckpointManager as RefCheckpointManager
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tf
from repro_torch.models.params import tree_flatten, tree_leaves, tree_map
from repro_torch.sharding import to_named_shardings
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import AdamWConfig, CheckpointManager, init_state


def _toy_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((8, 4)).astype(np.float32),
        "b": np.zeros((4,), np.float32),
        "nested": {"u": rng.standard_normal((3,)).astype(np.float32), "i": np.arange(5, dtype=np.int32)},
    }


def _toy(seed=0):
    return jax.tree.map(torch.tensor, _toy_np(seed))


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _toy()
    mgr.save(7, tree)
    got, step = mgr.restore(tree)
    assert step == 7
    _same(tree, got)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _toy())
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000004"]


def test_corrupt_checkpoint_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    tree = _toy()
    mgr.save(1, tree)
    mgr.save(2, jax.tree.map(lambda t: t + 1, tree))
    d = os.path.join(str(tmp_path), "step_0000000002")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, victim), "wb") as f:
        f.write(b"corrupt")
    got, step = mgr.restore(tree)
    assert step == 1  # fell back to the older valid checkpoint
    _same(tree, got)
    with pytest.raises(FileNotFoundError):
        mgr.restore(tree, step=2)


def test_uncommitted_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _toy())
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009"))
    os.makedirs(os.path.join(str(tmp_path), "step_0000000010.tmp"))
    assert mgr.latest_step() == 1
    assert RefCheckpointManager(str(tmp_path)).latest_step() == 1


def test_restore_with_placements(tmp_path):
    """The elastic path: leaves go where ``sharding_tree`` says, here
    ``to_named_shardings`` placements over a (2, 2) mesh of the CPU."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _toy()
    mgr.save(3, tree)
    mesh = make_host_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    from repro_torch.sharding import PartitionSpec as P

    shd = to_named_shardings(jax.tree.map(lambda t: P(*([None] * t.ndim)), tree), mesh)
    got, _ = mgr.restore(tree, sharding_tree=shd)
    _same(tree, got)
    devs = jax.tree.map(lambda t: torch.device("cpu"), tree)
    got, _ = mgr.restore(tree, sharding_tree=devs)
    _same(tree, got)


def test_layout_matches_reference(tmp_path):
    """Leaf names, files, shapes and dtypes in the manifest equal the
    reference's for the same tree, and each .npy file is byte-equal."""
    tree = _toy_np()
    RefCheckpointManager(str(tmp_path / "ref")).save(5, jax.tree.map(jnp.asarray, tree))
    CheckpointManager(str(tmp_path / "port")).save(5, jax.tree.map(torch.tensor, tree))
    ms = []
    for side in ("ref", "port"):
        d = tmp_path / side / "step_0000000005"
        assert sorted(os.listdir(d)) == sorted(os.listdir(tmp_path / "ref" / "step_0000000005"))
        assert (d / "_COMMITTED").read_text() == "ok"
        ms.append(json.loads((d / "manifest.json").read_text()))
    assert ms[0]["leaves"] == ms[1]["leaves"] and ms[0]["step"] == ms[1]["step"] == 5
    for leaf in ms[0]["leaves"]:
        a = (tmp_path / "ref" / "step_0000000005" / leaf["file"]).read_bytes()
        b = (tmp_path / "port" / "step_0000000005" / leaf["file"]).read_bytes()
        assert a == b, leaf["name"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_cross_package_restore(tmp_path, writer):
    """A dict tree of f32 and int32 leaves saved by either package restores
    in the other, bit-equal."""
    tree = _toy_np(3)
    if writer == "ref":
        RefCheckpointManager(str(tmp_path)).save(4, jax.tree.map(jnp.asarray, tree))
        got, step = CheckpointManager(str(tmp_path)).restore(jax.tree.map(torch.zeros_like, _toy(3)))
        _same(jax.tree.map(torch.tensor, tree), got)
    else:
        CheckpointManager(str(tmp_path)).save(4, jax.tree.map(torch.tensor, tree))
        got, step = RefCheckpointManager(str(tmp_path)).restore(jax.tree.map(jnp.zeros_like, tree))
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
            assert np.asarray(b).dtype == a.dtype
            np.testing.assert_array_equal(np.asarray(b), a)
    assert step == 4


def test_reference_bf16_checkpoint_restores_bit_equal(tmp_path):
    """The witness of a fact about the reference: its own ``restore`` cannot
    read a bf16 leaf back (``np.load`` gives ``|V2``, which has no cast to
    bfloat16, so the directory reads as corrupt), while the port restores
    the reference's bf16 checkpoint bit for bit."""
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**16, size=(6, 5), dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] &= 0xBFFF      # no inf / nan patterns
    ref_tree = {"m": jnp.asarray(bits.view(jnp.bfloat16)), "step": jnp.asarray(3, jnp.int32)}
    RefCheckpointManager(str(tmp_path)).save(9, ref_tree)
    with pytest.raises(FileNotFoundError):
        RefCheckpointManager(str(tmp_path)).restore(ref_tree)
    template = {"m": torch.zeros((6, 5), dtype=torch.bfloat16), "step": torch.zeros((), dtype=torch.int32)}
    got, step = CheckpointManager(str(tmp_path)).restore(template)
    assert step == 9 and got["m"].dtype == torch.bfloat16 and int(got["step"]) == 3
    np.testing.assert_array_equal(got["m"].view(torch.int16).numpy().view(np.uint16), bits)


def test_port_bf16_round_trip_in_reference_format(tmp_path):
    t = {"v": torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)}
    CheckpointManager(str(tmp_path)).save(1, t)
    d = tmp_path / "step_0000000001"
    entry = json.loads((d / "manifest.json").read_text())["leaves"][0]
    assert entry["dtype"] == "bfloat16" and np.load(d / entry["file"]).dtype.itemsize == 2
    got, _ = CheckpointManager(str(tmp_path)).restore({"v": torch.zeros(4, 3, dtype=torch.bfloat16)})
    _same(t, got)


def test_params_round_trip(tmp_path):
    """A transformer's ``Params`` and its bf16 AdamW state, flattened by the
    module names (``layers##0##attn##wq``), restored bit-equal into a
    ``Params`` whose leaves keep ``requires_grad``."""
    cfg = dataclasses.replace(get_arch("qwen2-1.5b").smoke_cfg, dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator().manual_seed(1), device="cpu").requires_grad_(True)
    opt = init_state(AdamWConfig(), params)
    opt["m"] = tree_map(lambda t: t + 0.5, opt["m"])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, (params, opt))
    names = [l["name"] for l in json.loads((tmp_path / "step_0000000002" / "manifest.json").read_text())["leaves"]]
    assert "0##layers##0##attn##wq" in names and "1##m##embed" in names and "1##step" in names
    assert names == ["##".join(map(str, p)) for p in tree_flatten((params, opt))[0]]
    template = (tf.init_params(cfg, device="cpu").requires_grad_(True), init_state(AdamWConfig(), params))
    (p2, o2), step = mgr.restore(template)
    assert step == 2 and type(p2) is type(params) and len(p2["layers"]) == cfg.n_layers
    _same(params, p2)
    _same(opt, o2)
    assert all(t.requires_grad for t in p2.parameters())
    assert not any(t.requires_grad for t in tree_leaves(o2))
