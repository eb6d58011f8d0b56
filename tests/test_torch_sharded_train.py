"""The sharded LM train step over a mesh of processes, on the CPU.

Four ``gloo`` processes (``python -m repro_torch.launch.process_train``,
each with its own ``RANK``) on a (2, 2) ``(data, model)`` mesh run the
reference's sharded test's reduced mixtral (d_model 64, d_ff 128, vocab
512, batch 8 x 32; ``tests/test_sharding.py::test_lm_train_step_runs_sharded``),
and four on a (4, 1) mesh the dense qwen2 smoke config with bf16 AdamW
moments.  Held:

* every leaf's shards gathered back equal the leaf (and, without a process
  group, the ranks' ``place`` slices concatenate to it);
* the first loss equals the one-process port's and the JAX package's
  (``loss_fn`` on the same parameters through ``convert.to_reference``)
  at rtol 5e-4, the reference test's tolerance;
* after 4 steps every parameter equals the one-process port's at 1e-5
  (f32 sums in another order: the per-rank gradients are summed across
  ranks), the gradient norms (the clip's global norm, each element
  counted once) at 1e-5 relative, and the loss has fallen;
* int8 compression of shards scales by the whole leaf (bit-equal).

The launcher's subprocesses have their own limit (``--timeout``) inside
the test's.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch
from repro.models import transformer as rtf
from repro_torch.configs import get_arch
from repro_torch.data import token_stream
from repro_torch.launch import process_train, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.convert import to_reference
from repro_torch.models.params import tree_flatten, tree_leaves
from repro_torch.sharding import NamedSharding, PartitionSpec, lm_param_specs, to_named_shardings
from repro_torch.sharding.rules import ProcessMesh
from repro_torch.train import AdamWConfig, init_state

#: (arch, data, model, config overrides, AdamW moment dtype)
RUNS = [
    ("mixtral-8x7b", 2, 2, {"d_model": 64, "d_ff": 128, "vocab": 512}, "float32"),
    ("qwen2-1.5b", 4, 1, {}, "bfloat16"),
]
_FLAGS = {"d_model": "--d-model", "d_ff": "--d-ff", "vocab": "--vocab"}


def _cfg(arch, over, get=get_arch):
    return dataclasses.replace(get(arch).smoke_cfg, **over)


def _one_process(cfg, moments, steps_n=4):
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = AdamWConfig(moment_dtype=moments, lr=1e-3)
    opt = init_state(opt_cfg, params)
    toks, labs = token_stream(8, 32, cfg.vocab, seed=0)
    step = steps.lm_train_step(cfg, opt_cfg)
    losses = []
    for _ in range(steps_n):
        params, opt, m = step(params, opt, torch.as_tensor(toks)[None], torch.as_tensor(labs)[None])
        losses.append(float(m["loss"]))
    return params, losses


@pytest.mark.parametrize("arch,data,model,over,moments", RUNS)
def test_sharded_step_matches_one_process_and_jax(tmp_path, capsys, arch, data, model, over, moments):
    argv = ["--arch", arch, "--smoke", "--data", str(data), "--model", str(model), "--backend", "gloo",
            "--steps", "4", "--check", "--out", str(tmp_path), "--timeout", "240", "--moment-dtype", moments]
    for k, v in over.items():
        argv += [_FLAGS[k], str(v)]
    assert process_train.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["world"] == data * model and got["mesh"] == [data, model]
    assert got["shards_rebuild_leaves"] and got["compress_max_diff"] == 0.0
    losses = got["losses"]
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]

    cfg = _cfg(arch, over)
    params, one_losses = _one_process(cfg, moments)
    np.testing.assert_allclose(losses[0], one_losses[0], rtol=5e-4)
    np.testing.assert_allclose(got["one_process_losses"], one_losses, rtol=1e-6)
    np.testing.assert_allclose(got["grad_norms"], got["one_process_grad_norms"], rtol=1e-5)
    assert got["max_param_diff"] <= 1e-5

    # every rank's saved shards against the one-process parameters' cuts
    paths, leaves = tree_flatten(params)
    for mesh in _rank_meshes(data, model):
        mine = torch.load(tmp_path / f"rank{mesh.rank}.pt")["train"]
        specs = tree_leaves(steps.lm_step_specs(cfg, mesh)[0], is_leaf=lambda x: isinstance(x, PartitionSpec))
        assert len(mine) == len(paths)
        for p, leaf, spec in zip(paths, leaves, specs, strict=True):
            np.testing.assert_allclose(mine["/".join(map(str, p))].numpy(),
                                       NamedSharding(mesh, spec).cut(leaf.detach()).numpy(), rtol=1e-5, atol=1e-5)

    # the JAX package's loss on the same initial parameters and batch
    init = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rparams = to_reference(cfg, init)
    toks, labs = token_stream(8, 32, cfg.vocab, seed=0)
    rcfg = _cfg(arch, over, rget_arch)
    l_ref, _ = rtf.loss_fn(rparams, rcfg, jnp.asarray(toks), jnp.asarray(labs))
    np.testing.assert_allclose(losses[0], float(l_ref), rtol=5e-4)


def _rank_meshes(data, model):
    devs = (torch.device("cpu"),) * (data * model)
    return [ProcessMesh(("data", "model"), (data, model), devs, rank=r) for r in range(data * model)]


def _concat(pieces, spec, mesh0):
    """The leaf from every rank's ``place`` slice: split dims concatenated
    in chunk order (ranks that differ only on unused axes hold equal
    slices)."""
    out = {}
    for mesh, piece in pieces:
        key = tuple(mesh.axis_index(e if isinstance(e, tuple) else (e,)) if e else 0 for e in spec)
        assert key not in out or torch.equal(out[key], piece)
        out[key] = piece

    def build(prefix, d):
        if d == len(spec):
            return out[tuple(prefix)]
        k = mesh0.axis_size(spec[d] if isinstance(spec[d], tuple) else (spec[d],)) if spec[d] else 1
        return torch.cat([build(prefix + [i], d + 1) for i in range(k)], dim=d)

    return build([], 0)


@pytest.mark.parametrize("data,model", [(2, 2), (4, 1), (1, 4), (2, 1)])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-1.5b"])
def test_shards_concatenate_to_the_leaf(data, model, arch):
    """Without a process group: each rank's ``place`` slice under the
    reference's specs, concatenated over the split dims, is the leaf."""
    over = {"d_model": 64, "d_ff": 128, "vocab": 512} if arch == "mixtral-8x7b" else {}
    cfg = _cfg(arch, over)
    params = tf.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    meshes = _rank_meshes(data, model)
    specs = lm_param_specs(params, meshes[0], n_experts=cfg.moe.n_experts if cfg.moe else None)
    spec_leaves = tree_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    split = 0
    for leaf, spec in zip(tree_leaves(params), spec_leaves):
        pieces = [(m, NamedSharding(m, spec).place(leaf)) for m in meshes]
        split += pieces[0][1].numel() < leaf.numel()
        torch.testing.assert_close(_concat(pieces, spec, meshes[0]), leaf, rtol=0, atol=0)
        assert all(p.is_contiguous() for _, p in pieces)
    assert split > 0


def test_process_mesh_coordinates_are_row_major():
    meshes = _rank_meshes(2, 2)
    assert [m.coords for m in meshes] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [m.axis_index(("data",)) for m in meshes] == [0, 0, 1, 1]
    assert [m.axis_index(("model",)) for m in meshes] == [0, 1, 0, 1]
    assert [m.axis_index(("data", "model")) for m in meshes] == [0, 1, 2, 3]
    with pytest.raises(NotImplementedError, match="order"):
        meshes[0].axis_index(("model", "data"))
    assert NamedSharding(meshes[0], PartitionSpec("data", None)).replicas == 2
    assert NamedSharding(meshes[0], PartitionSpec(None, None)).replicas == 4


def test_place_refuses_a_dim_that_does_not_split():
    m = _rank_meshes(2, 2)[0]
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(m, PartitionSpec("data", None)).place(torch.ones(3, 2))


@pytest.mark.parametrize("arch,shape,item", [
    ("gcn-cora", None, "11c.4"),
    ("fm", None, "11c.4"),
])
def test_other_cells_refuse_a_process_mesh(arch, shape, item):
    """A GCN or RecSys cell builds on a ProcessMesh with the host mesh's
    arguments and specs (the process groups are looked up only when the
    step runs; the runs themselves are
    tests/test_torch_process_recsys_gcn.py's)."""
    mesh = _rank_meshes(2, 2)[0]
    shape = shape or next(iter(get_arch(arch).shapes))
    plan = steps.build_cell(arch, shape, mesh)
    one = steps.build_cell(arch, shape, make_host_mesh(2, 2, devices=[torch.device("cpu")] * 4))
    assert plan.kind == one.kind == "train" and callable(plan.fn) and plan.in_specs == one.in_specs
    assert [tuple(a.shape) for a in tree_leaves(plan.args)] == [tuple(a.shape) for a in tree_leaves(one.args)]


@pytest.mark.parametrize("opt", [False, True])
@pytest.mark.parametrize("arch,shape", [
    ("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "prefill_32k"), ("qwen2-1.5b", "decode_32k"),
    ("mixtral-8x7b", "train_4k"), ("mixtral-8x7b", "prefill_32k"), ("mixtral-8x7b", "decode_32k"),
])
def test_lm_cells_build_on_a_process_mesh(arch, shape, opt):
    """Every LM cell, opt or not, returns a step on a ProcessMesh (the
    process groups are looked up only when a step runs)."""
    plan = steps.build_cell(arch, shape, _rank_meshes(2, 2)[0], opt=opt)
    assert plan.kind == get_arch(arch).shapes[shape].kind and callable(plan.fn)


def test_several_devices_in_one_process_name_the_process_mesh():
    from repro_torch.launch.mesh import DeviceMesh

    mesh = DeviceMesh(("data", "model"), (2, 1), (torch.device("cpu"), torch.device("meta")))
    with pytest.raises(NotImplementedError, match="make_process_mesh"):
        to_named_shardings({"w": PartitionSpec("data", None)}, mesh)


def test_one_process_meshes_still_place_whole():
    """A mesh of one distinct device in one process keeps placing leaves
    whole (the single-process cells), and its step is the one-process step."""
    mesh = make_host_mesh(2, 2, devices=[torch.device("cpu")] * 4)
    shd = to_named_shardings({"w": PartitionSpec("data", "model")}, mesh)
    assert torch.equal(shd["w"].place(torch.ones(4, 4)), torch.ones(4, 4))


def test_local_moe_dispatch_refuses_a_batch_group():
    """Local dispatch splits the whole batch into n_batch_shards shards,
    n_batch_shards / |group| on each rank of the batch group: a group whose
    size does not divide them is refused rather than given other shards."""
    from repro_torch.models import layers

    cfg = layers.MoEConfig(n_experts=4, top_k=2, d_ff=8, dispatch="local", n_batch_shards=2)
    with pytest.raises(ValueError, match="multiple of 3"):
        layers._dispatch_shards(cfg, 4, 3)
    assert layers._dispatch_shards(cfg, 4, 2) == (1, 4, 4, False)
