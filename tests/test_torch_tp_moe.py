"""Tensor-parallel MoE over ``model`` on a process mesh, on the CPU: the
reference's reduced mixtral (d_model 64, d_ff 128, vocab 512, window 32;
``tests/test_sharding.py``'s sharded test) through ``python -m
repro_torch.launch.process_train --mode train,decode --check``:

* (2, 2) with its 4 experts over ``model`` (2 per rank) and FSDP over
  ``data``: the global dispatch's capacity and slots of the whole batch
  (``moe_ffn(group=)``) with each rank's experts;
* (1, 4) with 8 experts (8 >= 4: 2 per rank), the 2 kv heads gathered
  over ``model``.

Held: the shards gather back to their leaves; after 4 train steps every
parameter equals the one-process port's at 1e-5 (and every rank's saved
shards this test's replay), the first loss the JAX package's at 5e-4; the
prefill logits and every decode step's logits (4 steps across the
window's ring) equal the one-process port's and the JAX package's at
1e-4, every rank's cache the one-process cache's cut.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch
from repro.models import transformer as rtf
from repro_torch.configs import get_arch
from repro_torch.data import token_stream
from repro_torch.launch import process_train, steps
from repro_torch.models import transformer as tf
from repro_torch.models.convert import to_reference
from repro_torch.models.params import tree_flatten
from repro_torch.sharding import PartitionSpec
from repro_torch.sharding.rules import NamedSharding, ProcessMesh
from repro_torch.train import AdamWConfig, init_state

ARCH, B, S, DEC = "mixtral-8x7b", 8, 32, 4
OVER = {"d_model": 64, "d_ff": 128, "vocab": 512}
#: (data, model, experts)
RUNS = [(2, 2, 4), (1, 4, 8)]


def _cfg(experts, get=get_arch):
    cfg = dataclasses.replace(get(ARCH).smoke_cfg, **OVER)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=experts))


def jax_tree(tree):
    """The reference's pytree as JAX arrays of copies (``to_reference``
    gives numpy views of the port's tensors)."""
    return jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)), tree)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Both runs' records and ranks' saved files, from one start of the 4
    ranks (``--then``: a second mesh of the same world)."""
    argv, outs = [], []
    for i, (data, model, experts) in enumerate(RUNS):
        outs.append(tmp_path_factory.mktemp(f"tp_moe_{data}x{model}"))
        argv += ([process_train.THEN] if i else []) + [
            "--arch", ARCH, "--smoke", "--d-model", "64", "--d-ff", "128", "--vocab", "512",
            "--n-experts", str(experts), "--data", str(data), "--model", str(model), "--backend", "gloo",
            "--mode", "train,decode", "--steps", "4", "--decode-steps", str(DEC), "--check", "--out", str(outs[-1]),
            "--timeout", "240"]
    rc, recs, bad = process_train.launch(argv)
    assert rc == 0, bad
    return [(rec, [torch.load(out / f"rank{r}.pt") for r in range(4)]) for rec, out in zip(recs, outs, strict=True)]


@pytest.fixture(scope="module", params=RUNS, ids=lambda r: f"{r[0]}x{r[1]}-E{r[2]}")
def run(request, launched):
    data, model, experts = request.param
    rec, saved = launched[RUNS.index(request.param)]
    assert rec["mesh"] == [data, model]
    return data, model, experts, rec, saved


def test_train_matches_one_process_and_jax(run):
    data, model, experts, rec, saved = run
    assert rec["shards_rebuild_leaves"] and rec["compress_max_diff"] == 0.0
    assert all(r["param_bytes"] < r["whole_param_bytes"] for r in rec["ranks"])
    losses = rec["losses"]
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, rec["one_process_losses"], rtol=1e-6)
    np.testing.assert_allclose(rec["grad_norms"], rec["one_process_grad_norms"], rtol=1e-5)
    assert rec["max_param_diff"] <= 1e-5

    cfg = _cfg(experts)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rparams = jax_tree(to_reference(cfg, params))
    toks, labs = token_stream(B, S, cfg.vocab, seed=0)
    l_ref, _ = rtf.loss_fn(rparams, _cfg(experts, rget_arch), jnp.asarray(toks), jnp.asarray(labs))
    np.testing.assert_allclose(losses[0], float(l_ref), rtol=5e-4)
    opt_cfg = AdamWConfig(moment_dtype="float32", lr=1e-3)
    opt = init_state(opt_cfg, params)
    one = steps.lm_train_step(cfg, opt_cfg)
    for _ in range(4):
        params, opt, _ = one(params, opt, torch.as_tensor(toks)[None], torch.as_tensor(labs)[None])
    paths, leaves = tree_flatten(params)
    for r, mine in enumerate(saved):
        mesh = ProcessMesh(("data", "model"), (data, model), (torch.device("cpu"),) * (data * model), rank=r)
        _, specs = tree_flatten(steps.lm_step_specs(cfg, mesh)[0], is_leaf=lambda x: isinstance(x, PartitionSpec))
        assert len(mine["train"]) == len(paths)
        for p, leaf, spec in zip(paths, leaves, specs, strict=True):
            np.testing.assert_allclose(mine["train"]["/".join(map(str, p))].numpy(),
                                       NamedSharding(mesh, spec).cut(leaf.detach()).numpy(), rtol=1e-5, atol=1e-5)


def test_serve_matches_one_process_and_jax(run):
    data, model, experts, rec, saved = run
    serve = saved[0]["serve"]
    assert rec["max_prefill_logit_diff"] <= 1e-4 and max(rec["max_decode_logit_diff"]) <= 1e-4
    assert rec["max_cache_diff"] <= 1e-4 and rec["cache_pos_equal"] and rec["cache_is_its_spec_shard"]
    cfg = _cfg(experts)
    rparams = jax_tree(to_reference(cfg, tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")))
    rcfg = _cfg(experts, rget_arch)
    toks = jnp.asarray(token_stream(B, S + DEC, cfg.vocab, seed=0)[0])
    logits, cache = rtf.prefill(rparams, rcfg, toks[:, :S])
    np.testing.assert_allclose(serve["prefill_logits"].numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)
    for i in range(DEC):   # past the window of 32: the ring wraps
        logits, cache = rtf.decode_step(rparams, rcfg, toks[:, S + i], jnp.full((B,), S + i, jnp.int32), cache)
        np.testing.assert_allclose(serve["decode_logits"][i].numpy(), np.asarray(logits), rtol=1e-4, atol=1e-4)
