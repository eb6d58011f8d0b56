"""The ``opt`` LM cells on a process mesh (local MoE dispatch, ``moe_local``),
on the CPU, through ``python -m repro_torch.launch.process_train --opt``
on the reference's reduced mixtral (d_model 64, d_ff 128, vocab 512):
chunked attention and CE, and each rank dispatching its own tokens with
the reference's per-shard capacity (``n_batch_shards`` = the data
shards; a prefill in 4,096-token blocks).

* (2, 1) and (2, 2) with 4 experts (on ``model`` where it has ranks): the
  train cell and the prefill cell;
* (2, 4) with 2 experts, fewer than ``|model|`` (train and prefill): every expert's ``d_ff``
  split over ``model``, and under ``moe_local`` the expert weights
  replicated over ``data`` while their AdamW moments stay sharded over it
  (each rank updates its moment shard's slice and the slices are
  all-gathered into the weight).

Held as the other tensor-parallel tests: parameters after 4 steps within
1e-5 of the one-process port's, the first loss within 5e-4 of the JAX
package's on the same opt config, the prefill logits within 1e-4 of both.
Plus the dispatch's shard arithmetic and the moments' extra axes.
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
from repro_torch.launch import process_train
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import to_reference
from repro_torch.sharding import PartitionSpec as P, lm_param_specs
from repro_torch.sharding.rules import NamedSharding, ProcessMesh
from repro_torch.train.optimizer import _moment_axes

ARCH, B, S = "mixtral-8x7b", 8, 32
#: (data, model, experts)
RUNS = [(2, 1, 4), (2, 2, 4), (2, 4, 2)]


def _opt_cfg(experts, data, get=get_arch):
    """The opt cells' config as the JAX package's ``_lm_opt_cfg`` builds it
    (without its sharding hints, which need a JAX mesh and move no value)."""
    cfg = dataclasses.replace(get(ARCH).smoke_cfg, d_model=64, d_ff=128, vocab=512)
    moe = dataclasses.replace(cfg.moe, n_experts=experts, dispatch="local", n_batch_shards=data)
    return dataclasses.replace(cfg, moe=moe, attn_impl="chunked", attn_chunk=1024, loss_impl="chunked",
                               loss_chunk=512)


def jax_tree(tree):
    """The reference's pytree as JAX arrays of copies (``to_reference``
    gives numpy views of the port's tensors)."""
    return jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)), tree)


@pytest.fixture(scope="module", params=RUNS, ids=lambda r: f"{r[0]}x{r[1]}-E{r[2]}")
def run(request, tmp_path_factory):
    data, model, experts = request.param
    out = tmp_path_factory.mktemp(f"moe_local_{data}x{model}")
    rc, recs, bad = process_train.launch(
        ["--arch", ARCH, "--smoke", "--d-model", "64", "--d-ff", "128", "--vocab", "512", "--opt",
         "--n-experts", str(experts), "--data", str(data), "--model", str(model), "--backend", "gloo",
         "--mode", "train,prefill", "--steps", "4", "--out", str(out), "--timeout", "240", "--check"])
    assert rc == 0, bad
    prefill = torch.load(out / "rank0.pt")["serve"]["prefill_logits"].numpy()
    return data, model, experts, recs[0], prefill


def test_opt_train_matches_one_process_and_jax(run):
    data, model, experts, rec, _ = run
    assert rec["world"] == data * model and rec["shards_rebuild_leaves"]
    losses = rec["losses"]
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, rec["one_process_losses"], rtol=1e-6)
    np.testing.assert_allclose(rec["grad_norms"], rec["one_process_grad_norms"], rtol=1e-5)
    assert rec["max_param_diff"] <= 1e-5
    cfg = _opt_cfg(experts, data)
    rparams = jax_tree(to_reference(cfg, tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")))
    toks, labs = token_stream(B, S, cfg.vocab, seed=0)
    l_ref, _ = rtf.loss_fn(rparams, _opt_cfg(experts, data, rget_arch), jnp.asarray(toks), jnp.asarray(labs))
    np.testing.assert_allclose(losses[0], float(l_ref), rtol=5e-4)


def test_opt_prefill_matches_one_process_and_jax(run):
    data, model, experts, rec, prefill = run
    assert rec["max_prefill_logit_diff"] <= 1e-4 and rec["max_cache_diff"] <= 1e-4 and rec["cache_pos_equal"]
    cfg = _opt_cfg(experts, data)
    rparams = jax_tree(to_reference(cfg, tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")))
    toks = jnp.asarray(token_stream(B, S, cfg.vocab, seed=0)[0])
    logits, _ = rtf.prefill(rparams, _opt_cfg(experts, data, rget_arch), toks)
    np.testing.assert_allclose(prefill, np.asarray(logits), rtol=1e-4, atol=1e-4)


def test_moe_local_replicates_experts_and_shards_their_moments():
    """Under moe_local with experts fewer than |model| the expert weights
    drop their data split and the moments keep it: AdamW's extra axes."""
    mesh = ProcessMesh(("data", "model"), (2, 4), (torch.device("cpu"),) * 8, rank=5)
    cfg = _opt_cfg(2, 2)
    abstract = tf.init_params_abstract(cfg)
    params = lm_param_specs(abstract, mesh, n_experts=2, moe_local=True)
    moments = lm_param_specs(abstract, mesh, n_experts=2)
    ps, ms = params["layers"][0]["moe"]["w_gate"], moments["layers"][0]["moe"]["w_gate"]
    assert ps == P(None, None, "model") and ms == P(None, "data", "model")
    assert _moment_axes(NamedSharding(mesh, ps), NamedSharding(mesh, ms)) == ("data",)
    wq = params["layers"][0]["attn"]["wq"]
    assert _moment_axes(NamedSharding(mesh, wq), NamedSharding(mesh, moments["layers"][0]["attn"]["wq"])) == ()


@pytest.mark.parametrize("shards,T,R,want", [
    (2, 32, 1, (2, 16, 10, False)),    # one process: the whole batch's 2 shards
    (2, 16, 2, (1, 16, 10, False)),    # a rank of 2: its one shard, the same capacity
    (4, 15, 2, (1, 15, 18, True)),     # 30 tokens do not split in 4: the reference's one shard, global slots
])
def test_local_dispatch_shards_are_the_whole_batchs(shards, T, R, want):
    cfg = layers.MoEConfig(n_experts=4, top_k=2, d_ff=8, dispatch="local", n_batch_shards=shards)
    assert layers._dispatch_shards(cfg, T, R) == want
