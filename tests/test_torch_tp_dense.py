"""Tensor-parallel LM compute over ``model`` on a process mesh, on the CPU:
the dense qwen2 smoke config (4 heads, 2 kv heads of 16, d_ff 128, vocab
512, tied embeddings, QKV bias).

``python -m repro_torch.launch.process_train --mode train,decode --check``
runs gloo ranks on (1, 2), (2, 2) and (1, 4) ``(data, model)`` meshes; on
(1, 4) the 2 kv heads do not split over 4 ranks, so k / v come from the
weights gathered over ``model``; (1, 4) again with ``--d-head 6``, which 4
ranks do not divide: the cache stays whole on every rank and decode
attends without the head_dim exchange; on (1, 8) the 4 heads do not split
over 8 ranks (the weights' column chunk of 8 is half a head): ranks 0-3
take a head each, ranks 4-7 none (GSPMD's padded split).  Held:

* every leaf's shards gathered back equal the leaf, a split leaf holds 1 /
  its split, and each rank's parameter bytes are its ``lm_param_specs``
  shards' (the split leaves fall by ``|model|``);
* after 4 train steps every parameter equals the one-process port's at
  1e-5 (the launcher's check, and this test's own replay against every
  rank's saved shards), the gradient norms at 1e-5 relative, and the loss
  falls;
  the first loss equals the JAX package's (``loss_fn`` through
  ``convert.to_reference``) at 5e-4, ``tests/test_sharding.py``'s
  tolerance;
* the prefill logits and every decode step's logits equal the one-process
  port's and the JAX package's (``repro.models.transformer.prefill`` /
  ``decode_step`` on the converted parameters) at 1e-4, every rank's cache
  is its ``kv_cache_specs`` shard (head_dim over ``model`` where it
  divides, else whole) and equals the one-process cache's cut (positions
  exactly).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch
from repro.models import transformer as rtf
from repro_torch.configs import get_arch
from repro_torch.data import token_stream
from repro_torch.launch import process_train, steps
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.models.convert import to_reference
from repro_torch.models.params import tree_flatten, tree_leaves
from repro_torch.sharding import PartitionSpec, lm_param_specs
from repro_torch.sharding.rules import NamedSharding, ProcessMesh
from repro_torch.train import AdamWConfig, init_state

ARCH, B, S, DEC = "qwen2-1.5b", 8, 32, 4
#: (data, model, --d-head or the config's 16)
MESHES = [(1, 2, None), (2, 2, None), (1, 4, None), (1, 4, 6), (1, 8, None)]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every mesh's record and ranks' saved files: the runs of one world
    size in one start of its ranks (``--then``)."""
    got = {}
    for world in sorted({data * model for data, model, _ in MESHES}):
        runs = [m for m in MESHES if m[0] * m[1] == world]
        argv, outs = [], []
        for i, (data, model, d_head) in enumerate(runs):
            outs.append(tmp_path_factory.mktemp(f"tp_dense_{data}x{model}"))
            argv += ([process_train.THEN] if i else []) + [
                "--arch", ARCH, "--smoke", "--data", str(data), "--model", str(model), "--backend", "gloo",
                "--mode", "train,decode", "--steps", "4", "--decode-steps", str(DEC), "--check",
                "--out", str(outs[-1]), "--timeout", "240"] + (["--d-head", str(d_head)] if d_head else [])
        rc, recs, bad = process_train.launch(argv)
        assert rc == 0, bad
        for m, rec, out in zip(runs, recs, outs, strict=True):
            got[m] = rec, [torch.load(out / f"rank{r}.pt") for r in range(world)]
    return got


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}" + (f"-dh{m[2]}" if m[2] else ""))
def run(request, launched):
    data, model, d_head = request.param
    rec, saved = launched[request.param]
    assert rec["mesh"] == [data, model]
    return data, model, d_head, rec, saved


def _cfg(get=get_arch, d_head=None):
    cfg = get(ARCH).smoke_cfg
    return cfg if d_head is None else dataclasses.replace(cfg, d_head=d_head)


def jax_tree(tree):
    """The reference's pytree as JAX arrays of copies (``to_reference``
    gives numpy views of the port's tensors)."""
    import jax

    return jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)), tree)


def _stand_in(data, model, rank=0):
    n = data * model
    return ProcessMesh(("data", "model"), (data, model), (torch.device("cpu"),) * n, rank=rank)


def test_shards_are_the_spec_layout(run):
    data, model, d_head, rec, _ = run
    assert rec["world"] == data * model and rec["mesh"] == [data, model] and rec["backend"] == "gloo"
    assert rec["shards_rebuild_leaves"] and rec["compress_max_diff"] == 0.0
    cfg = _cfg(d_head=d_head)
    params = tf.init_params_abstract(cfg)
    for r, got in enumerate(rec["ranks"]):
        mesh = _stand_in(data, model, r)
        specs = lm_param_specs(params, mesh, n_experts=None)
        want = sum(NamedSharding(mesh, s).cut(torch.empty(p.shape, device="meta")).numel() * p.element_size()
                   for p, s in zip(tree_leaves(params),
                                   tree_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))))
        assert got["param_bytes"] == want and got["transport"] == "gloo"
        assert got["param_bytes"] < got["whole_param_bytes"] or model == 1


@pytest.fixture
def reference(run):
    return _reference(run[2])


@functools.cache
def _reference(d_head):
    """The one-process port after 4 steps (parameters by path, first loss)
    and the JAX package's first loss, prefill and decode logits, on the
    same seeded parameters and tokens."""
    cfg = _cfg(d_head=d_head)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    # converted before the steps, which update params in place
    rparams, rcfg = jax_tree(to_reference(cfg, params)), _cfg(rget_arch, d_head)
    opt_cfg = AdamWConfig(moment_dtype="float32", lr=1e-3)
    opt = init_state(opt_cfg, params)
    toks, labs = token_stream(B, S, cfg.vocab, seed=0)
    one = steps.lm_train_step(cfg, opt_cfg)
    losses = []
    for _ in range(4):
        params, opt, m = one(params, opt, torch.as_tensor(toks)[None], torch.as_tensor(labs)[None])
        losses.append(float(m["loss"]))
    paths, leaves = tree_flatten(params)
    out = {"params": {"/".join(map(str, p)): l.detach() for p, l in zip(paths, leaves)},
           "first_loss": losses[0],
           "jax_loss": float(rtf.loss_fn(rparams, rcfg, jnp.asarray(toks), jnp.asarray(labs))[0])}
    dtoks = jnp.asarray(token_stream(B, S + DEC, cfg.vocab, seed=0)[0])
    logits, cache = rtf.prefill(rparams, rcfg, dtoks[:, :S])
    out["jax_prefill"], out["jax_decode"] = np.asarray(logits), []
    cache = rtf.extend_cache(rcfg, cache, S + DEC)
    for i in range(DEC):
        logits, cache = rtf.decode_step(rparams, rcfg, dtoks[:, S + i], jnp.full((B,), S + i, jnp.int32), cache)
        out["jax_decode"].append(np.asarray(logits))
    return out


def test_train_matches_one_process_and_jax(run, reference):
    data, model, d_head, rec, saved = run
    losses = rec["losses"]
    assert np.isfinite(losses[0]) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, rec["one_process_losses"], rtol=1e-6)
    np.testing.assert_allclose(rec["grad_norms"], rec["one_process_grad_norms"], rtol=1e-5)
    assert rec["max_param_diff"] <= 1e-5
    abstract = tf.init_params_abstract(_cfg(d_head=d_head))
    for r, mine in enumerate(saved):
        mesh = _stand_in(data, model, r)
        paths, specs = tree_flatten(lm_param_specs(abstract, mesh, n_experts=None),
                                    is_leaf=lambda x: isinstance(x, PartitionSpec))
        assert len(paths) == len(mine["train"]) == len(reference["params"])
        for p, spec in zip(paths, specs):
            path = "/".join(map(str, p))
            want = NamedSharding(mesh, spec).cut(reference["params"][path])
            np.testing.assert_allclose(mine["train"][path].numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(losses[0], reference["first_loss"], rtol=5e-4)
    np.testing.assert_allclose(losses[0], reference["jax_loss"], rtol=5e-4)


def test_serve_matches_one_process_and_jax(run, reference):
    data, model, d_head, rec, saved = run
    assert rec["max_prefill_logit_diff"] <= 1e-4
    assert len(rec["max_decode_logit_diff"]) == DEC and max(rec["max_decode_logit_diff"]) <= 1e-4
    assert rec["max_cache_diff"] <= 1e-4 and rec["cache_pos_equal"] and rec["cache_is_its_spec_shard"]
    # head_dim over model where it divides (else the cache whole), batch over data
    dh = d_head or 16
    want = [2, B // data, S + DEC, 2, dh // model if dh % model == 0 else dh]
    assert rec["cache_shard_shapes"]["k"] == want
    assert all(list(mine["serve"]["cache"]["k"].shape) == want for mine in saved)
    assert set(rec["model_collective_bytes_per_decode_step"]) == {"all_gather", "all_reduce"}
    serve = saved[0]["serve"]
    np.testing.assert_allclose(serve["prefill_logits"].numpy(), reference["jax_prefill"], rtol=1e-4, atol=1e-4)
    for got, want in zip(serve["decode_logits"].numpy(), reference["jax_decode"], strict=True):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_uneven_head_split_names_its_item():
    """Whole heads a rank where |model| divides them; else GSPMD's padded
    split (12 heads over 8 ranks: 2 on ranks 0-5, none on 6-7); a model
    axis that divides neither the heads nor their columns raises with a
    message that says so."""
    attn = get_arch(ARCH).model_cfg.attn
    assert layers._local_heads(attn, layers.TensorParallel(None, 4, 1)) == (3, 6)
    assert layers._heads_split(attn, layers.TensorParallel(None, 4, 1))
    assert not layers._kv_split(attn, layers.TensorParallel(None, 4, 1))
    assert layers.TensorParallel.of(_stand_in(2, 1)) is None
    got = [layers._local_heads(attn, layers.TensorParallel(None, 8, r)) for r in range(8)]
    assert got == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12), (12, 12), (12, 12)]
    assert not layers._heads_split(attn, layers.TensorParallel(None, 8, 0))
    odd = dataclasses.replace(attn, d_head=3)
    with pytest.raises(ValueError, match="divides neither"):
        layers._local_heads(odd, layers.TensorParallel(None, 8, 0))


def test_several_ranks_on_one_card_need_gloo_and_a_card(monkeypatch):
    """Several ranks on one card is gloo with device="cuda": without a card
    it raises rather than computing on the CPU, and nccl, which takes one
    card per rank, refuses more ranks than cards."""
    from repro_torch.launch.mesh import make_process_mesh

    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs a card"):
        make_process_mesh(1, 2, "gloo", device="cuda")
    with pytest.raises(ValueError, match="one card per rank"):
        make_process_mesh(1, 2, "nccl")
    with pytest.raises(ValueError, match="device cpu or cuda"):
        make_process_mesh(1, 2, "gloo", device="meta")
