"""The port's LM family (``repro_torch.models.transformer``) against the
JAX package's ``repro.models.transformer`` on the CPU, at the registry's
smoke sizes.

The reference's own initial parameters (``jax.tree.map(np.asarray, ...)``)
go through the parameter bridge (``repro_torch.models.convert``), and the
same numpy inputs go through both packages.  Twins, port against JAX:

* ``tests/test_models_smoke.py``: ``test_prefill_decode_consistency`` for
  every LM arch and ``test_swa_ring_decode``;
* ``tests/test_optimized_paths.py``: chunked against naive CE (the forward
  value), the opt forward;
* ``tests/test_extended.py``: ``TestOptimizedPrefill`` and the two
  local-dispatch cases.

Tolerances (``test_torch_models_bridge``): 1e-4 (absolute and relative) for
logits through a whole smoke model in f32, 1e-5 (relative) for loss
values; the reference tests' own bounds where a case is their twin.
Gradients and train steps come with the optimiser (not in this slice), so
no case takes a gradient.  The layer functions are held in
``test_torch_models_layers.py``, the GNN and RecSys forwards in
``test_torch_models_graph_recsys.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models_bridge import LOSS_RTOL, MODEL_TOL, as_t, close, lm_pair, rtf

from repro_torch.data import token_stream
from repro_torch.models import transformer as tf

torch.set_num_threads(2)

LM_ARCHS = ["minitron-4b", "yi-6b", "qwen2-1.5b", "arctic-480b", "mixtral-8x7b"]



@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_prefill_decode_consistency(arch_id):
    """Twin of ``test_prefill_decode_consistency``: the port's prefill and
    one decode step against the reference's, and against the port's own
    full forward (the reference test's oracle)."""
    rcfg, pcfg, rp, pp = lm_pair(arch_id, 1, drop_free=True)
    B, S = 2, 12
    toks, _ = token_stream(B, S + 1, pcfg.vocab, seed=3)

    rlog, rcache = rtf.prefill(rp, rcfg, jnp.asarray(toks[:, :S]))
    plog, pcache = tf.prefill(pp, pcfg, as_t(toks[:, :S]))
    close(plog, rlog, MODEL_TOL)
    close(pcache["k"], rcache["k"], MODEL_TOL)
    np.testing.assert_array_equal(pcache["pos"].numpy(), np.asarray(rcache["pos"]))
    hidden, _ = tf.forward(pp, pcfg, as_t(toks[:, :S]))
    close(plog, tf.logits_fn(pp, pcfg, hidden)[:, -1], 2e-4)

    rcache = rtf.extend_cache(rcfg, rcache, S + 4)
    pcache = tf.extend_cache(pcfg, pcache, S + 4)
    np.testing.assert_array_equal(pcache["pos"].numpy(), np.asarray(rcache["pos"]))
    pos = np.full((B,), S, np.int32)
    rdec, _ = rtf.decode_step(rp, rcfg, jnp.asarray(toks[:, S]), jnp.asarray(pos), rcache)
    pdec, _ = tf.decode_step(pp, pcfg, as_t(toks[:, S]), as_t(pos), pcache)
    close(pdec, rdec, MODEL_TOL)
    hidden2, _ = tf.forward(pp, pcfg, as_t(toks[:, :S + 1]))
    close(pdec, tf.logits_fn(pp, pcfg, hidden2)[:, -1], 2e-3)


def test_swa_ring_decode():
    """Twin of ``test_swa_ring_decode`` (the one windowed arch): decode from
    an empty ring of ``window`` slots past its wrap, teacher-forced with
    the reference's greedy tokens; every step's logits agree."""
    rcfg, pcfg, rp, pp = lm_pair("mixtral-8x7b", 2)
    B, W = 2, pcfg.window
    rcache = rtf.init_cache(rcfg, B, W)
    pcache = tf.init_cache(pcfg, B, W, device="cpu")
    step = jax.jit(lambda t, p, c: rtf.decode_step(rp, rcfg, t, p, c))
    tok = np.zeros((B,), np.int32)
    for pos in range(W + 5):
        p = np.full((B,), pos, np.int32)
        rlog, rcache = step(jnp.asarray(tok), jnp.asarray(p), rcache)
        plog, pcache = tf.decode_step(pp, pcfg, as_t(tok), as_t(p), pcache)
        close(plog, rlog, MODEL_TOL)
        tok = np.asarray(jnp.argmax(rlog, -1)).astype(np.int32)
    assert pcache["k"].shape[2] == W
    np.testing.assert_array_equal(pcache["pos"].numpy(), np.asarray(rcache["pos"]))


def test_swa_prefill_past_the_window_then_decode():
    """A windowed prefill longer than the window keeps the last ``window``
    positions in ring order; decoding on from it agrees with the reference."""
    rcfg, pcfg, rp, pp = lm_pair("mixtral-8x7b", 3, drop_free=True)
    B, S = 2, 45
    toks, _ = token_stream(B, S + 1, pcfg.vocab, seed=4)
    rlog, rcache = rtf.prefill(rp, rcfg, jnp.asarray(toks[:, :S]))
    plog, pcache = tf.prefill(pp, pcfg, as_t(toks[:, :S]))
    close(plog, rlog, MODEL_TOL)
    np.testing.assert_array_equal(pcache["pos"].numpy(), np.asarray(rcache["pos"]))
    pos = np.full((B,), S, np.int32)
    rdec, _ = rtf.decode_step(rp, rcfg, jnp.asarray(toks[:, S]), jnp.asarray(pos), rcache)
    pdec, _ = tf.decode_step(pp, pcfg, as_t(toks[:, S]), as_t(pos), pcache)
    close(pdec, rdec, MODEL_TOL)


@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "mixtral-8x7b"])
def test_chunked_loss_matches_naive(arch_id):
    """Twin of ``TestChunkedLoss::test_loss_matches_naive`` (forward value)."""
    rcfg, pcfg, rp, pp = lm_pair(arch_id, 0)
    toks, labs = token_stream(2, 24, pcfg.vocab, seed=5)
    r_naive, _ = rtf.loss_fn(rp, rcfg, jnp.asarray(toks), jnp.asarray(labs))
    p_naive, parts = tf.loss_fn(pp, pcfg, as_t(toks), as_t(labs))
    p_chunk, _ = tf.loss_fn(pp, dataclasses.replace(pcfg, loss_impl="chunked", loss_chunk=7), as_t(toks), as_t(labs))
    np.testing.assert_allclose(float(p_naive), float(r_naive), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(p_chunk), float(r_naive), rtol=2e-5)
    assert float(parts["aux"]) >= 0.0


@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "mixtral-8x7b", "arctic-480b"])
def test_opt_forward_close_to_naive(arch_id):
    """Twin of ``TestFullyOptimizedConfig``: chunked attention + chunked CE
    on the smoke config, drop-free, against the reference's naive loss."""
    rcfg, pcfg, rp, pp = lm_pair(arch_id, 3, drop_free=True)
    toks, labs = token_stream(2, 32, pcfg.vocab, seed=8)
    r_naive, _ = rtf.loss_fn(rp, rcfg, jnp.asarray(toks), jnp.asarray(labs))
    cfg_o = dataclasses.replace(pcfg, attn_impl="chunked", attn_chunk=8, loss_impl="chunked", loss_chunk=8)
    p_opt, _ = tf.loss_fn(pp, cfg_o, as_t(toks), as_t(labs))
    np.testing.assert_allclose(float(p_opt), float(r_naive), rtol=5e-5)


@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "mixtral-8x7b"])
def test_opt_prefill_matches_naive(arch_id):
    """Twin of ``TestOptimizedPrefill::test_opt_prefill_matches_naive``."""
    rcfg, pcfg, rp, pp = lm_pair(arch_id, 7, drop_free=True)
    toks, _ = token_stream(2, 16, pcfg.vocab, seed=11)
    r_naive, rcache = rtf.prefill(rp, rcfg, jnp.asarray(toks))
    cfg_o = dataclasses.replace(pcfg, attn_impl="chunked", attn_chunk=8)
    p_opt, pcache = tf.prefill(pp, cfg_o, as_t(toks))
    close(p_opt, r_naive, 2e-4)
    np.testing.assert_allclose(pcache["k"].numpy(), np.asarray(rcache["k"]), rtol=1e-5, atol=1e-5)


def test_local_dispatch_equals_global_when_single_shard():
    """Twin of ``TestOptimizedPrefill::test_local_dispatch_equals_global_when_single_shard``."""
    rcfg, pcfg, rp, pp = lm_pair("mixtral-8x7b", 8)
    toks, labs = token_stream(2, 16, pcfg.vocab, seed=12)
    r_g, _ = rtf.loss_fn(rp, rcfg, jnp.asarray(toks), jnp.asarray(labs))
    cfg_l = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="local", n_batch_shards=1))
    p_g, _ = tf.loss_fn(pp, pcfg, as_t(toks), as_t(labs))
    p_l, _ = tf.loss_fn(pp, cfg_l, as_t(toks), as_t(labs))
    assert float(p_l) == float(p_g)
    np.testing.assert_allclose(float(p_l), float(r_g), rtol=LOSS_RTOL)


def test_local_dispatch_subblocks_dropfree_equal():
    """Twin of ``TestOptimizedPrefill::test_local_dispatch_subblocks_dropfree_equal``."""
    rcfg, pcfg, rp, pp = lm_pair("mixtral-8x7b", 9)
    rcfg, pcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=64.0)) for c in (rcfg, pcfg))
    toks, labs = token_stream(2, 16, pcfg.vocab, seed=13)
    r_g, _ = rtf.loss_fn(rp, rcfg, jnp.asarray(toks), jnp.asarray(labs))
    cfg_l = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="local", n_batch_shards=4))
    rcfg_l = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, dispatch="local", n_batch_shards=4))
    r_l, _ = rtf.loss_fn(rp, rcfg_l, jnp.asarray(toks), jnp.asarray(labs))
    p_l, _ = tf.loss_fn(pp, cfg_l, as_t(toks), as_t(labs))
    np.testing.assert_allclose(float(p_l), float(r_g), rtol=5e-5)
    np.testing.assert_allclose(float(p_l), float(r_l), rtol=LOSS_RTOL)


def test_local_dispatch_with_drops_matches_reference():
    """Per-shard capacity at the smoke config's own capacity factor (tokens
    drop in each shard): the port's loss equals the reference's."""
    rcfg, pcfg, rp, pp = lm_pair("mixtral-8x7b", 10)
    toks, labs = token_stream(2, 16, pcfg.vocab, seed=14)
    rcfg_l = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, dispatch="local", n_batch_shards=4))
    pcfg_l = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, dispatch="local", n_batch_shards=4))
    r_l, rparts = rtf.loss_fn(rp, rcfg_l, jnp.asarray(toks), jnp.asarray(labs))
    p_l, parts = tf.loss_fn(pp, pcfg_l, as_t(toks), as_t(labs))
    np.testing.assert_allclose(float(p_l), float(r_l), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["aux"]), float(rparts["aux"]), rtol=LOSS_RTOL)

