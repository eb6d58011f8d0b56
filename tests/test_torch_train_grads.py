"""Gradients through the port's models against ``jax.value_and_grad`` of
the reference's losses, on the CPU in f32 (no TF32): the parameters are
the reference's own, carried across by ``convert.from_reference``; the
port's gradient trees come back through ``convert.to_reference`` and are
compared leaf by leaf.

Tolerance: each gradient leaf within 1e-4 of that leaf's largest
magnitude (``GRAD_TOL``); the loss at rtol 1e-5.  Covered: every LM smoke
config as configured, and the MoE archs at capacity factor 0.5 (tokens
drop; asserted), drop-free and under local dispatch; chunked attention
and CE, the three GCN losses and
the four RecSys losses.  ``remat`` on and off give equal gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models_bridge import LOSS_RTOL, bridge, lm_pair, rgcn

from repro.configs import get_arch as rget_arch
from repro.models import recsys as rrec
from repro_torch.configs import get_arch
from repro_torch.data import criteo_like_batch, molecule_batch, NeighborSampler, random_graph, token_stream
from repro_torch.data import user_history_batch
from repro_torch.models import gcn, recsys
from repro_torch.models import transformer as tf
from repro_torch.models.convert import to_reference
from repro_torch.models.params import tree_leaves, value_and_grad

GRAD_TOL = 1e-4
LM_ARCHS = ["minitron-4b", "yi-6b", "qwen2-1.5b", "arctic-480b", "mixtral-8x7b"]
REC_ARCHS = ["fm", "xdeepfm", "mind", "sasrec"]


def assert_grads_close(want_tree, got_tree):
    want, got = jax.tree.leaves(want_tree), jax.tree.leaves(got_tree)
    assert jax.tree.structure(want_tree) == jax.tree.structure(got_tree)
    for w, g in zip(want, got):
        w = np.asarray(w, np.float64)
        assert w.shape == g.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, (float(np.abs(g - w).max()), scale)


def _lm_grads(arch_id, variant):
    over = {}
    if variant == "chunked":
        over = dict(attn_impl="chunked", attn_chunk=8, loss_impl="chunked", loss_chunk=5)
    rcfg, pcfg, rparams, params = lm_pair(arch_id, 0, drop_free=variant == "drop_free", **over)
    moe_over = {"drops": dict(capacity_factor=0.5), "local": dict(dispatch="local", n_batch_shards=2)}.get(variant)
    if moe_over:
        rcfg, pcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe_over)) for c in (rcfg, pcfg))
    toks, labs = token_stream(2, 16, rcfg.vocab, seed=1)
    (rl, raux), rg = jax.jit(jax.value_and_grad(
        lambda p: rtf_loss(p, rcfg, jnp.asarray(toks), jnp.asarray(labs)), has_aux=True))(rparams)
    (loss, aux), g = value_and_grad(
        lambda p: tf.loss_fn(p, pcfg, torch.as_tensor(toks), torch.as_tensor(labs)), params, has_aux=True)
    return (rl, raux, rg), (loss, aux, g), pcfg


def rtf_loss(p, cfg, toks, labs):
    from repro.models import transformer as rtf_mod

    return rtf_mod.loss_fn(p, cfg, toks, labs)


_LM_CASES = [(a, "as_configured") for a in LM_ARCHS] + [
    ("mixtral-8x7b", "drops"), ("mixtral-8x7b", "drop_free"), ("mixtral-8x7b", "local"),
    ("arctic-480b", "drops"), ("arctic-480b", "drop_free"),
    ("qwen2-1.5b", "chunked"), ("mixtral-8x7b", "chunked"),
]


@pytest.mark.parametrize("arch_id,variant", _LM_CASES)
def test_lm_grads_match_reference(arch_id, variant):
    (rl, raux, rg), (loss, aux, g), pcfg = _lm_grads(arch_id, variant)
    np.testing.assert_allclose(float(loss), float(rl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["aux"]), float(raux["aux"]), rtol=LOSS_RTOL, atol=1e-7)
    assert_grads_close(rg, to_reference(pcfg, g))
    assert not any(t.requires_grad for t in tree_leaves(g))


def test_moe_drop_variant_drops_tokens(monkeypatch):
    """The "drops" cases above do drop tokens, so their gradients cover the
    dropped-token path: count each expert's tokens per top-k slot at every
    MoE call against the capacity."""
    seen = []
    real = tf.moe_ffn

    def spy(p, x, cfg, group=None, tp=None):
        probs = torch.softmax(x.detach().float() @ p["w_router"], dim=-1)
        idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg.top_k]
        C = min(max(4, int(x.shape[0] * cfg.top_k / cfg.n_experts * cfg.capacity_factor)), x.shape[0])
        seen.append(max(int((idx[:, s] == e).sum()) for s in range(cfg.top_k) for e in range(cfg.n_experts)) - C)
        return real(p, x, cfg, group=group, tp=tp)

    monkeypatch.setattr(tf, "moe_ffn", spy)
    for arch_id in ("mixtral-8x7b", "arctic-480b"):
        _lm_grads(arch_id, "drops")
    # 2 archs x 2 layers, each run again by the remat backward
    assert len(seen) == 8 and all(over > 0 for over in seen), seen


@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "mixtral-8x7b"])
def test_remat_gives_equal_gradients(arch_id):
    cfg = get_arch(arch_id).smoke_cfg
    toks, labs = token_stream(2, 16, cfg.vocab, seed=2)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat, loss_impl="chunked", loss_chunk=6)
        params = tf.init_params(c, torch.Generator().manual_seed(3), device="cpu")
        out[remat] = value_and_grad(lambda p: tf.loss_fn(p, c, torch.as_tensor(toks), torch.as_tensor(labs))[0],
                                    params)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_wraps_layers_only_under_grad(monkeypatch):
    """Under ``torch.no_grad()`` no checkpoint is taken; a tree whose
    parameters do not require grad (the serving tree) builds no graph; and
    with grad on and ``remat`` every layer and every CE chunk goes through
    ``torch.utils.checkpoint``."""
    calls = []
    real = tf.checkpoint
    monkeypatch.setattr(tf, "checkpoint", lambda fn, *a, **k: calls.append(fn.__name__) or real(fn, *a, **k))
    cfg = dataclasses.replace(get_arch("qwen2-1.5b").smoke_cfg, loss_impl="chunked", loss_chunk=8)
    params = tf.init_params(cfg, device="cpu")
    toks = torch.as_tensor(token_stream(1, 16, cfg.vocab, seed=0)[0])
    with torch.no_grad():
        loss, _ = tf.loss_fn(params, cfg, toks, toks)
    assert calls == [] and not loss.requires_grad
    loss, _ = tf.loss_fn(params, cfg, toks, toks)      # grads off on the serving tree: no graph either
    assert not loss.requires_grad
    calls.clear()
    value_and_grad(lambda p: tf.loss_fn(p, cfg, toks, toks)[0], params)
    assert calls.count("_block") == cfg.n_layers and calls.count("_ce_chunk") == 2


# -- GCN ------------------------------------------------------------------------

def _gcn_pair(seed):
    from repro.models import gcn as rgcn_mod

    rcfg, cfg = rget_arch("gcn-cora").smoke_cfg, get_arch("gcn-cora").smoke_cfg
    rp = rgcn_mod.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, cfg, rp, bridge(cfg, rp)


def test_gcn_full_grads():
    rcfg, cfg, rp, p = _gcn_pair(0)
    X, ei, y = random_graph(200, 800, cfg.d_feat, cfg.n_classes, seed=0)
    mask = (np.arange(200) < 50).astype(np.float32)
    ew = np.random.default_rng(0).random(ei.shape[1]).astype(np.float32)
    rl, rg = jax.value_and_grad(lambda q: rgcn.loss_full(q, rcfg, *map(jnp.asarray, (X, ei, y, mask, ew))))(rp)
    l, g = value_and_grad(lambda q: gcn.loss_full(q, cfg, *map(torch.as_tensor, (X, ei, y, mask, ew))), p)
    np.testing.assert_allclose(float(l), float(rl), rtol=LOSS_RTOL)
    assert_grads_close(rg, to_reference(cfg, g))


def test_gcn_sampled_grads():
    rcfg, cfg, rp, p = _gcn_pair(1)
    X, ei, y = random_graph(500, 4000, cfg.d_feat, cfg.n_classes, seed=1)
    layers = NeighborSampler(ei, 500, seed=0).sample_batch(np.arange(32), [5, 3])
    feats = [X[layers[0]], X[layers[1]], X[layers[2]]]
    rl, rg = jax.value_and_grad(lambda q: rgcn.loss_sampled(
        q, rcfg, jnp.asarray(feats[0]), [jnp.asarray(feats[1]), jnp.asarray(feats[2])], jnp.asarray(y[:32])))(rp)
    l, g = value_and_grad(lambda q: gcn.loss_sampled(
        q, cfg, torch.as_tensor(feats[0]), [torch.as_tensor(feats[1]), torch.as_tensor(feats[2])],
        torch.as_tensor(y[:32])), p)
    np.testing.assert_allclose(float(l), float(rl), rtol=LOSS_RTOL)
    assert_grads_close(rg, to_reference(cfg, g))


def test_gcn_molecule_grads():
    rcfg, cfg, rp, p = _gcn_pair(2)
    b = molecule_batch(batch=8, n_nodes=12, n_edges=20, d_feat=cfg.d_feat)
    labels = np.arange(8, dtype=np.int32) % cfg.n_classes
    rl, rg = jax.value_and_grad(lambda q: rgcn.loss_molecule(
        q, rcfg, jnp.asarray(b["feats"]), jnp.asarray(b["src"]), jnp.asarray(b["dst"]), jnp.asarray(labels)))(rp)
    l, g = value_and_grad(lambda q: gcn.loss_molecule(
        q, cfg, torch.as_tensor(b["feats"]), torch.as_tensor(b["src"]), torch.as_tensor(b["dst"]),
        torch.as_tensor(labels)), p)
    np.testing.assert_allclose(float(l), float(rl), rtol=LOSS_RTOL)
    assert_grads_close(rg, to_reference(cfg, g))


# -- RecSys ---------------------------------------------------------------------

def _rec_batch(cfg, B=32):
    if cfg.interaction in ("fm-2way", "cin"):
        dense, sparse, labels = criteo_like_batch(B, n_sparse=cfg.n_sparse, vocab_sizes=np.asarray(cfg.vocab_sizes),
                                                  seed=0)
        return {"dense": dense, "sparse": sparse, "labels": labels}
    seqs, targets = user_history_batch(B, cfg.seq_len, cfg.n_items, seed=0)
    return {"seqs": seqs, "targets": targets}


@pytest.mark.parametrize("arch_id", REC_ARCHS)
def test_recsys_grads(arch_id):
    rcfg, cfg = rget_arch(arch_id).smoke_cfg, get_arch(arch_id).smoke_cfg
    rinit, _, rloss = rrec.get_model_fns(rcfg)
    _, _, loss_fn = recsys.get_model_fns(cfg)
    rp = rinit(rcfg, jax.random.PRNGKey(0))
    p = bridge(cfg, rp)
    batch = _rec_batch(cfg)
    rl, rg = jax.jit(jax.value_and_grad(lambda q: rloss(q, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})))(rp)
    l, g = value_and_grad(lambda q: loss_fn(q, cfg, {k: torch.as_tensor(v) for k, v in batch.items()}), p)
    np.testing.assert_allclose(float(l), float(rl), rtol=LOSS_RTOL)
    assert_grads_close(rg, to_reference(cfg, g))
