"""The port's GNN and RecSys forwards (``repro_torch.models.gcn``,
``recsys``) against the JAX package on the CPU, at the registry's smoke
sizes, through the parameter bridge.

Twins of ``tests/test_models_smoke.py``: ``TestGNNSmoke``'s three
forwards (and their loss values) and
``TestRecsysSmoke::test_serve_and_retrieval`` for every RecSys arch.
Tolerances: 1e-4 (absolute and relative) for logits and scores, 1e-5
(relative) for loss values.  Train steps come with the optimiser (not in
this slice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models_bridge import LOSS_RTOL, MODEL_TOL, as_t, bridge, close, rgcn

from repro.configs import get_arch as rget_arch
from repro.models import recsys as rrec
from repro_torch.configs import get_arch
from repro_torch.data import (
    NeighborSampler,
    criteo_like_batch,
    molecule_batch,
    random_graph,
    user_history_batch,
)
from repro_torch.models import gcn, recsys

torch.set_num_threads(2)

REC_ARCHS = ["fm", "xdeepfm", "mind", "sasrec"]



def _gcn(seed):
    rcfg, pcfg = rget_arch("gcn-cora").smoke_cfg, get_arch("gcn-cora").smoke_cfg
    rp = rgcn.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, pcfg, rp, bridge(pcfg, rp)


def test_gcn_full_graph():
    """Twin of ``TestGNNSmoke::test_full_graph``: logits and the masked loss,
    also with a padded edge list (zero edge weights)."""
    rcfg, pcfg, rp, pp = _gcn(0)
    X, ei, y = random_graph(200, 800, pcfg.d_feat, pcfg.n_classes, seed=0)
    mask = np.zeros(200, np.float32)
    mask[:50] = 1
    want = rgcn.forward_full(rp, rcfg, jnp.asarray(X), jnp.asarray(ei))
    got = gcn.forward_full(pp, pcfg, as_t(X), as_t(ei))
    assert got.shape == (200, pcfg.n_classes)
    close(got, want, MODEL_TOL)
    rl = rgcn.loss_full(rp, rcfg, jnp.asarray(X), jnp.asarray(ei), jnp.asarray(y), jnp.asarray(mask))
    pl = gcn.loss_full(pp, pcfg, as_t(X), as_t(ei), as_t(y), as_t(mask))
    np.testing.assert_allclose(float(pl), float(rl), rtol=LOSS_RTOL)
    ew = (np.arange(800) % 5 != 0).astype(np.float32)
    close(gcn.forward_full(pp, pcfg, as_t(X), as_t(ei), as_t(ew)),
           rgcn.forward_full(rp, rcfg, jnp.asarray(X), jnp.asarray(ei), jnp.asarray(ew)), MODEL_TOL)


def test_gcn_sampled_minibatch():
    """Twin of ``TestGNNSmoke::test_sampled_minibatch``: the port's sampler
    draws the reference's layers, and the forward and loss agree."""
    from repro.data import NeighborSampler as RSampler

    rcfg, pcfg, rp, pp = _gcn(1)
    X, ei, y = random_graph(500, 4000, pcfg.d_feat, pcfg.n_classes, seed=1)
    seeds = np.arange(32)
    layers_ = NeighborSampler(ei, 500, seed=0).sample_batch(seeds, [5, 3])
    rlayers_ = RSampler(ei, 500, seed=0).sample_batch(seeds, [5, 3])
    for a, b in zip(layers_, rlayers_):
        np.testing.assert_array_equal(a, b)
    assert layers_[1].shape == (32 * 5,) and layers_[2].shape == (32 * 5 * 3,)
    hops = [X[layers_[1]], X[layers_[2]]]
    want = rgcn.forward_sampled(rp, rcfg, jnp.asarray(X[layers_[0]]), [jnp.asarray(h) for h in hops])
    got = gcn.forward_sampled(pp, pcfg, as_t(X[layers_[0]]), [as_t(h) for h in hops])
    close(got, want, MODEL_TOL)
    rl = rgcn.loss_sampled(rp, rcfg, jnp.asarray(X[layers_[0]]), [jnp.asarray(h) for h in hops], jnp.asarray(y[seeds]))
    pl = gcn.loss_sampled(pp, pcfg, as_t(X[layers_[0]]), [as_t(h) for h in hops], as_t(y[seeds]))
    np.testing.assert_allclose(float(pl), float(rl), rtol=LOSS_RTOL)


def test_gcn_molecule_batch():
    """Twin of ``TestGNNSmoke::test_molecule_batch``."""
    rcfg, pcfg, rp, pp = _gcn(2)
    b = molecule_batch(batch=8, n_nodes=12, n_edges=20, d_feat=pcfg.d_feat)
    args = (b["feats"], b["src"], b["dst"])
    want = rgcn.forward_molecule(rp, rcfg, *map(jnp.asarray, args))
    got = gcn.forward_molecule(pp, pcfg, *map(as_t, args))
    assert got.shape == (8, pcfg.n_classes)
    close(got, want, MODEL_TOL)
    rl = rgcn.loss_molecule(rp, rcfg, *map(jnp.asarray, args), jnp.asarray(b["labels"]))
    pl = gcn.loss_molecule(pp, pcfg, *map(as_t, args), as_t(b["labels"]))
    np.testing.assert_allclose(float(pl), float(rl), rtol=LOSS_RTOL)




def _rec_batch(cfg, B):
    if cfg.interaction in ("fm-2way", "cin"):
        dense, sparse, labels = criteo_like_batch(B, n_sparse=cfg.n_sparse,
                                                  vocab_sizes=np.asarray(cfg.vocab_sizes), seed=0)
        return {"dense": dense, "sparse": sparse, "labels": labels}
    seqs, targets = user_history_batch(B, cfg.seq_len, cfg.n_items, seed=0)
    return {"seqs": seqs, "targets": targets}


@pytest.mark.parametrize("arch_id", REC_ARCHS)
def test_serve_and_retrieval(arch_id):
    """Twin of ``TestRecsysSmoke::test_serve_and_retrieval``: serve scores
    (FM, xDeepFM) or user encodings and 100-candidate retrieval scores
    (MIND, SaSRec), and the loss forward value."""
    rcfg, pcfg = rget_arch(arch_id).smoke_cfg, get_arch(arch_id).smoke_cfg
    rinit, rfwd, rloss = rrec.get_model_fns(rcfg)
    rfwd, rloss = jax.jit(rfwd, static_argnums=(1,)), jax.jit(rloss, static_argnums=(1,))
    _, pfwd, ploss = recsys.get_model_fns(pcfg)
    rp = rinit(rcfg, jax.random.PRNGKey(1))
    pp = bridge(pcfg, rp)
    batch = _rec_batch(pcfg, 8)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    pb = {k: as_t(v) for k, v in batch.items()}
    if pcfg.interaction in ("fm-2way", "cin"):
        want = rfwd(rp, rcfg, {k: v for k, v in rb.items() if k != "labels"})
        got = pfwd(pp, pcfg, {k: v for k, v in pb.items() if k != "labels"})
        assert got.shape == (8,)
        close(got, want, MODEL_TOL)
    else:
        want = rfwd(rp, rcfg, rb["seqs"])
        got = pfwd(pp, pcfg, pb["seqs"])
        close(got, want, MODEL_TOL)
        cand = np.arange(1, 101, dtype=np.int32)
        s_want = rrec.score_candidates(rp["items"], want[0], jnp.asarray(cand))
        s_got = recsys.score_candidates(pp["items"], got[0], as_t(cand))
        assert s_got.shape == (100,) and torch.isfinite(s_got).all()
        close(s_got, s_want, MODEL_TOL)
    np.testing.assert_allclose(float(ploss(pp, pcfg, pb)), float(rloss(rp, rcfg, rb)), rtol=LOSS_RTOL)


def test_user_embeddings():
    for arch_id, rfn, pfn in (("fm", rrec.fm_user_embedding, recsys.fm_user_embedding),
                              ("mind", rrec.mind_user_embedding, recsys.mind_user_embedding)):
        rcfg, pcfg = rget_arch(arch_id).smoke_cfg, get_arch(arch_id).smoke_cfg
        rp = rrec.get_model_fns(rcfg)[0](rcfg, jax.random.PRNGKey(2))
        pp = bridge(pcfg, rp)
        batch = _rec_batch(pcfg, 4)
        close(pfn(pp, pcfg, {k: as_t(v) for k, v in batch.items()}),
               rfn(rp, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}), MODEL_TOL)

