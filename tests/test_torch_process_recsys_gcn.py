"""The RecSys and GCN cells on a mesh of processes, on the CPU.

``python -m repro_torch.launch.process_train --check`` runs gloo ranks at
the smoke configs: every RecSys arch (fm, xdeepfm, sasrec, mind) through
its ``train_batch``, ``serve_p99`` and ``retrieval_cand`` cells (batch cut
to 64 rows, 1,000 candidates) on (1, 2) and (2, 2) ``(data, model)``
meshes, and gcn-cora's four train cells (cut to a few hundred nodes) on
(2, 1) and (2, 2).  The tables' rows split over ``model`` (every read a
masked take of the rank's rows summed over ``model``), the batch, the
candidates and the full graphs' edge lists over ``data``.  The runs of one
world size share one start of its ranks (``--then``).  Held:

* after 4 steps every parameter shard within 1e-5 of its leaf's largest
  magnitude of the one-process port's (the launcher's check), the losses
  and gradient norms at 1e-5 relative, and every leaf's shards gathering
  back to it;
* the serve and retrieval cells' logits and scores, gathered whole, within
  1e-5 of the one-process port's;
* the first loss within 5e-4 of the JAX package's loss on the same
  parameters (``convert.to_reference``) and batch;
* each split leaf (a table, ``linear``) holds 1 / |model| of its rows on
  every rank, the replicated leaves whole.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch
from repro.models import gcn as rgcn
from repro.models import recsys as rrec
from repro_torch.configs import get_arch
from repro_torch.launch import process_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import to_reference

TOL, JAX_TOL = 1e-5, 5e-4
REC_SIZES = ["--size", "batch=64", "--size", "n_candidates=1000"]
GCN_SIZES = {
    "full_graph_sm": ["--size", "n_nodes=60", "--size", "n_edges=300", "--size", "d_feat=16", "--size", "n_classes=4"],
    "ogb_products": ["--size", "n_nodes=300", "--size", "n_edges=2000", "--size", "d_feat=16"],
    "minibatch_lg": ["--size", "batch_nodes=8", "--size", "fanout1=3", "--size", "fanout2=2", "--size", "d_feat=16"],
    "molecule": ["--size", "batch=8", "--size", "n_nodes=12", "--size", "n_edges=20"],
}
#: (arch, cell or None for the three RecSys modes, data, model)
RUNS = ([(arch, None, data, model) for data, model in ((1, 2), (2, 2)) for arch in ("fm", "xdeepfm", "sasrec", "mind")]
        + [("gcn-cora", cell, data, model) for data, model in ((2, 1), (2, 2)) for cell in GCN_SIZES])


def _argv(arch, cell, data, model, out):
    what = ["--mode", "train,serve,retrieval"] + REC_SIZES if cell is None else ["--shape", cell] + GCN_SIZES[cell]
    return ["--arch", arch, "--smoke", "--data", str(data), "--model", str(model), "--backend", "gloo",
            "--steps", "4", "--check", "--out", str(out), "--timeout", "120"] + what


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every run's record and its ranks' saved results: the runs of one
    world size in one start of its ranks."""
    got = {}
    for world in sorted({r[2] * r[3] for r in RUNS}):
        runs = [r for r in RUNS if r[2] * r[3] == world]
        argv, outs = [], []
        for i, run in enumerate(runs):
            outs.append(tmp_path_factory.mktemp("{}_{}_{}x{}".format(*run)))
            argv += ([process_train.THEN] if i else []) + _argv(*run, outs[-1])
        rc, recs, bad = process_train.launch(argv)
        assert rc == 0, bad
        for run, rec, out in zip(runs, recs, outs, strict=True):
            got[run] = rec, [torch.load(out / f"rank{r}.pt") for r in range(world)]
    return got


@pytest.fixture(params=RUNS, ids=lambda r: "{}-{}-{}x{}".format(r[0], r[1] or "cells", r[2], r[3]))
def run(request, launched):
    return request.param, *launched[request.param]


def test_train_matches_one_process(run):
    (arch, cell, data, model), rec, _ = run
    assert rec["world"] == data * model and rec["mesh"] == [data, model] and rec["shards_rebuild_leaves"]
    assert rec["cell"] == (cell or "retrieval_cand")
    losses = rec["losses"]
    assert len(losses) == 4 and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, rec["one_process_losses"], rtol=TOL)
    np.testing.assert_allclose(rec["grad_norms"], rec["one_process_grad_norms"], rtol=TOL)
    assert rec["max_param_rel_diff"] <= TOL


@pytest.mark.parametrize("key", [r for r in RUNS if r[1] is None], ids=lambda r: "{}-{}x{}".format(r[0], *r[2:]))
def test_serve_and_retrieval_match_one_process(launched, key):
    rec, saved = launched[key]
    assert rec["serve_shape"][0] == 64 and rec["retrieval_shape"] == [1000]
    for mode in ("serve", "retrieval"):
        assert rec[f"max_{mode}_rel_diff"] <= TOL, mode
        for mine in saved[1:]:
            assert torch.equal(mine[mode], saved[0][mode])


@functools.cache
def _first_losses(arch, cell):
    """The JAX package's loss of the seeded parameters on the cell's batch
    (the one-process plan's inputs, as the ranks draw them)."""
    args = process_train._parser().parse_args(_argv(arch, cell, 1, 1, "x"))
    cfg = process_train._config(args)
    plan, _, sizes = process_train._cell_plan(args, cfg, "train", make_host_mesh(1, 1, devices=["cpu"]))
    params, rest = process_train.cell_inputs(plan, cfg, sizes, torch.device("cpu"))
    rparams = jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)), to_reference(cfg, params))
    batch = jax.tree.map(lambda t: jnp.asarray(t.numpy()), rest)
    rcfg = rget_arch(arch).smoke_cfg
    if cell is None:
        return float(rrec.get_model_fns(rcfg)[2](rparams, rcfg, batch[0]))
    rcfg = dataclasses.replace(rcfg, d_feat=sizes["d_feat"], n_classes=sizes["n_classes"])
    if cell in ("full_graph_sm", "ogb_products"):
        feats, edges, weight, labels, mask = batch
        return float(rgcn.loss_full(rparams, rcfg, feats, edges, labels, mask, weight))
    if cell == "minibatch_lg":
        return float(rgcn.loss_sampled(rparams, rcfg, batch[0], list(batch[1:3]), batch[3]))
    return float(rgcn.loss_molecule(rparams, rcfg, *batch))


def test_first_loss_matches_jax(run):
    (arch, cell, _, _), rec, _ = run
    np.testing.assert_allclose(rec["losses"][0], _first_losses(arch, cell), rtol=JAX_TOL)


def _rows(cfg, leaf: str) -> int:
    """Rows of a RecSys table leaf, padded to a multiple of 1,024."""
    n = cfg.n_items if leaf == "items" else cfg.spec.total_rows
    return ((n + 1023) // 1024) * 1024


def test_split_leaves_hold_their_share(run):
    """Every rank's parameter bytes are its shards': the tables and the
    linear term 1 / |model| of their rows, the rest whole (GCN: every leaf
    whole)."""
    (arch, cell, data, model), rec, saved = run
    cfg = get_arch(arch).smoke_cfg
    want = set() if cell else ({"table", "linear"} if arch in ("fm", "xdeepfm") else {"items"})
    for r, mine in zip(rec["ranks"], saved, strict=True):
        shards = mine["train"]
        assert {k for k in shards if k in ("table", "linear", "items")} == want
        for k in want:
            assert shards[k].shape[0] * model == _rows(cfg, k), k
        assert sum(t.numel() * t.element_size() for t in shards.values()) == r["param_bytes"]
        split = sum(shards[k].numel() * shards[k].element_size() for k in want)
        assert r["whole_param_bytes"] == r["param_bytes"] + split * (model - 1)
