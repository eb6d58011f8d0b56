"""The cell plans (``repro_torch.launch.steps``) against the JAX
package's ``launch/steps.py``, on the CPU.

* Every cell of ``all_cells()`` on the single-pod and multi-pod production
  meshes (the reference on stand-ins with the same axis names and sizes;
  its rules read nothing else) and on a (1, 1) host mesh: the same kind,
  note, skip and ``model_flops``, argument shapes and dtypes (meta tensors
  against ``ShapeDtypeStruct``s), and in / out spec trees, all exact.  The
  port keeps one tree per transformer layer: a layer leaf is compared with
  the reference's without its leading (n_layers,) entry.  The paper's own
  cell needs the reference's real mesh, so it runs on (1, 1) only.
* One reduced cell per family run eagerly on the CPU against the
  reference's jitted step on the same inputs and parameters: LM train
  (accum 2), prefill and decode; GCN train; RecSys train (and sasrec's
  16-microbatch accumulation), serve and retrieval (the CIN's 250
  chunks); the paper's serve step, baseline and opt.  Losses, logits,
  scores, gradient norms and bf16 moments within 1e-4 of each leaf's
  largest magnitude (``STEP_TOL``; moments one bf16 ulp beyond it),
  updated parameters within that plus twice the step's learning rate (see
  ``_run_train``).  The 16-microbatch accumulation runs on mind, whose
  loss is smooth: sasrec's ReLU FFN over 32,768 x 12 tokens has a few
  pre-activations within f32 rounding of 0, where either package's f32
  gradient may take the other side of the kink than f64 does (measured:
  one such element moves a leaf's gradient by 1e-2 of its largest
  magnitude), so sasrec runs at 64 rows;
  the serve step's histogram and packed candidates equal.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models_bridge import np_tree

from repro.configs import get_arch as rget_arch
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.launch import steps as rsteps
from repro.launch.mesh import make_host_mesh as rmake_host_mesh
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import colors_like, criteo_like_batch, molecule_batch, token_stream, user_history_batch
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.models.params import tree_flatten
from repro_torch.sharding import PartitionSpec

STEP_TOL = 1e-4
MESHES = {"16x16": dict(multi_pod=False), "2x16x16": dict(multi_pod=True)}


def _stand_in(mesh):
    return types.SimpleNamespace(axis_names=mesh.axis_names, shape=dict(mesh.shape))


def _ref_items(tree, is_leaf):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path), leaf) for path, leaf in flat]


def _expand_layers(items, n_layers, strip):
    """The reference's (path, leaf) items with each stacked-layer leaf
    repeated per layer, ``strip`` applied to it."""
    out = {}
    for path, leaf in items:
        if "layers" in path:
            at = path.index("layers") + 1
            for li in range(n_layers):
                out[path[:at] + (li,) + path[at:]] = strip(leaf)
        else:
            out[path] = leaf
    return out


def _compare_specs(ref_tree, port_tree, n_layers):
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    want = _expand_layers([(p, tuple(s)) for p, s in _ref_items(ref_tree, is_p)], n_layers, lambda s: s[1:])
    paths, leaves = tree_flatten(port_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert all(isinstance(s, PartitionSpec) for s in leaves)
    assert dict(zip(paths, map(tuple, leaves))) == want


def _compare_args(ref_args, port_args, n_layers):
    is_s = lambda x: isinstance(x, jax.ShapeDtypeStruct)  # noqa: E731
    want = _expand_layers([(p, (tuple(s.shape), str(s.dtype))) for p, s in _ref_items(ref_args, is_s)], n_layers,
                          lambda sd: (sd[0][1:], sd[1]))
    paths, leaves = tree_flatten(port_args)
    assert all(t.device.type == "meta" for t in leaves)
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in zip(paths, leaves)}
    assert got == want


def _compare_plans(rp, pp, arch_id):
    n_layers = len(pp.args[0]["layers"]) if get_arch(arch_id).family == "lm" else 0
    assert (pp.arch_id, pp.shape_name, pp.kind, pp.note, pp.skip) == (rp.arch_id, rp.shape_name, rp.kind, rp.note,
                                                                       rp.skip)
    assert pp.model_flops == rp.model_flops
    _compare_args(rp.args, pp.args, n_layers)
    _compare_specs(rp.in_specs, pp.in_specs, n_layers)
    _compare_specs(rp.out_specs, pp.out_specs, n_layers)


ALL = steps.all_cells()


def test_all_cells_match_reference():
    assert ALL == rsteps.all_cells() and len(ALL) == 41


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id,shape_name", [c for c in ALL if c[0] != "nsimplex-colors"])
def test_cell_plan_matches_reference(arch_id, shape_name, mesh_name):
    mesh = make_production_mesh(**MESHES[mesh_name])
    for opt in ((False, True) if get_arch(arch_id).family == "lm" else (False,)):
        rp = rsteps.build_cell(arch_id, shape_name, _stand_in(mesh), opt=opt)
        pp = steps.build_cell(arch_id, shape_name, mesh, opt=opt)
        _compare_plans(rp, pp, arch_id)


@pytest.mark.parametrize("arch_id,shape_name", [c for c in ALL if get_arch(c[0]).family != "lm"]
                         + [("qwen2-1.5b", "train_4k"), ("mixtral-8x7b", "prefill_32k"), ("yi-6b", "decode_32k")])
def test_cell_plan_matches_reference_on_a_host_mesh(arch_id, shape_name):
    rmesh, mesh = rmake_host_mesh(1, 1), make_host_mesh(1, 1, devices=["cpu"])
    for opt in (False, True):
        _compare_plans(rsteps.build_cell(arch_id, shape_name, rmesh, opt=opt),
                       steps.build_cell(arch_id, shape_name, mesh, opt=opt), arch_id)


def test_cell_overrides_match_reference():
    mesh = make_production_mesh()
    for kw in (dict(n_layers=2), dict(accum_override=3), dict(n_layers=1, unroll=True)):
        _compare_plans(rsteps.build_cell("mixtral-8x7b", "train_4k", _stand_in(mesh), **kw),
                       steps.build_cell("mixtral-8x7b", "train_4k", mesh, **kw), "mixtral-8x7b")


# -- reduced cells, run ------------------------------------------------------------

def _reduced(monkeypatch, arch_id, shapes):
    """Point both packages' ``get_arch`` at ``arch_id`` with its smoke
    config as the model and ``shapes`` as its cells."""
    def patch(module, get, shape_cls):
        arch = get(arch_id)
        smaller = dataclasses.replace(arch, model_cfg=arch.smoke_cfg,
                                      shapes={n: shape_cls(n, k, dict(s)) for n, (k, s) in shapes.items()})
        monkeypatch.setattr(module, "get_arch", lambda a: smaller if a == arch_id else get(a))

    patch(rsteps, rget_arch, RShapeSpec)
    patch(steps, get_arch, ShapeSpec)


def _meshes():
    return rmake_host_mesh(1, 1), make_host_mesh(1, 1, devices=["cpu"])


def _close(got, want, what="", tol=STEP_TOL, extra=0.0):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale + extra, (what, float(np.abs(got - want).max()), scale)


def _close_moments(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    err = np.abs(got - want) - ulp - tol * max(float(np.abs(want).max()), 1e-30)
    assert np.all(err <= 0), (float(err.max()), np.argwhere(err > 0)[:3], got[err > 0][:3], want[err > 0][:3])


def _run_train(arch_id, cfg, rplan, pplan, rparams, batch_np, tol=STEP_TOL):
    """One train step of each package from the same parameters and batch.
    An element's first AdamW update lr·m̂/(√v̂ + ε) lies in [-lr, lr] and
    turns on its gradient's sign and size against ε = 1e-8, which the
    gradients' agreement does not resolve for gradients that small, so
    the updated parameters get 2·lr beside ``tol``; the moments (the
    gradients) carry the gradient check."""
    from repro.train.optimizer import init_state as rinit_state
    from repro_torch.train import AdamWConfig, init_state

    params = from_reference(cfg, np_tree(rparams), device="cpu")
    ropt = rinit_state(rsteps._opt_cfg(), rparams)
    opt = init_state(AdamWConfig(moment_dtype="bfloat16"), params)
    rb = jax.tree.map(jnp.asarray, batch_np)
    tb = jax.tree.map(torch.as_tensor, batch_np)
    rout = jax.jit(rplan.fn)(rparams, ropt, *rb)
    pout = pplan.fn(params, opt, *tb)
    _close(pout[2]["loss"], rout[2]["loss"], "loss", tol)
    _close(pout[2]["grad_norm"], rout[2]["grad_norm"], "grad_norm", tol)
    _close(pout[2]["lr"], rout[2]["lr"], "lr", tol)
    lr = float(rout[2]["lr"])
    for w, g in zip(jax.tree.leaves(rout[0]), jax.tree.leaves(to_reference(cfg, pout[0]))):
        _close(g, w, "params", tol, extra=2 * lr)
    for key in ("m", "v"):
        for w, g in zip(jax.tree.leaves(rout[1][key]), jax.tree.leaves(to_reference(cfg, pout[1][key]))):
            _close_moments(torch.as_tensor(np.asarray(g, np.float32)), w, tol)
    assert int(pout[1]["step"]) == 1
    return pout


def test_lm_train_cell_runs(monkeypatch):
    from repro.models import transformer as rtf

    _reduced(monkeypatch, "qwen2-1.5b", {"train_4k": ("train", {"seq_len": 16, "global_batch": 2})})
    rmesh, mesh = _meshes()
    for opt in (False, True):
        rplan = rsteps.build_cell("qwen2-1.5b", "train_4k", rmesh, opt=opt)
        pplan = steps.build_cell("qwen2-1.5b", "train_4k", mesh, opt=opt)
        assert pplan.note == rplan.note == "accum=2 micro=1"
        cfg = get_arch("qwen2-1.5b").smoke_cfg
        toks, labs = token_stream(2, 16, cfg.vocab, seed=4)
        batch = (toks.reshape(2, 1, 16), labs.reshape(2, 1, 16))
        rparams = rtf.init_params(rget_arch("qwen2-1.5b").smoke_cfg, jax.random.PRNGKey(0))
        out = _run_train("qwen2-1.5b", cfg, rplan, pplan, rparams, batch)
        assert out[0]["embed"].dtype == torch.float32


def test_lm_prefill_and_decode_cells_run(monkeypatch):
    from repro.models import transformer as rtf

    _reduced(monkeypatch, "mixtral-8x7b", {"prefill_32k": ("prefill", {"seq_len": 12, "global_batch": 2}),
                                           "decode_32k": ("decode", {"seq_len": 16, "global_batch": 2})})
    rmesh, mesh = _meshes()
    cfg = get_arch("mixtral-8x7b").smoke_cfg
    rparams = rtf.init_params(rget_arch("mixtral-8x7b").smoke_cfg, jax.random.PRNGKey(0))
    params = from_reference(cfg, np_tree(rparams), device="cpu")
    toks, _ = token_stream(2, 12, cfg.vocab, seed=5)
    # the local MoE dispatch's sharding hint needs a mesh of Auto axes in context
    auto = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    for opt in (False, True):
        with jax.set_mesh(auto):
            rl, rc = jax.jit(rsteps.build_cell("mixtral-8x7b", "prefill_32k", auto, opt=opt).fn)(
                rparams, jnp.asarray(toks))
        pl, pc = steps.build_cell("mixtral-8x7b", "prefill_32k", mesh, opt=opt).fn(params, torch.as_tensor(toks))
        _close(pl, rl, "prefill logits")
        _close(pc["k"], rc["k"], "cache k")
    rplan, pplan = (m.build_cell("mixtral-8x7b", "decode_32k", me) for m, me in ((rsteps, rmesh), (steps, mesh)))
    assert pplan.note == rplan.note
    rcache = rtf.init_cache(rget_arch("mixtral-8x7b").smoke_cfg, 2, 16)
    pcache = {k: torch.as_tensor(np.asarray(v)) for k, v in rcache.items()}
    tok, pos = np.array([3, 7], np.int32), np.array([0, 0], np.int32)
    rl, _ = jax.jit(rplan.fn)(rparams, jnp.asarray(tok), jnp.asarray(pos), rcache)
    pl, _ = pplan.fn(params, torch.as_tensor(tok), torch.as_tensor(pos), pcache)
    _close(pl, rl, "decode logits")


def test_gcn_train_cell_runs(monkeypatch):
    from repro.models import gcn as rgcn

    _reduced(monkeypatch, "gcn-cora", {"molecule": ("train", {"batch": 8, "n_nodes": 12, "n_edges": 20,
                                                              "d_feat": 16, "n_classes": 4}),
                                       "full_graph_sm": ("train", {"n_nodes": 60, "n_edges": 300, "d_feat": 16,
                                                                   "n_classes": 4})})
    rmesh, mesh = _meshes()
    b = molecule_batch(batch=8, n_nodes=12, n_edges=20, d_feat=16)
    labels = (np.arange(8) % 4).astype(np.int32)
    rplan, pplan = rsteps.build_cell("gcn-cora", "molecule", rmesh), steps.build_cell("gcn-cora", "molecule", mesh)
    cfg = dataclasses.replace(get_arch("gcn-cora").smoke_cfg, d_feat=16, n_classes=4)
    rcfg = dataclasses.replace(rget_arch("gcn-cora").smoke_cfg, d_feat=16, n_classes=4)
    rparams = rgcn.init_params(rcfg, jax.random.PRNGKey(0))
    _run_train("gcn-cora", cfg, rplan, pplan, rparams, (b["feats"], b["src"], b["dst"], labels))
    rng = np.random.default_rng(0)
    X = rng.standard_normal((60, 16)).astype(np.float32)
    edges = np.zeros((2, 512), np.int32)
    edges[:, :300] = rng.integers(0, 60, size=(2, 300))
    ew = (np.arange(512) < 300).astype(np.float32)          # padding edges weigh 0
    y, mask = (np.arange(60) % 4).astype(np.int32), (np.arange(60) < 30).astype(np.float32)
    rplan, pplan = (m.build_cell("gcn-cora", "full_graph_sm", me) for m, me in ((rsteps, rmesh), (steps, mesh)))
    assert tuple(pplan.args[3].shape) == (2, 512)
    _run_train("gcn-cora", cfg, rplan, pplan, rgcn.init_params(rcfg, jax.random.PRNGKey(1)), (X, edges, ew, y, mask))


@pytest.mark.parametrize("arch_id,batch", [("fm", 64), ("sasrec", 64), ("mind", 32768)])
def test_recsys_train_cell_runs(monkeypatch, arch_id, batch):
    from repro.models import recsys as rrec

    _reduced(monkeypatch, arch_id, {"train_batch": ("train", {"batch": batch})})
    rmesh, mesh = _meshes()
    rplan, pplan = (m.build_cell(arch_id, "train_batch", me) for m, me in ((rsteps, rmesh), (steps, mesh)))
    cfg = get_arch(arch_id).smoke_cfg
    accum = 16 if batch >= 32768 else 1
    assert pplan.note == rplan.note == f"accum={accum}"
    if cfg.interaction == "fm-2way":
        dense, sparse, labels = criteo_like_batch(batch, n_sparse=cfg.n_sparse,
                                                  vocab_sizes=np.asarray(cfg.vocab_sizes), seed=1)
        data = {"dense": dense, "sparse": sparse, "labels": labels}
    else:
        seqs, targets = user_history_batch(batch, cfg.seq_len, cfg.n_items, seed=1)
        data = {"seqs": seqs, "targets": targets}
    if accum > 1:
        data = {k: v.reshape((accum, -1) + v.shape[1:]) for k, v in data.items()}
    rcfg = rget_arch(arch_id).smoke_cfg
    rparams = rrec.get_model_fns(rcfg)[0](rcfg, jax.random.PRNGKey(0))
    _run_train(arch_id, cfg, rplan, pplan, rparams, (data,))


@pytest.mark.parametrize("arch_id", ["xdeepfm", "mind"])
def test_recsys_serve_and_retrieval_cells_run(monkeypatch, arch_id):
    from repro.models import recsys as rrec

    _reduced(monkeypatch, arch_id, {"serve_p99": ("serve", {"batch": 16}),
                                    "retrieval_cand": ("retrieval", {"n_candidates": 1000})})
    rmesh, mesh = _meshes()
    cfg = get_arch(arch_id).smoke_cfg
    rcfg = rget_arch(arch_id).smoke_cfg
    rparams = rrec.get_model_fns(rcfg)[0](rcfg, jax.random.PRNGKey(2))
    params = from_reference(cfg, np_tree(rparams), device="cpu")
    if cfg.interaction == "cin":
        dense, sparse, _ = criteo_like_batch(16, n_sparse=cfg.n_sparse, vocab_sizes=np.asarray(cfg.vocab_sizes),
                                             seed=2)
        serve_b = {"dense": dense, "sparse": sparse}
        one = {"dense": dense[:1], "sparse": sparse[:1]}
        cand = (np.arange(1000) % cfg.vocab_sizes[0]).astype(np.int32)
    else:
        seqs, _ = user_history_batch(16, cfg.seq_len, cfg.n_items, seed=2)
        serve_b, one = {"seqs": seqs}, {"seqs": seqs[:1]}
        cand = np.arange(1, 1001, dtype=np.int32)
    for shape, args in (("serve_p99", (serve_b,)), ("retrieval_cand", (one, cand))):
        rplan, pplan = (m.build_cell(arch_id, shape, me) for m, me in ((rsteps, rmesh), (steps, mesh)))
        want = jax.jit(rplan.fn)(rparams, *jax.tree.map(jnp.asarray, args))
        got = pplan.fn(params, *jax.tree.map(torch.as_tensor, args))
        _close(got, want, f"{arch_id} {shape}")


@pytest.mark.parametrize("opt", [False, True])
def test_nsimplex_cell_runs(opt):
    """The paper's serve step through the cell: the same histogram and the
    same packed (id, code) set per query as the reference's cell on a
    colors-like corpus (8 pivots, 16 queries, the threshold of
    tests/test_torch_serve_step.py that no f32 bound lies near)."""
    from repro.core import NSimplexProjector as RProjector, select_pivots as rselect
    from repro.metrics import get_metric as rmetric

    X = colors_like(n=2048 + 16, seed=5)
    m = rmetric("euclidean")
    proj = RProjector(pivots=rselect(X[:2048], 8, seed=1), metric=m, dtype=np.float64)
    table = np.asarray(proj(X[:2048]), dtype=np.float32)
    qd = np.asarray(m.cross_np(X[2048:], proj.pivots), dtype=np.float32)
    consts = [np.asarray(a, dtype=np.float32) for a in (proj.Linv, proj.sq_norms, proj.sigma)]
    rmesh, mesh = _meshes()
    arch_r, arch_p = rget_arch("nsimplex-colors"), get_arch("nsimplex-colors")
    shape_r = RShapeSpec("serve_1m", "search_serve", {"n_objects": 2048, "query_batch": 16, "n_pivots": 8})
    shape_p = ShapeSpec("serve_1m", "search_serve", {"n_objects": 2048, "query_batch": 16, "n_pivots": 8})
    rplan = rsteps._nsimplex_cell(dataclasses.replace(arch_r, model_cfg=arch_r.smoke_cfg), shape_r, rmesh, opt=opt)
    pplan = steps._nsimplex_cell(dataclasses.replace(arch_p, model_cfg=arch_p.smoke_cfg), shape_p, mesh, opt=opt)
    _compare_plans(rplan, pplan, "nsimplex-colors")
    want = [np.asarray(o) for o in jax.jit(rplan.fn)(jnp.asarray(table), *map(jnp.asarray, consts), jnp.asarray(qd),
                                                     jnp.float32(0.035))]
    got = [o.numpy() for o in pplan.fn(torch.from_numpy(table), *map(torch.from_numpy, consts),
                                       torch.from_numpy(qd), 0.035)]
    np.testing.assert_array_equal(got[0], want[0])
    assert int(got[0].sum()) == 16 * 2048
    for q in range(16):
        pick = lambda out: sorted((int(a), int(c)) for a, c in zip(out[1][:, q].ravel(), out[2][:, q].ravel())  # noqa: E731
                                  if a >= 0)
        assert pick(got) == pick(want), q
