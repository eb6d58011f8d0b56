"""The port's architecture registry (``repro_torch.configs``) against the JAX
package's ``repro.configs``, and the parameter bridge at every registry
config's full size.

* Twin of ``tests/test_extended.py::TestArchRegistry``: the same arch ids;
  every ``get_arch`` config equal field for field to the reference's
  (``model_cfg``, ``smoke_cfg``, shapes, source, family); the 40 assigned
  cells equal to the reference's ``all_cells()``; the exact paper
  configs; equal parameter counts.
* The bridge (``repro_torch.models.convert.from_reference``) takes every
  ``model_cfg`` and ``smoke_cfg``: the reference's abstract parameter
  shapes (``jax.eval_shape``, as zero-stride numpy views) go to the meta
  device, the stacked layer axis split, every shape and dtype kept.
* Twin of ``tests/test_models_smoke.py::TestPaperArchSmoke``:
  ``nsimplex-colors``'s smoke config through the port's
  ``build_serve_step`` on a one-position CPU grid, against the
  reference's on its one-device mesh.
* The models' entry points default to the card and raise without one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch, list_archs as rlist_archs
from repro.models import gcn as rgcn, recsys as rrec, transformer as rtf
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import gcn, layers, recsys, transformer as tf
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.convert import from_reference

ASSIGNED = {
    "minitron-4b", "yi-6b", "qwen2-1.5b", "arctic-480b", "mixtral-8x7b",
    "gcn-cora", "fm", "xdeepfm", "mind", "sasrec", "nsimplex-colors",
}


def _fields(cfg):
    """A config as nested (class name, field dict), so a reference config
    and a port config of the same values compare equal."""
    if dataclasses.is_dataclass(cfg):
        return (type(cfg).__name__, {f.name: _fields(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)})
    return cfg


def test_all_assigned_archs_present():
    assert ASSIGNED <= set(list_archs())
    assert list_archs() == rlist_archs()


@pytest.mark.parametrize("arch_id", sorted(ASSIGNED))
def test_config_fields_equal_reference(arch_id):
    port, ref = get_arch(arch_id), rget_arch(arch_id)
    assert (port.arch_id, port.family, port.source) == (ref.arch_id, ref.family, ref.source)
    assert _fields(port.model_cfg) == _fields(ref.model_cfg)
    assert _fields(port.smoke_cfg) == _fields(ref.smoke_cfg)
    assert {k: _fields(v) for k, v in port.shapes.items()} == {k: _fields(v) for k, v in ref.shapes.items()}


def test_40_assigned_cells():
    from repro.launch.steps import all_cells

    cells = [(a, s) for a in list_archs() for s in get_arch(a).shapes if a != "nsimplex-colors"]
    assert len(cells) == 40
    assert cells == [c for c in all_cells() if c[0] != "nsimplex-colors"]


def test_exact_paper_configs():
    a = get_arch("arctic-480b").model_cfg
    assert (a.n_layers, a.d_model, a.n_heads, a.n_kv, a.d_ff, a.vocab) == (35, 7168, 56, 8, 4864, 32000)
    assert a.moe.n_experts == 128 and a.moe.top_k == 2 and a.moe.dense_residual
    m = get_arch("mixtral-8x7b").model_cfg
    assert m.window == 4096 and m.moe.n_experts == 8
    q = get_arch("qwen2-1.5b").model_cfg
    assert q.qkv_bias and q.tie_embeddings and q.vocab == 151936
    g = get_arch("gcn-cora").model_cfg
    assert g.n_layers == 2 and g.d_hidden == 16
    x = get_arch("xdeepfm").model_cfg
    assert x.cin_layers == (200, 200, 200) and x.mlp_dims == (400, 400)
    s = get_arch("sasrec").model_cfg
    assert (s.embed_dim, s.n_blocks, s.seq_len) == (50, 2, 50)
    mi = get_arch("mind").model_cfg
    assert (mi.embed_dim, mi.n_interests, mi.capsule_iters) == (64, 4, 3)


@pytest.mark.parametrize("arch_id", sorted(ASSIGNED - {"nsimplex-colors"}))
def test_param_counts_equal_reference(arch_id):
    for which in ("model_cfg", "smoke_cfg"):
        port, ref = getattr(get_arch(arch_id), which), getattr(rget_arch(arch_id), which)
        assert port.param_count() == ref.param_count()
        if isinstance(port, tf.TransformerConfig):
            assert port.active_param_count() == ref.active_param_count()


def _reference_init(cfg):
    if isinstance(cfg, rtf.TransformerConfig):
        return rtf.init_params
    if isinstance(cfg, rgcn.GCNConfig):
        return rgcn.init_params
    return rrec.get_model_fns(cfg)[0]


@pytest.mark.parametrize("which", ["model_cfg", "smoke_cfg"])
@pytest.mark.parametrize("arch_id", sorted(ASSIGNED - {"nsimplex-colors"}))
def test_bridge_takes_every_config(arch_id, which):
    rcfg, pcfg = getattr(rget_arch(arch_id), which), getattr(get_arch(arch_id), which)
    abstract = jax.eval_shape(lambda k: _reference_init(rcfg)(rcfg, k), jax.random.PRNGKey(0))
    views = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), abstract)
    port = from_reference(pcfg, views, device="meta")
    got = {name: (tuple(p.shape), str(p.dtype).removeprefix("torch.")) for name, p in port.named_parameters()}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]:
        keys = [k.key for k in path]
        if isinstance(pcfg, tf.TransformerConfig) and keys[0] == "layers":
            for li in range(pcfg.n_layers):
                want[".".join(["layers", str(li)] + keys[1:])] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            want[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    assert got == want


def test_paper_arch_serve_step_matches_reference():
    """Twin of ``TestPaperArchSmoke::test_distributed_filter_matches_engine``
    on the port's ``nsimplex-colors`` smoke config: the histogram sums to
    the corpus, true results are never excluded, and the histogram and
    every query's packed candidates equal the reference's."""
    from repro.core import NSimplexProjector, select_pivots
    from repro.launch.mesh import make_host_mesh
    from repro.metrics import get_metric
    from repro.search.distributed import build_serve_step as rbuild_serve_step
    from repro_torch.data import colors_like
    from repro_torch.search.distributed import build_serve_step
    from repro_torch.sharding import make_scaleout_mesh

    cfg = get_arch("nsimplex-colors").smoke_cfg
    assert _fields(cfg)[1] == _fields(rget_arch("nsimplex-colors").smoke_cfg)[1]
    X = colors_like(n=cfg.n_objects + 50, seed=5)
    m = get_metric("euclidean")
    proj = NSimplexProjector(pivots=select_pivots(X[: cfg.n_objects], cfg.n_pivots, seed=1), metric=m,
                             dtype=np.float64)
    data = X[: cfg.n_objects]
    dists = np.stack([m.one_to_many_np(p, data) for p in proj.pivots], axis=1)
    table = np.asarray(proj.project_distances(dists), dtype=np.float32)
    queries = X[cfg.n_objects: cfg.n_objects + cfg.query_batch]
    qd = np.stack([m.one_to_many_np(p, queries) for p in proj.pivots], axis=1).astype(np.float32)
    consts = [np.asarray(a, np.float32) for a in (proj.Linv, proj.sq_norms, proj.sigma)]
    t = 0.05

    rserve = rbuild_serve_step(make_host_mesh(1, 1), n_pivots=cfg.n_pivots, max_candidates=64)
    rhist, ridx, rcode = (np.asarray(o) for o in jax.jit(rserve)(
        jnp.asarray(table), *map(jnp.asarray, consts), jnp.asarray(qd), jnp.float32(t)))
    serve = build_serve_step(make_scaleout_mesh(devices=[torch.device("cpu")]), n_pivots=cfg.n_pivots,
                             max_candidates=64)
    hist, idx, code = (o.numpy() for o in serve(torch.from_numpy(table), *map(torch.from_numpy, consts),
                                                torch.from_numpy(qd), t))
    assert hist.shape == (cfg.query_batch, 3)
    assert np.all(hist.sum(axis=1) == cfg.n_objects)
    np.testing.assert_array_equal(hist, rhist)
    for i in range(cfg.query_batch):
        got = sorted((int(a), int(c)) for a, c in zip(idx[:, i].ravel(), code[:, i].ravel()) if a >= 0)
        want = sorted((int(a), int(c)) for a, c in zip(ridx[:, i].ravel(), rcode[:, i].ravel()) if a >= 0)
        assert got == want
        if i < 4:
            true = set(np.where(m.one_to_many_np(queries[i], data) <= t)[0])
            missing = true - {a for a, _ in got}
            assert not missing or hist[i, 1] + hist[i, 2] > 64


def test_model_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    cfgs = {name: get_arch(name).smoke_cfg for name in ("qwen2-1.5b", "mixtral-8x7b", "fm", "gcn-cora")}
    for fn in (lambda: tf.init_params(cfgs["qwen2-1.5b"]),
               lambda: tf.init_cache(cfgs["qwen2-1.5b"], 1, 8),
               lambda: layers.attn_init(None, cfgs["qwen2-1.5b"].attn),
               lambda: layers.mlp_init(None, 8, 16),
               lambda: layers.moe_init(None, 8, cfgs["mixtral-8x7b"].moe),
               lambda: layers.rope_freqs(16),
               lambda: recsys.fm_init(cfgs["fm"]),
               lambda: gcn.init_params(cfgs["gcn-cora"]),
               lambda: from_reference(cfgs["gcn-cora"], {}),
               lambda: train_cli.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(1, 1)
