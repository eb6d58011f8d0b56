"""The model half's sharding rules (``repro_torch.sharding``) against the
JAX package's ``sharding/rules.py`` on stand-in meshes: the reference's
rules read only a mesh's ``axis_names`` and ``shape``, so an object with
those two stands in for the (1, 1), (4, 2), (16, 16) and (2, 16, 16)
meshes.  Every LM config (smoke and full) is built on the meta device; the
port keeps one tree per layer, so each layer spec is compared with the
reference's spec without its first (n_layers,) entry.  Comparisons are
exact.  Placements (``to_named_shardings``) put a leaf whole on a mesh of
one distinct device and raise for several."""

import dataclasses
import types

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as RP

from repro.configs import get_arch as rget_arch
from repro.models import recsys as rrec
from repro.models import transformer as rtf
from repro.sharding import rules as rrules
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import gcn, recsys
from repro_torch.models import transformer as tf
from repro_torch.sharding import (
    DeviceMesh,
    NamedSharding,
    PartitionSpec,
    batch_spec,
    gcn_param_specs,
    kv_cache_specs,
    lm_param_specs,
    recsys_param_specs,
    to_named_shardings,
)

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "4x2": (("data", "model"), (4, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
LM_ARCHS = [a for a in list_archs() if get_arch(a).family == "lm"]


def stand_in(name):
    axes, sizes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, sizes)))


def port_mesh(name):
    axes, sizes = MESHES[name]
    n = 1
    for s in sizes:
        n *= s
    return DeviceMesh(axes, sizes, (torch.device("cpu"),) * n)


def ref_items(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, RP))
    return [(tuple(getattr(p, "key", getattr(p, "idx", p)) for p in path), tuple(spec)) for path, spec in flat]


def port_items(tree):
    from repro_torch.models.params import tree_flatten

    paths, leaves = tree_flatten(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert all(isinstance(s, PartitionSpec) for s in leaves)
    return dict(zip(paths, (tuple(s) for s in leaves)))


def assert_lm_specs_equal(ref_tree, port_tree, n_layers):
    port = port_items(port_tree)
    want = {}
    for path, spec in ref_items(ref_tree):
        if path[0] == "layers":
            assert spec[0] is None          # the stacked axis is never sharded
            for li in range(n_layers):
                want[("layers", li) + path[1:]] = spec[1:]
        else:
            want[path] = spec
    assert port == want


def assert_specs_equal(ref_tree, port_tree):
    assert port_items(port_tree) == dict(ref_items(ref_tree))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", LM_ARCHS)
@pytest.mark.parametrize("which", ["smoke_cfg", "model_cfg"])
def test_lm_param_specs(arch_id, mesh, which):
    rcfg, cfg = getattr(rget_arch(arch_id), which), getattr(get_arch(arch_id), which)
    r_abs, p_abs = rtf.init_params_abstract(rcfg), tf.init_params_abstract(cfg)
    assert all(t.device.type == "meta" for t in p_abs.parameters())
    n_exp = cfg.moe.n_experts if cfg.moe else None
    for local in (False, True):
        want = rrules.lm_param_specs(r_abs, stand_in(mesh), n_experts=n_exp, moe_local=local)
        got = lm_param_specs(p_abs, port_mesh(mesh), n_experts=n_exp, moe_local=local)
        assert_lm_specs_equal(want, got, cfg.n_layers)
    # the experts-on-model switch at a small expert count
    if n_exp:
        want = rrules.lm_param_specs(r_abs, stand_in(mesh), n_experts=1, moe_local=True)
        assert_lm_specs_equal(want, lm_param_specs(p_abs, stand_in(mesh), n_experts=1, moe_local=True),
                              cfg.n_layers)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch_id", ["fm", "xdeepfm", "mind", "sasrec"])
def test_recsys_param_specs(arch_id, mesh):
    rcfg, cfg = rget_arch(arch_id).model_cfg, get_arch(arch_id).model_cfg
    rinit = rrec.get_model_fns(rcfg)[0]
    r_abs = jax.eval_shape(lambda k: rinit(rcfg, k), jax.random.PRNGKey(0))
    p_abs = recsys.get_model_fns(cfg)[0](cfg, device="meta")
    assert_specs_equal(rrules.recsys_param_specs(r_abs, stand_in(mesh)), recsys_param_specs(p_abs, port_mesh(mesh)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gcn_param_specs(mesh):
    from repro.models import gcn as rgcn

    rcfg, cfg = rget_arch("gcn-cora").model_cfg, get_arch("gcn-cora").model_cfg
    r_abs = jax.eval_shape(lambda k: rgcn.init_params(rcfg, k), jax.random.PRNGKey(0))
    assert_specs_equal(rrules.gcn_param_specs(r_abs, stand_in(mesh)),
                       gcn_param_specs(gcn.init_params(cfg, device="meta"), port_mesh(mesh)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [1, 8, 128, 512])
@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "mixtral-8x7b"])
def test_kv_cache_specs(arch_id, mesh, batch):
    rcfg, cfg = rget_arch(arch_id).model_cfg, get_arch(arch_id).model_cfg
    r_abs = jax.eval_shape(lambda: rtf.init_cache(rcfg, batch, 64))
    p_abs = tf.init_cache(cfg, batch, 64, device="meta")
    assert_specs_equal(rrules.kv_cache_specs(r_abs, stand_in(mesh), batch=batch),
                       kv_cache_specs(p_abs, port_mesh(mesh), batch=batch))
    # a head_dim the model axis does not divide stays whole
    odd = dataclasses.replace(cfg, d_head=24)
    rodd = dataclasses.replace(rcfg, d_head=24)
    assert_specs_equal(rrules.kv_cache_specs(jax.eval_shape(lambda: rtf.init_cache(rodd, batch, 8)), stand_in(mesh),
                                             batch=batch),
                       kv_cache_specs(tf.init_cache(odd, batch, 8, device="meta"), port_mesh(mesh), batch=batch))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec(mesh):
    for extra in (0, 1, 2, 3):
        assert tuple(batch_spec(port_mesh(mesh), extra)) == tuple(rrules.batch_spec(stand_in(mesh), extra))


def test_partition_spec_reads_as_jax():
    for entries in [(), (None,), ("data", None), (("pod", "data"), None), ((), None), (("data",), "model")]:
        assert tuple(PartitionSpec(*entries)) == tuple(RP(*entries))
    assert isinstance(PartitionSpec("a"), tuple) and "PartitionSpec" in repr(PartitionSpec("a"))


def test_production_and_host_meshes():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model") and m.shape == {"data": 16, "model": 16} and len(m.devices) == 256
    m = make_production_mesh(multi_pod=True)
    assert m.axis_names == ("pod", "data", "model") and m.shape == {"pod": 2, "data": 16, "model": 16}
    h = make_host_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    assert h.axis_names == ("data", "model") and h.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_host_mesh(4, 2, devices=[torch.device("cpu")] * 3)
    # the search half's (replica, data) grid over a (data, model) mesh
    g = make_host_mesh(2, 2, devices=["cpu"] * 4).scaleout_grid(("data",))
    assert g.axis_names == ("replica", "data") and len(g.devices) == 2 and len(g.devices[0]) == 2
    assert make_host_mesh(2, 2, devices=["cpu"] * 4).scaleout_grid(("data", "model")).axis_names == ("data",)


def test_host_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(1, 1)


def test_named_shardings_place_whole_on_one_device():
    cfg = get_arch("qwen2-1.5b").smoke_cfg
    params = tf.init_params(cfg, device="cpu")
    mesh = make_host_mesh(4, 2, devices=[torch.device("cpu")] * 8)
    shd = to_named_shardings(lm_param_specs(params, mesh), mesh)
    from repro_torch.models.params import tree_leaves

    leaves = tree_leaves(shd, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(list(params.parameters()))
    assert all(s.device == torch.device("cpu") for s in leaves)
    assert leaves[0].place(torch.ones(2)).device == torch.device("cpu")


def test_named_shardings_refuse_several_distinct_devices():
    mesh = DeviceMesh(("data", "model"), (2, 1), (torch.device("cpu"), torch.device("meta")))
    with pytest.raises(NotImplementedError, match="split over 2 distinct devices"):
        to_named_shardings({"w": PartitionSpec("data", None)}, mesh)
    with pytest.raises(NotImplementedError, match="replicated over 2 distinct devices"):
        to_named_shardings({"w": PartitionSpec(None, None)}, mesh)
