"""The parameter bridge (``repro_torch.models.convert``) on the CPU, and
the pieces the model parity tests (``tests/test_torch_models*.py``) share:
the reference's functions under ``jax.jit``, the bridge applied to the
reference's own parameters, and the stated tolerances (2e-5 for one layer
function in f32, 1e-4 for logits through a whole smoke model, 1e-5
relative for loss values)."""

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_arch as rget_arch
from repro.models import gcn as rgcn_mod, layers as rlayers, transformer as rtf_mod
from repro_torch.configs import get_arch
from repro_torch.models.convert import from_reference, to_tensor


def _jit(module, *names, static=(1,)):
    """The reference's functions under ``jax.jit`` (configs static): one
    compile per shape instead of one per eager op."""
    return type("jitted", (), {n: staticmethod(jax.jit(getattr(module, n), static_argnums=static)) for n in names})


rlayers_j = _jit(rlayers, "attention", "decode_attention", "moe_ffn", static=(2,))
rtf = _jit(rtf_mod, "prefill", "forward", "decode_step", "loss_fn", "logits_fn")
rtf.extend_cache = staticmethod(jax.jit(rtf_mod.extend_cache, static_argnums=(0, 2)))
rtf.init_params = staticmethod(rtf_mod.init_params)
rtf.init_cache = staticmethod(rtf_mod.init_cache)
rgcn = _jit(rgcn_mod, "forward_full", "forward_sampled", "forward_molecule", "loss_full", "loss_sampled",
            "loss_molecule")
rgcn.init_params = staticmethod(rgcn_mod.init_params)

#: one layer function in f32
LAYER_TOL = 2e-5
#: logits through a whole smoke model in f32
MODEL_TOL = 1e-4
#: loss forward values (relative)
LOSS_RTOL = 1e-5


def np_tree(params):
    return jax.tree.map(np.asarray, params)


def bridge(cfg, params):
    return from_reference(cfg, np_tree(params), device="cpu")


def as_t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def drop_free_cfg(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=32.0))


def lm_pair(arch_id, seed, drop_free=False, **overrides):
    rcfg, pcfg = rget_arch(arch_id).smoke_cfg, get_arch(arch_id).smoke_cfg
    if drop_free:
        rcfg, pcfg = drop_free_cfg(rcfg), drop_free_cfg(pcfg)
    rcfg, pcfg = dataclasses.replace(rcfg, **overrides), dataclasses.replace(pcfg, **overrides)
    rparams = rtf.init_params(rcfg, jax.random.PRNGKey(seed))
    return rcfg, pcfg, rparams, bridge(pcfg, rparams)


def test_bridge_keeps_bf16_bits():
    a = np.asarray(jax.numpy.asarray(np.random.default_rng(14).normal(size=(5, 3)), jax.numpy.bfloat16))
    t = to_tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_bridge_splits_the_stacked_layer_axis():
    """Layer l of the port's parameters is row l of every stacked array of
    the reference's, bit for bit; the rest maps name for name."""
    rcfg, pcfg, rp, pp = lm_pair("arctic-480b", 4)
    tree = np_tree(rp)
    assert len(pp["layers"]) == pcfg.n_layers
    for li, layer in enumerate(pp["layers"]):
        for name, p in layer.named_parameters():
            node = tree["layers"]
            for key in name.split("."):
                node = node[key]
            np.testing.assert_array_equal(p.numpy(), node[li])
    np.testing.assert_array_equal(pp["embed"].numpy(), tree["embed"])
    assert "head" in pp and "head" in tree
