"""AdamW and int8 gradient compression of the port
(``repro_torch.train.optimizer``) against the JAX package's, on the CPU:
the twins of ``tests/test_train_infra.py::TestOptimizer`` and
``TestGradCompression``, then parity on the same inputs.

Tolerances:
  * the schedule ``lr_at`` over steps 0 ... total + 10: rtol 5e-7.  The
    reference's f32 cosine (XLA's) is one ulp off the correctly rounded
    value, which torch's cosine gives, for about 1% of arguments.  One ulp
    of a cosine near -1 (6e-8) is 3e-8 in the schedule's cosine factor,
    which the 0.1 floor turns into up to 2.7e-7 of the rate; every other
    step is bit-equal (asserted: at most 1 step in 20 differs);
  * 1 and 10 ``apply_updates`` from the same params and gradients: f32
    params and moments rtol 1e-6; bf16 moments within one bf16 ulp;
  * int8: ``q`` equal, ``scale`` and the error-feedback residual rtol 1e-6.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as ropt
from repro_torch.train import AdamWConfig, apply_updates, init_state, lr_at
from repro_torch.train.optimizer import compress_tree, decompress_tree, dequantize_int8, quantize_int8

LR_RTOL = 5e-7
F32_RTOL = 1e-6


def _toy(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((8, 4)).astype(np.float32),
        "b": np.zeros((4,), np.float32),
        "nested": {"u": rng.standard_normal((3,)).astype(np.float32)},
    }


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# -- the reference's own optimizer tests, on the port -------------------------

def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=400, moment_dtype="float32")
    params = {"x": torch.tensor([5.0, -3.0])}
    state = init_state(cfg, params)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        g = {"x": 2 * (params["x"] - target)}
        params, state, _ = apply_updates(cfg, params, g, state)
    np.testing.assert_allclose(params["x"].numpy(), [1.0, 2.0], atol=0.05)


def test_grad_clip_applied():
    cfg = AdamWConfig(lr=1e-3, grad_clip=1.0, moment_dtype="float32")
    params = {"x": torch.ones(4)}
    state = init_state(cfg, params)
    _, _, m = apply_updates(cfg, params, {"x": torch.full((4,), 1e6)}, state)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip


def test_bf16_moments_track_f32():
    outs = {}
    for mdt in ("float32", "bfloat16"):
        cfg = AdamWConfig(lr=0.05, moment_dtype=mdt, weight_decay=0.0, warmup_steps=0, total_steps=100)
        p = {"x": torch.tensor([2.0])}
        s = init_state(cfg, p)
        for _ in range(50):
            p, s, _ = apply_updates(cfg, p, {"x": 2 * p["x"]}, s)
        outs[mdt] = float(p["x"][0])
    assert abs(outs["bfloat16"] - outs["float32"]) < 0.05


def test_lr_schedule():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(lr_at(cfg, torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr_at(cfg, torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(lr_at(cfg, torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)


def test_int8_roundtrip_error_bounded():
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    q, s = quantize_int8(x)
    err = (x - q.float() * s).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-7


def test_error_feedback_unbiased_over_time():
    g = {"w": torch.full((64,), 0.001)}
    ef = {"w": torch.zeros(64)}
    applied = torch.zeros(64)
    for _ in range(100):
        qt, ef = compress_tree(g, ef)
        applied = applied + decompress_tree(qt)["w"]
    np.testing.assert_allclose(applied.numpy(), 0.1, rtol=0.05)


# -- parity with the reference -------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (100, 10_000), (3, 3)])
def test_lr_at_matches_reference(warmup, total):
    rcfg = ropt.AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    cfg = AdamWConfig(lr=3e-4, warmup_steps=warmup, total_steps=total)
    steps = range(0, total + 11) if total <= 200 else list(range(0, 211)) + list(range(total - 100, total + 11))
    want = np.array([float(ropt.lr_at(rcfg, jnp.asarray(s, jnp.int32))) for s in steps], np.float32)
    got = np.array([float(lr_at(cfg, torch.tensor(s, dtype=torch.int32))) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=LR_RTOL, atol=0)
    assert int(np.sum(got != want)) <= len(want) // 20
    assert lr_at(cfg, torch.tensor(1, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("n_steps", [1, 10])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(n_steps, mdt):
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, moment_dtype=mdt, grad_clip=2.0)
    rcfg, cfg = ropt.AdamWConfig(**kw), AdamWConfig(**kw)
    params, rng = _toy(0), np.random.default_rng(1)
    grads = [jax.tree.map(lambda a: (3 * rng.standard_normal(a.shape)).astype(np.float32), params)
             for _ in range(n_steps)]
    rp, tp = _j(params), _t(params)
    rs, ts = ropt.init_state(rcfg, rp), init_state(cfg, tp)
    for g in grads:
        rp, rs, rm = ropt.apply_updates(rcfg, rp, _j(g), rs)
        tp, ts, tm = apply_updates(cfg, tp, _t(g), ts)
    assert int(ts["step"]) == int(rs["step"]) == n_steps and ts["step"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=F32_RTOL)
    np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=LR_RTOL)
    for a, b in zip(jax.tree.leaves(rp), jax.tree.leaves(_np_tree(tp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=F32_RTOL, atol=1e-7)
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(rs[key]), jax.tree.leaves(_np_tree(ts[key]))):
            want = np.asarray(a, np.float32)
            if mdt == "float32":
                np.testing.assert_allclose(b, want, rtol=F32_RTOL, atol=1e-12)
            else:
                ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
                assert np.all(np.abs(b - want) <= ulp), key
    assert all(t.dtype == getattr(torch, mdt) for t in jax.tree.leaves(_np_tree(ts["m"], keep=True)))


def _np_tree(tree, keep=False):
    return jax.tree.map(lambda t: t if keep else _np(t), tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_apply_updates_keeps_bf16_params_and_makes_no_host_sync():
    cfg = AdamWConfig(moment_dtype="bfloat16")
    p = {"w": torch.ones(5, dtype=torch.bfloat16)}
    s = init_state(cfg, p)
    w_before = p["w"]
    p, s, m = apply_updates(cfg, p, {"w": torch.full((5,), 0.5, dtype=torch.bfloat16)}, s)
    assert p["w"] is w_before and p["w"].dtype == torch.bfloat16 and s["m"]["w"].dtype == torch.bfloat16
    assert all(isinstance(v, torch.Tensor) for v in m.values())


def test_init_state_matches_reference_structure():
    for compress in (False, True):
        rcfg = ropt.AdamWConfig(compress_grads=compress)
        cfg = AdamWConfig(compress_grads=compress)
        rs, ts = ropt.init_state(rcfg, _j(_toy())), init_state(cfg, _t(_toy()))
        assert sorted(rs) == sorted(ts)
        assert jax.tree.structure(jax.tree.map(lambda a: 0, rs)) == jax.tree.structure(
            jax.tree.map(lambda a: 0, ts, is_leaf=lambda x: isinstance(x, torch.Tensor)))
        assert ts["step"].shape == () and ts["m"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_int8_compression_matches_reference(scale):
    rng = np.random.default_rng(7)
    g = {"w": (scale * rng.standard_normal((33, 5))).astype(np.float32),
         "n": {"u": (scale * rng.standard_normal(7)).astype(np.float32)}}
    ef = jax.tree.map(lambda a: (0.01 * scale * rng.standard_normal(a.shape)).astype(np.float32), g)
    rq, ref_ = ropt.compress_tree(_j(g), _j(ef))
    tq, tef = compress_tree(_t(g), _t(ef))
    for key in (("w",), ("n", "u")):
        rpair, tpair = rq, tq
        for k in key:
            rpair, tpair = rpair[k], tpair[k]
        np.testing.assert_array_equal(tpair[0].numpy(), np.asarray(rpair[0]))
        np.testing.assert_allclose(float(tpair[1]), float(rpair[1]), rtol=F32_RTOL)
    for a, b in zip(jax.tree.leaves(ref_), jax.tree.leaves(_np_tree(tef))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=F32_RTOL, atol=F32_RTOL * scale * 1e-3)
    rd, td = ropt.decompress_tree(rq), decompress_tree(tq)
    for a, b in zip(jax.tree.leaves(rd), jax.tree.leaves(_np_tree(td))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=F32_RTOL)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, s = quantize_int8(x)
    rq, rs = ropt.quantize_int8(jnp.asarray(x.numpy()))
    assert float(s) == pytest.approx(1.0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(q.numpy(), [127, 0, 2, 2, 0, -2])
    assert math.isclose(float(dequantize_int8(q, s)[2]), 2.0)
