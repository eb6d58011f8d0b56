"""The port's roofline tooling (``repro_torch.launch.roofline``,
``launch.op_walk``): the twin of ``tests/test_roofline_tools.py`` on the
CPU.

* ``roofline_terms`` with the H100 constants (the reference's keyword
  arguments and output keys);
* ``collective_bytes``' ring convention (all-reduce counts twice);
* the walker's twins of ``TestHloWalk`` on meta tensors: FLOPs scale
  exactly 2x with the loop count, a dot is 2·M·N·K, nested loops multiply
  (an eager trace unrolls them, so the counts are exact), each held against
  the reference's walk of the compiled HLO of the same function within its
  elementwise estimate (5%);
* the byte convention: an op reads its inputs and writes its outputs,
  views move nothing, an in-place op reads and writes its target."""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import hlo_walk as rhw
from repro.launch import roofline as rrl
from repro_torch.launch import op_walk as ow
from repro_torch.launch import roofline as rl

torch.set_num_threads(1)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _ref_hlo(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax.jit(fn).lower(*args).compile().as_text()


class TestRooflineTerms:
    def test_h100_constants(self):
        assert (rl.HBM_BW, rl.PEAK_FLOPS, rl.F32_FLOPS, rl.F64_FLOPS, rl.NVLINK_BW) == (
            3.35e12, 989e12, 67e12, 34e12, 450e9)

    def test_dominant_selection(self):
        t = rl.roofline_terms(
            flops_per_device=989e12,         # exactly 1 s of compute
            bytes_per_device=3.35e12 * 2.0,  # 2 s of memory
            collective_bytes_per_chip=450e9 * 0.5,
            n_chips=256,
            model_flops=989e12 * 256,        # model == counted
        )
        assert t["dominant"] == "memory"
        assert t["compute_s"] == pytest.approx(1.0)
        assert t["memory_s"] == pytest.approx(2.0)
        assert t["collective_s"] == pytest.approx(0.5)
        assert t["useful_fraction"] == pytest.approx(1.0)
        assert t["roofline_fraction"] == pytest.approx(0.5)  # 1 s useful / 2 s bound

    def test_keys_are_the_references(self):
        kw = dict(flops_per_device=1e12, bytes_per_device=1e9, collective_bytes_per_chip=0.0, n_chips=1,
                  model_flops=5e11)
        assert set(rl.roofline_terms(**kw)) == set(rrl.roofline_terms(**kw))
        assert rl.roofline_terms(**kw)["dominant"] == "compute"

    def test_zero_work(self):
        t = rl.roofline_terms(flops_per_device=0.0, bytes_per_device=0.0, collective_bytes_per_chip=0.0,
                              n_chips=1, model_flops=0.0)
        assert t["useful_fraction"] == 0.0 and t["roofline_fraction"] == 0.0


class TestCollectiveBytes:
    def test_ring_convention(self):
        out = rl.collective_bytes({"all-reduce": 128 * 256 * 4, "all-gather": 64 * 512 * 2,
                                   "collective-permute": 128 * 256 * 4})
        assert out["reduce-scatter"] == 0.0 and out["all-to-all"] == 0.0
        assert out["total"] == 2 * out["all-reduce"] + out["all-gather"] + out["collective-permute"]

    def test_same_totals_as_the_reference_parser(self):
        hlo = """
ENTRY %main (p0: f32[128,256]) -> f32[128,256] {
  %p0 = f32[128,256]{1,0} parameter(0)
  %ar = f32[128,256]{1,0} all-reduce(%p0), replica_groups={}, to_apply=%add
  %ag = bf16[64,512]{1,0} all-gather(%p0), dimensions={0}
  ROOT %cp = f32[128,256]{1,0} collective-permute(%ar), source_target_pairs={{0,1}}
}
"""
        want = rrl.collective_bytes(hlo)
        assert rl.collective_bytes({k: v for k, v in want.items() if k != "total"}) == want


def _loop(n):
    def f(x, w):
        for _ in range(n):
            x = torch.tanh(x @ w)
        return x
    return f


def _ref_loop(n):
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, None, length=n)
        return y
    return f


class TestOpWalk:
    def test_trip_count_scaling_exact(self):
        flops = {n: ow.walk(_loop(n), _meta(64, 64), _meta(64, 64)).flops for n in (8, 16)}
        assert flops[16] == 2.0 * flops[8] == 2.0 * 8 * 2 * 64**3
        ref = rhw.walk(_ref_hlo(_ref_loop(8), (64, 64), (64, 64))).flops
        assert flops[8] == pytest.approx(ref, rel=0.05)

    def test_dot_flops_formula(self):
        r = ow.walk(lambda a, b: a @ b, _meta(128, 64), _meta(64, 32))
        assert r.flops == 2 * 128 * 32 * 64 and r.ops == 1
        ref = rhw.walk(_ref_hlo(lambda a, b: a @ b, (128, 64), (64, 32))).flops
        assert r.flops == pytest.approx(ref, rel=0.1)

    def test_nested_loops_multiply(self):
        def f(x, w):
            for _ in range(4):
                for _ in range(5):
                    x = torch.tanh(x @ w)
            return x

        def rf(x, w):
            def outer(c, _):
                def inner(ci, _):
                    return jnp.tanh(ci @ w), None
                ci, _ = jax.lax.scan(inner, c, None, length=5)
                return ci, None
            y, _ = jax.lax.scan(outer, x, None, length=4)
            return y

        r = ow.walk(f, _meta(32, 32), _meta(32, 32))
        assert r.flops == 4 * 5 * 2 * 32**3
        assert r.flops == pytest.approx(rhw.walk(_ref_hlo(rf, (32, 32), (32, 32))).flops, rel=0.15)

    def test_bytes_convention(self):
        a, b = _meta(128, 64), _meta(64, 32)
        r = ow.walk(lambda a, b: a @ b, a, b)
        assert r.bytes_hbm == (128 * 64 + 64 * 32 + 128 * 32) * 4
        # views (a reshape of a contiguous tensor, a transpose, a slice)
        # move nothing
        v = ow.walk(lambda a: a.reshape(-1, 32).t()[:, :8], a)
        assert v.bytes_hbm == 0 and v.ops >= 1
        # an in-place op reads its operands and writes its target
        i = ow.walk(lambda a: a.add_(1.0), _meta(10, 10))
        assert i.bytes_hbm == 2 * 10 * 10 * 4
        # a broadcast operand counts its storage, not its expanded elements
        e = ow.walk(lambda a, s: a * s.expand(128, 64), a, _meta(1, 64))
        assert e.bytes_hbm == (128 * 64 * 2 + 64) * 4

    def test_peak_live_follows_lifetimes(self):
        """A loop that frees each step's tensors holds a bounded set alive;
        one that keeps them all grows with the trips."""
        x, w = _meta(64, 64), _meta(64, 64)
        step = 64 * 64 * 4
        freed = ow.walk(_loop(16), x, w)
        assert freed.peak_bytes <= 3 * step

        def keep(x, w):
            outs = []
            for _ in range(16):
                x = torch.tanh(x @ w)
                outs.append(x)
            return outs

        kept = ow.walk(keep, x, w)
        assert kept.peak_bytes >= 16 * step and len(kept.result) == 16
