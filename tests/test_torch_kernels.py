"""Plain versions of the port's kernels (the CPU path of
``repro_torch.kernels.ops``) against the JAX package's Pallas kernels (in
interpret mode) and host or jnp oracles.

Tolerances: rtol = atol = 2e-5 in float32 for the bound scans
(``tests/test_kernels.py::_tol``: the GEMM-form head sums in another order
than the oracle's difference form), 3e-4 for the float32 projection K4 and
1e-4 for the float32 JSD K5 (``TestApexProject``, ``TestJsdPairwise`` there),
1e-12 in float64.  Selections are compared exactly: against a lexsort over
the plain version's own bound matrices, and id for id against the Pallas
kernels.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.compat import enable_x64
from repro.core.simplex import apex_gemm_np
from repro.core.surrogate import truncate_apexes_np
from repro.data import colors_like
from repro.index.select import topk_pairs_oracle
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.metrics import get_metric as rget
from repro_torch.core import NSimplexProjector, select_pivots
from repro_torch.kernels import ops, ref
from repro_torch.metrics import get_metric

# small shapes: one intra-op thread keeps these tests from crowding the
# other pytest workers
torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=2e-5)
F64 = dict(rtol=1e-12, atol=1e-12)
BLOCKS = dict(block_q=8, block_n=256)
SENTINEL = 2**31 - 1


def _apexes(N, n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(N, n)) * 0.3
    a[:, -1] = np.abs(a[:, -1])  # altitudes are nonnegative
    return a.astype(dtype)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(*ts):
    return tuple(np.asarray(t) for t in ts)


class TestApexBounds:
    """K6: one query, difference form."""

    @pytest.mark.parametrize("N", [1, 7, 1025])
    def test_f32_against_pallas_and_oracle(self, N):
        table, query = _apexes(N, 12, seed=N), _apexes(1, 12, seed=N + 1)[0]
        lwb, upb = _np(*ops.apex_bounds(_t(table), _t(query)))
        kl, ku = _np(*rops.apex_bounds(table, query))
        ol, ou = _np(*rref.apex_bounds_ref(jnp.asarray(table), jnp.asarray(query)))
        for got, want in ((lwb, kl), (upb, ku), (lwb, ol), (upb, ou)):
            np.testing.assert_allclose(got, want, **F32)

    def test_f64(self):
        table, query = _apexes(600, 12, seed=3, dtype=np.float64), _apexes(1, 12, seed=4, dtype=np.float64)[0]
        lwb, upb = _np(*ops.apex_bounds(_t(table), _t(query)))
        with enable_x64(True):
            kl, ku = _np(*rops.apex_bounds(table, query))
        assert lwb.dtype == np.float64
        np.testing.assert_allclose(lwb, kl, **F64)
        np.testing.assert_allclose(upb, ku, **F64)


class TestApexBoundsBatch:
    """K1: a query block, GEMM form, dims truncation."""

    @pytest.mark.parametrize("dims", [2, 3, 4, 5, 6, 7, 8])
    @pytest.mark.parametrize("pretruncated", [False, True])
    def test_every_dims_f32(self, dims, pretruncated):
        n = 8
        table, queries = _apexes(300, n, seed=dims), _apexes(5, n, seed=dims + 50)
        if pretruncated:
            queries = truncate_apexes_np(queries, dims).astype(np.float32)
        lwb, upb = _np(*ops.apex_bounds_batch(_t(table), _t(queries), dims=dims))
        ol, ou = _np(*rref.apex_bounds_batch_ref(jnp.asarray(table), jnp.asarray(queries), dims=dims))
        np.testing.assert_allclose(lwb, ol, **F32)
        np.testing.assert_allclose(upb, ou, **F32)

    @pytest.mark.parametrize("dims", [None, 5])
    def test_f32_against_pallas(self, dims):
        table, queries = _apexes(700, 16, seed=21), _apexes(9, 16, seed=22)
        lwb, upb = _np(*ops.apex_bounds_batch(_t(table), _t(queries), dims=dims))
        kl, ku = _np(*rops.apex_bounds_batch(table, queries, dims=dims, **BLOCKS))
        np.testing.assert_allclose(lwb, kl, **F32)
        np.testing.assert_allclose(upb, ku, **F32)

    @pytest.mark.parametrize("dims", [None, 2, 9])
    def test_f64(self, dims):
        table = _apexes(400, 12, seed=31, dtype=np.float64)
        queries = _apexes(6, 12, seed=32, dtype=np.float64)
        lwb, upb = _np(*ops.apex_bounds_batch(_t(table), _t(queries), dims=dims))
        with enable_x64(True):
            kl, ku = _np(*rops.apex_bounds_batch(table, queries, dims=dims, **BLOCKS))
            ol, ou = _np(*rref.apex_bounds_batch_ref(jnp.asarray(table), jnp.asarray(queries), dims=dims))
        for got, want in ((lwb, kl), (upb, ku), (lwb, ol), (upb, ou)):
            np.testing.assert_allclose(got, want, **F64)

    def test_bad_dims_raise(self):
        table, queries = _t(_apexes(10, 6, seed=1)), _t(_apexes(2, 6, seed=2))
        for dims in (1, 7):
            with pytest.raises(ValueError):
                ops.apex_bounds_batch(table, queries, dims=dims)
        with pytest.raises(ValueError):
            ops.apex_bounds_batch(table, queries[:, :4], dims=5)

    def test_soundness_slack_contains_f64_bounds(self):
        """f32 bounds widened by ``_kernel_err_sq`` contain the f64
        difference-form bounds: the exactness of every index path rests on it."""
        from repro_torch.api import build_index
        from repro_torch.data import colors_like

        X = colors_like(n=700, seed=23).astype(np.float64)
        inner = build_index(X[:650], "euclidean", n_pivots=16, seed=2, device="cpu")._inner
        apexes = inner.query_apex_batch(X[650:680])
        true_l, true_u = _np(*rref.apex_bounds_batch_ref(inner.table.numpy(), apexes.numpy()))
        kern_l, kern_u = (b.numpy() for b in inner.bounds_batch(apexes))
        err_sq = inner._kernel_err_sq(apexes.numpy())
        assert np.all(np.sqrt(np.maximum(kern_l**2 - err_sq, 0.0)) <= true_l + 1e-12)
        assert np.all(np.sqrt(kern_u**2 + err_sq) >= true_u - 1e-12)


def _host_topk(keys, k, live=None):
    """Per-row ``np.lexsort((ids, keys))`` over the live rows, first k."""
    out = []
    for q in range(keys.shape[0]):
        cand = np.arange(keys.shape[1]) if live is None else np.flatnonzero(live)
        out.append(cand[np.lexsort((cand, keys[q, cand]))][:k])
    return out


class TestFusedTopK:
    """K2: top-k by (key, id)."""

    @pytest.mark.parametrize("key", ["lwb", "upb", "mid"])
    @pytest.mark.parametrize("dims", [None, 6])
    def test_equals_lexsort_and_pallas(self, key, dims):
        table, queries = _apexes(700, 24, seed=1), _apexes(9, 24, seed=2)
        k = 13
        ids, lwb_k, upb_k = _np(*ops.apex_bounds_topk(_t(table), _t(queries), k, key=key, dims=dims))
        lwb, upb = _np(*ops.apex_bounds_batch(_t(table), _t(queries), dims=dims))
        keys = {"lwb": lwb, "upb": upb, "mid": np.float32(0.5) * (lwb + upb)}[key]
        for q, order in enumerate(_host_topk(keys, k)):
            np.testing.assert_array_equal(ids[q], order)
            np.testing.assert_array_equal(lwb_k[q], lwb[q, order])
            np.testing.assert_array_equal(upb_k[q], upb[q, order])
        pids, plwb, pupb = _np(*rops.apex_bounds_topk(table, queries, k, key=key, dims=dims, **BLOCKS))
        np.testing.assert_array_equal(ids, pids)
        np.testing.assert_allclose(lwb_k, plwb, **F32)
        np.testing.assert_allclose(upb_k, pupb, **F32)

    def test_matches_select_oracle(self):
        table, queries = _apexes(300, 16, seed=5), _apexes(6, 16, seed=6)
        ids, lwb_k, _ = _np(*ops.apex_bounds_topk(_t(table), _t(queries), 7, key="lwb"))
        lwb, _ = _np(*ops.apex_bounds_batch(_t(table), _t(queries)))
        oid, ovals = topk_pairs_oracle(lwb, 7)
        np.testing.assert_array_equal(ids, oid)
        np.testing.assert_array_equal(lwb_k.astype(np.float64), ovals)

    def test_duplicate_ties_break_by_ascending_id(self):
        table = np.repeat(_apexes(64, 12, seed=7), 4, axis=0)  # every key 4x
        queries = _apexes(5, 12, seed=8)
        ids, _, _ = _np(*ops.apex_bounds_topk(_t(table), _t(queries), 10, key="mid"))
        pids, _, _ = _np(*rops.apex_bounds_topk(table, queries, 10, key="mid", **BLOCKS))
        np.testing.assert_array_equal(ids, pids)
        lwb, upb = _np(*ops.apex_bounds_batch(_t(table), _t(queries)))
        keys = np.float32(0.5) * (lwb + upb)
        for q, order in enumerate(_host_topk(keys, 10)):
            np.testing.assert_array_equal(ids[q], order)
            same = np.diff(keys[q][ids[q]]) == 0
            assert np.all(np.diff(ids[q])[same] > 0)

    def test_k_at_least_n_clamps(self):
        table, queries = _apexes(37, 10, seed=3), _apexes(4, 10, seed=4)
        ids, _, _ = _np(*ops.apex_bounds_topk(_t(table), _t(queries), 100, key="lwb"))
        assert ids.shape == (4, 37)
        for q in range(4):
            assert sorted(ids[q].tolist()) == list(range(37))

    def test_rowmask_and_sentinel_padding(self):
        table, queries = _apexes(200, 10, seed=9), _apexes(3, 10, seed=10)
        mask = np.zeros(200, dtype=bool)
        mask[[3, 50, 51, 199]] = True
        ids, lwb_k, upb_k = _np(*ops.apex_bounds_topk(_t(table), _t(queries), 6, key="upb", rowmask=mask))
        pids, _, _ = _np(*rops.apex_bounds_topk(table, queries, 6, key="upb", rowmask=mask, **BLOCKS))
        np.testing.assert_array_equal(ids, pids)
        lwb, upb = _np(*ops.apex_bounds_batch(_t(table), _t(queries)))
        for q, order in enumerate(_host_topk(upb, 6, live=mask)):
            np.testing.assert_array_equal(ids[q, :4], order)
            assert np.all(ids[q, 4:] == SENTINEL)
            assert np.all(np.isinf(lwb_k[q, 4:])) and np.all(np.isinf(upb_k[q, 4:]))

    def test_f64_table_raises(self):
        """An f64 table is answered in f64 (the reference works in the
        table's dtype); it raises only beside f32 queries, as every kernel
        raises on operands of two dtypes."""
        table = _t(_apexes(20, 6, seed=1, dtype=np.float64))
        with pytest.raises(TypeError):
            ops.apex_bounds_topk(table, table[:2].float(), 3, key="lwb")
        with pytest.raises(TypeError):
            ops.apex_bounds_threshold(table, table[:2].float(), np.ones(2), 3)
        ids, lwb, _ = ops.apex_bounds_topk(table, table[:2], 3, key="lwb")
        assert lwb.dtype == torch.float64 and ids[:, 0].tolist() == [0, 1]
        _, lwb, _, counts = ops.apex_bounds_threshold(table, table[:2], np.ones(2), 3)
        assert lwb.dtype == torch.float64 and counts.dtype == torch.int32

    def test_negative_zero_key_packs_smallest(self):
        keys = torch.tensor([[0.5, -0.0, 0.25]], dtype=torch.float32)
        packed = ref.pack_keys(keys, torch.ones_like(keys, dtype=torch.bool))
        assert torch.argsort(packed[0]).tolist() == [1, 2, 0]


class TestFusedThreshold:
    """K3: the cap smallest (lwb, id) under a per-query threshold + counts."""

    @pytest.mark.parametrize("cap", [1, 16, 64, 513])
    def test_counts_exact_and_selection_matches(self, cap):
        table, queries = _apexes(513, 20, seed=11), _apexes(7, 20, seed=12)
        lwb, _ = _np(*ops.apex_bounds_batch(_t(table), _t(queries)))
        thresholds = np.quantile(lwb, 0.1, axis=1).astype(np.float32)
        ids, lwb_t, _, counts = _np(*ops.apex_bounds_threshold(_t(table), _t(queries), thresholds, cap))
        pids, plwb, _, pcounts = _np(*rops.apex_bounds_threshold(table, queries, thresholds, cap, **BLOCKS))
        np.testing.assert_array_equal(counts, pcounts)
        for q in range(queries.shape[0]):
            hits = np.where(lwb[q] <= thresholds[q])[0]
            assert counts[q] == len(hits)
            want = hits[np.lexsort((hits, lwb[q, hits]))][:cap]
            got = ids[q][ids[q] != SENTINEL]
            np.testing.assert_array_equal(got, want)   # overflow keeps the cap smallest
            np.testing.assert_array_equal(lwb_t[q][: len(want)], lwb[q, want])
            np.testing.assert_array_equal(got, pids[q][pids[q] != SENTINEL])

    def test_empty_results(self):
        table, queries = _apexes(100, 12, seed=13), _apexes(3, 12, seed=14)
        ids, lwb_t, upb_t, counts = _np(
            *ops.apex_bounds_threshold(_t(table), _t(queries), np.full(3, -1.0, np.float32), 16)
        )
        assert np.all(counts == 0)
        assert np.all(ids == SENTINEL)
        assert np.all(np.isinf(lwb_t)) and np.all(np.isinf(upb_t))

    def test_overflow_with_rowmask(self):
        table, queries = _apexes(200, 12, seed=15), _apexes(2, 12, seed=16)
        mask = np.arange(200) % 3 == 0
        ids, _, _, counts = _np(
            *ops.apex_bounds_threshold(_t(table), _t(queries), np.full(2, np.inf, np.float32), 8, rowmask=mask)
        )
        pids, _, _, pcounts = _np(
            *rops.apex_bounds_threshold(table, queries, np.full(2, np.inf, np.float32), 8, rowmask=mask, **BLOCKS)
        )
        assert np.all(counts == mask.sum()) and np.array_equal(counts, pcounts)
        np.testing.assert_array_equal(ids, pids)
        assert np.all(mask[ids])


def _projector(n, seed):
    """A port projector fitted on colors pivots, and the float64 pivot
    distances of 700 held-out colors rows."""
    X = colors_like(n=800, seed=seed).astype(np.float64)
    proj = NSimplexProjector(select_pivots(X[:100], n, seed=seed), get_metric("euclidean"), device="cpu")
    return proj, proj.pivot_distances(_t(X[100:]))


class TestApexProject:
    """K4: (B, n) pivot distances -> (B, n) apexes."""

    @pytest.mark.parametrize("B", [1, 33, 512])
    @pytest.mark.parametrize("n", [4, 20])
    def test_f32_against_pallas(self, B, n):
        proj, dists = _projector(n, seed=B % 7)
        d32 = dists[:B].float()
        got = ops.apex_project(d32, _t(proj.Linv).float(), _t(proj.sq_norms).float())
        want = rops.apex_project(d32.numpy(), proj.Linv, proj.sq_norms, block_b=128)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)

    @pytest.mark.parametrize("n", [4, 20, 33])
    def test_f64_against_host_gemm(self, n):
        proj, dists = _projector(n, seed=n)
        got = ops.apex_project(dists, _t(proj.Linv), _t(proj.sq_norms))
        want = apex_gemm_np(proj.Linv, proj.sq_norms, dists.numpy())
        np.testing.assert_allclose(got.numpy(), want, **F64)
        np.testing.assert_allclose(proj.project_distances(dists).numpy(), want, **F64)

    @pytest.mark.parametrize("k", [2, 7, 20])
    def test_prefix_projector(self, k):
        """``truncate(k)`` projects the first k pivot distances through the
        leading blocks of ``L⁻¹`` and the squared norms."""
        proj, dists = _projector(20, seed=k)
        got = proj.truncate(k).project_distances(dists[:, :k])
        want = apex_gemm_np(proj.Linv[: k - 1, : k - 1], proj.sq_norms[: k - 1], dists[:, :k].numpy())
        np.testing.assert_allclose(got.numpy(), want, **F64)
        one = proj.truncate(k).project_distances(dists[0, :k])
        assert one.shape == (k,)
        np.testing.assert_allclose(one.numpy(), want[0], **F64)

    def test_bad_operands_raise(self):
        proj, dists = _projector(6, seed=1)
        Linv, sq = _t(proj.Linv), _t(proj.sq_norms)
        with pytest.raises(ValueError):
            ops.apex_project(dists[:, :5], Linv, sq)
        with pytest.raises(ValueError):
            ops.apex_project(dists[0], Linv, sq)
        with pytest.raises(TypeError):
            ops.apex_project(dists.float(), Linv, sq)

    @pytest.mark.parametrize(
        "case,error",
        [
            ("1-D distances", ValueError),
            ("3-D distances", ValueError),
            ("one pivot", ValueError),
            ("Linv too narrow", ValueError),
            ("Linv not square", ValueError),
            ("sq_norms too long", ValueError),
            ("f32 distances, f64 Linv", TypeError),
            ("f64 distances, f32 sq_norms", TypeError),
            ("f16 operands", TypeError),
            ("int64 distances", TypeError),
            ("unknown plan", ValueError),
        ],
    )
    def test_refused_operands_still_raise(self, case, error):
        """Every operand the wrapper refused before its launch path was cut
        is still refused, on the CPU too."""
        proj, dists = _projector(6, seed=1)
        d, L, s = dists[:4], _t(proj.Linv), _t(proj.sq_norms)
        args, kw = {
            "1-D distances": ((d[0], L, s), {}),
            "3-D distances": ((d[None], L, s), {}),
            "one pivot": ((d[:, :1], L[:0, :0], s[:0]), {}),
            "Linv too narrow": ((d, L[:, :4], s), {}),
            "Linv not square": ((d, L[:4], s), {}),
            "sq_norms too long": ((d, L, torch.cat([s, s[:1]])), {}),
            "f32 distances, f64 Linv": ((d.float(), L, s), {}),
            "f64 distances, f32 sq_norms": ((d, L, s.float()), {}),
            "f16 operands": ((d.half(), L.half(), s.half()), {}),
            "int64 distances": ((d.long(), L.long(), s.long()), {}),
            "unknown plan": ((d, L, s), {"_plan": "tile"}),
        }[case]
        with pytest.raises(error):
            ops.apex_project(*args, **kw)

    def test_vector_path_refuses_what_the_wrapper_refuses(self):
        """The projector's (n,) entry takes one row only and checks its
        operands as ``apex_project`` does."""
        proj, dists = _projector(6, seed=1)
        Linv, sq = _t(proj.Linv), _t(proj.sq_norms)
        for bad in (dists[:2], dists[0, :1], dists[0, :5]):
            with pytest.raises(ValueError):
                ops._apex_project_vector(bad, Linv, sq)
        with pytest.raises(TypeError):
            ops._apex_project_vector(dists[0].float(), Linv, sq)
        assert torch.equal(ops._apex_project_vector(dists[0], Linv, sq), ops.apex_project(dists[:1], Linv, sq)[0])

    @pytest.mark.parametrize("form", ["(n,) f64", "(B, n) f64", "(n,) f32", "(B, n) f32", "(B, n) numpy f64",
                                      "(n,) numpy f32", "(B, n) strided", "(B, n) prefix"])
    def test_project_distances_unchanged(self, form):
        """The projector's lean path (no conversion of f64 distances already on
        its device, no atleast_2d) gives the bits of the plain projection of
        the same distances as f64 (B, n) rows."""
        proj, dists = _projector(20, seed=3)
        p, d = (proj.truncate(7), dists[:9, :7]) if form.endswith("prefix") else (proj, dists[:9])
        if form.endswith("strided"):
            d = dists[:18:2]
        inp = {"(n,) f64": d[0], "(B, n) f64": d, "(n,) f32": d[0].float(), "(B, n) f32": d.float(),
               "(B, n) numpy f64": d.numpy(), "(n,) numpy f32": d[0].float().numpy(),
               "(B, n) strided": d, "(B, n) prefix": d}[form]
        rows = torch.atleast_2d(torch.as_tensor(inp, dtype=torch.float64))
        want = ref.apex_project_ref(rows.contiguous(), p._Linv_t, p._sq_norms_t)
        got = p.project_distances(inp)
        assert got.dtype == torch.float64 and got.shape == (want.shape[1:] if form.startswith("(n,)") else want.shape)
        assert torch.equal(got, want[0] if form.startswith("(n,)") else want)


def _dirichlet(rows, d, seed, dtype=np.float32):
    return np.random.default_rng(seed).dirichlet(np.full(d, 0.5), size=rows).astype(dtype)


class TestJsdPairwise:
    """K5: pairwise sqrt-JSD in bits, rows L1-normalised by the wrapper."""

    @pytest.mark.parametrize("Q,P", [(1, 1), (5, 9), (33, 20)])
    def test_f32_against_pallas(self, Q, P):
        X, Y = _dirichlet(Q, 112, Q) * 2.5, _dirichlet(P, 112, P + 50)
        got = ops.jsd_pairwise(_t(X), _t(Y))
        want = rops.jsd_pairwise(X, Y, block_q=32, block_p=32)
        assert got.dtype == torch.float32 and got.shape == (Q, P)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    def test_f64_against_pallas(self):
        X, Y = _dirichlet(17, 112, 1, np.float64) * 7.0, _dirichlet(11, 112, 2, np.float64)
        got = ops.jsd_pairwise(_t(X), _t(Y))
        with enable_x64(True):
            want = np.asarray(rops.jsd_pairwise(X, Y, block_q=32, block_p=32))
        assert want.dtype == np.float64
        np.testing.assert_allclose(got.numpy(), want, **F64)

    @pytest.mark.parametrize("Q,P", [(1, 40), (6, 3)])
    def test_wide_rows_against_host_cross(self, Q, P):
        """d = 700 lies beyond the TPU kernel's d <= 512; the host ``cross_np``
        is the reference there."""
        X, Y = _dirichlet(Q, 700, 3, np.float64), _dirichlet(P, 700, 4, np.float64)
        got = ops.jsd_pairwise(_t(X), _t(Y))
        np.testing.assert_allclose(got.numpy(), rget("jensen_shannon").cross_np(X, Y), **F64)

    def test_metric_cross_and_one_to_many(self):
        X = colors_like(n=60, seed=8).astype(np.float64)
        m = get_metric("jensen_shannon")
        got = ops.jsd_pairwise(_t(X[:20]), _t(X[20:]))
        np.testing.assert_allclose(got.numpy(), m.cross(_t(X[:20]), _t(X[20:])).numpy(), **F64)
        np.testing.assert_allclose(got[3].numpy(), m.one_to_many(_t(X[3]), _t(X[20:])).numpy(), **F64)

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError):
            ops.jsd_pairwise(_t(_dirichlet(2, 8, 1)), _t(_dirichlet(2, 9, 2)))


def test_cpu_tensors_never_count_launches():
    ops.reset_launches()
    table = _t(_apexes(50, 6, seed=1))
    ops.apex_bounds(table, table[0])
    ops.apex_bounds_batch(table, table[:3])
    ops.apex_bounds_topk(table, table[:3], 4, key="lwb")
    ops.apex_bounds_threshold(table, table[:3], np.ones(3), 4)
    ops.apex_project(table.double(), torch.eye(5, dtype=torch.float64), torch.ones(5, dtype=torch.float64))
    ops.jsd_pairwise(table.abs(), table.abs())
    assert set(ops.LAUNCHES.values()) == {0}


class TestLaunchPlans:
    """The launch planning the CUDA wrappers do in Python (the CPU runs no
    kernel, so these are the tests that reach it here)."""

    @pytest.mark.parametrize(
        "k,G",
        [(1, 15), (10, 15), (32, 15), (33, 14), (64, 14), (65, 12), (128, 12), (129, 10), (256, 10),
         (257, 8), (512, 8), (513, 4), (1024, 4), (1025, 2), (2048, 2), (2049, 1), (4096, 1)],
    )
    def test_topk_group_size_from_k(self, k, G):
        """G = min(32, 64 KiB / ((wp + max(wp, 512)) * 8)) before balancing:
        a group's selection state fits its shared-memory budget."""
        got, _ = ops.topk_plan(k, 10_000, 1_000_000, 132)
        assert got == G
        wp = 1 << (k - 1).bit_length()
        assert got * (wp + max(wp, 512)) * 8 <= 64 * 1024

    @pytest.mark.parametrize("Q", [1, 2, 19, 64, 65, 256, 257])
    @pytest.mark.parametrize("k", [10, 64, 257, 4096])
    def test_topk_groups_balanced_and_card_filled(self, Q, k):
        G, S = ops.topk_plan(k, Q, 1_000_000, 132)
        G_max, _ = ops.topk_plan(k, 10_000, 1_000_000, 132)
        groups = -(-Q // G)
        assert 1 <= G <= min(Q, G_max)
        assert groups == -(-Q // min(Q, G_max))          # balancing adds no group
        assert groups * G - Q < groups                   # groups differ by at most one query
        assert 1 <= S <= 64 and -(-1_000_000 // S) >= 8192 - 1
        assert groups * S >= min(2 * 132, groups * 64)   # two waves, unless capped at 64 slices

    @pytest.mark.parametrize(
        "name,cuda_name",
        [("_TOPK_GROUP_BYTES", "kGroupBytes"), ("_TOPK_MAX_GROUP", "kMaxGroup"), ("_TOPK_MIN_CAND", "kMinCandGroup")],
    )
    def test_topk_plan_constants_match_the_kernel(self, name, cuda_name):
        """topk_plan's budget is the one run_topk enforces in select_epilogue.cu."""
        src = (Path(ops.__file__).parent / "csrc" / "select_epilogue.cu").read_text()
        found = re.findall(rf"constexpr int {cuda_name} = (\d+);", src)
        assert found == [str(getattr(ops, name))]

    def test_topk_plan_small_table(self):
        assert ops.topk_plan(10, 64, 5000, 132) == (13, 1)

    def test_topk_plan_at_the_main_path_shape(self):
        """(Q 64, k 10): 5 groups of 13 queries, 53 slices; the table is read
        5 times, not 64."""
        assert ops.topk_plan(10, 64, 1_000_000, 132) == (13, 53)
        assert ops.topk_plan(64, 64, 1_000_000, 132) == (13, 53)

    @pytest.mark.parametrize(
        "name,cuda_name,source",
        [
            ("_THR_GROUP_BYTES", "kThrGroupBytes", "select_epilogue.cu"),
            ("_THR_CAND", "kThrCand", "select_epilogue.cu"),
            ("_THR_GATHER", "kGatherSlices", "select_epilogue.cu"),
            ("_K4_MAX_HEAD", "kMaxHead", "apex_project.cu"),
        ],
    )
    def test_k3_and_k1_plan_constants_match_the_kernels(self, name, cuda_name, source):
        """threshold_plan's budget is the one run_threshold enforces."""
        src = (Path(ops.__file__).parent / "csrc" / source).read_text()
        found = re.findall(rf"constexpr int {cuda_name} = (\d+);", src)
        assert found == [str(getattr(ops, name))]

    @pytest.mark.parametrize("name,plan", [("kPlanRow", "row"), ("kPlanStream", "stream"), ("kPlanWarp", "warp")])
    def test_k4_plan_codes_match_the_kernel(self, name, plan):
        """The plan codes the wrapper passes are the ones apex_project.cu
        dispatches on."""
        src = (Path(ops.__file__).parent / "csrc" / "apex_project.cu").read_text()
        assert re.findall(rf"constexpr int {name} = (\d+);", src) == [str(ops._K4_PLANS[plan])]

    @pytest.mark.parametrize(
        "shape,plan",
        [
            ((1, 20), "warp"),             # a 1-D query's apex
            ((1, 10), "warp"),             # the approximate path's 10-pivot prefix
            ((64, 10), "warp"),
            ((64, 20), "warp"),            # a query block
            ((1_000_000, 20), "stream"),   # the table build
            ((1_000_000, 10), "stream"),
            ((64, 34), "row"),             # wider than the templated heads
        ],
    )
    def test_apex_project_plan_at_the_main_path_shapes(self, shape, plan):
        assert ops.apex_project_plan(*shape, 132) == plan

    @pytest.mark.parametrize("B", [0, 1, 264, 2111, 2112, 2113, 5000, 10**6])
    @pytest.mark.parametrize("n", [2, 3, 20, 33, 34, 65, 100])
    def test_apex_project_plan_limits(self, B, n):
        """The first design only for heads wider than 32; otherwise one warp
        per row up to 16 rows per SM, the stream plan above."""
        plan = ops.apex_project_plan(B, n, 132)
        if n - 1 > 32:
            assert plan == "row"
        else:
            assert plan == ("warp" if B <= 2112 else "stream")

    @pytest.mark.parametrize("plan", ["row", "stream", "warp"])
    @pytest.mark.parametrize("B", [1, 300])
    def test_k4_forced_plan_leaves_the_cpu_result(self, plan, B):
        """K4's private ``_plan`` is checked, and the CPU result stays the
        plain version's."""
        proj, dists = _projector(20, seed=2)
        Linv, sq = _t(proj.Linv), _t(proj.sq_norms)
        assert torch.equal(ops.apex_project(dists[:B], Linv, sq, _plan=plan), ops.apex_project(dists[:B], Linv, sq))

    @pytest.mark.parametrize("cap", [1, 10, 257, 512, 513, 2048, 4096])
    @pytest.mark.parametrize("Q", [1, 2, 16, 17, 19, 64, 65, 257])
    def test_threshold_plan(self, cap, Q):
        """G = min(Q, 16) candidate buffers of 512 keys in 64 KiB, balanced
        over the groups, at any cap (the keys a query keeps live in global
        memory); S fills the card; G = 1 only for one query."""
        G, S = ops.threshold_plan(cap, Q, 1_000_000, 132)
        groups = -(-Q // G)
        assert 1 <= G <= min(Q, 16) and (G == 1) == (Q == 1)
        assert G * 512 * 8 <= 64 * 1024
        assert groups == -(-Q // 16) and groups * G - Q < groups
        assert 1 <= S <= 64 and groups * S >= min(2 * 132, groups * 64)

    def test_threshold_plan_at_the_main_path_shapes(self):
        """(Q 64, cap 512 or 4096): 4 groups of 16 queries, 64 slices; the
        table is read 4 times, not 64; one query is a group of one."""
        assert ops.threshold_plan(512, 64, 1_000_000, 132) == (16, 64)
        assert ops.threshold_plan(4096, 64, 1_000_000, 132) == (16, 64)
        assert ops.threshold_plan(4096, 8, 1_000_000, 132) == (8, 64)
        assert ops.threshold_plan(512, 1, 1_000_000, 132) == (1, 64)

    @pytest.mark.parametrize("plan", ["tile", "stream"])
    @pytest.mark.parametrize("Q", [1, 65, 130])
    def test_k1_forced_plan_leaves_the_cpu_result(self, plan, Q):
        """K1's private ``_plan`` (timing and tests; the card runs the stream
        plan by default at every Q, in 64-query chunks) is checked, and the
        CPU result stays the plain version's."""
        table = _t(_apexes(200, 6, seed=1))
        for a, b in zip(ops.apex_bounds_batch(table, table[:Q], _plan=plan), ops.apex_bounds_batch(table, table[:Q])):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("plan", [(3, 1), (0, 2), (1, 64)])
    def test_k3_forced_plan_leaves_the_cpu_result(self, plan):
        """K3's private ``_plan`` (G = 0: the first design, one query per
        block) is checked, and the CPU result stays the plain version's."""
        table = _t(_apexes(50, 6, seed=1))
        for a, b in zip(ops.apex_bounds_threshold(table, table[:3], np.ones(3), 4, _plan=plan),
                        ops.apex_bounds_threshold(table, table[:3], np.ones(3), 4)):
            assert torch.equal(a, b)

    def test_forced_plans_are_checked_on_the_cpu_too(self):
        """A private ``_plan`` the kernels would refuse raises before any
        dispatch."""
        table = _t(_apexes(50, 6, seed=1))
        for plan in ("wide", "Tile"):
            with pytest.raises(ValueError, match="launch plan"):
                ops.apex_bounds_batch(table, table[:3], _plan=plan)
        for plan in ((-1, 2), (33, 2), (3, 0), (3,)):
            with pytest.raises(ValueError, match="launch plan"):
                ops.apex_bounds_threshold(table, table[:3], np.ones(3), 4, _plan=plan)
        for n, plan in ((20, "Row"), (20, "tile"), (34, "stream"), (34, "warp")):
            proj, dists = _projector(n, seed=1)
            with pytest.raises(ValueError, match="launch plan"):
                ops.apex_project(dists[:3], _t(proj.Linv), _t(proj.sq_norms), _plan=plan)

    @pytest.mark.parametrize(
        "shape,plan",
        [
            ((1, 256, 112), (32, 0, 0)),          # refinement chunk
            ((1, 64, 112), (32, 0, 0)),           # approximate refine
            ((64, 20, 112), (32, 0, 0)),          # query pivot distances
            ((1, 4096, 112), (16, 0, 0)),
            ((1, 1, 1), (1, 1, 1)),               # d = 1 cannot split
            ((1000, 20, 17), (2, 0, 0)),
            ((64, 4096, 112), (1, 32, 32)),
            ((1_000_000, 20, 112), (1, 51, 20)),  # the table build
        ],
    )
    def test_jsd_plan(self, shape, plan):
        assert ops.jsd_plan(*shape, 132) == plan

    @pytest.mark.parametrize("Q", [1, 3, 64, 1000, 10**6])
    @pytest.mark.parametrize("P", [1, 20, 256, 4097, 10**5])
    @pytest.mark.parametrize("d", [1, 2, 17, 112, 600])
    def test_jsd_plan_limits(self, Q, P, d):
        """lanes: a power of two <= min(32, d) and the split plan only
        while pairs x lanes <= 512 threads per SM; tile: bq, bp <= 128 and at
        most 4 pairs per thread of 256."""
        lanes, bq, bp = ops.jsd_plan(Q, P, d, 132)
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        if lanes > 1:
            assert lanes <= d and Q * P * lanes <= 132 * 512 and (bq, bp) == (0, 0)
        else:
            assert 1 <= bq <= min(Q, 128) and 1 <= bp <= min(P, 128) and bq * bp <= 4 * 256
            assert d < 4 or Q * P * 2 > 132 * 512

    @pytest.mark.parametrize(
        "name,shape,cls",
        [
            ("apex_bounds", dict(n=20, dtype="float32"), (20, "float32")),
            ("apex_bounds_batch", dict(Q=1, dims=10), (1, 10)),
            ("apex_topk", dict(Q=64, k=64, key="mid", dims=10), (64, 64, "mid", 10)),
            ("apex_threshold", dict(Q=64, cap=512, dims=20), (64, 512, 20)),
            ("apex_topk", dict(Q=64, k=10, key="upb", dims=20, masked=True), (64, 10, "upb", 20, "masked")),
            ("apex_threshold", dict(Q=64, cap=512, dims=20, masked=True), (64, 512, 20, "masked")),
            ("apex_threshold", dict(Q=64, cap=512, dims=20, masked=False), (64, 512, 20)),
            ("apex_project", dict(B=1, n=20, dtype="float64"), (1, 20, "float64")),
            ("jsd_pairwise", dict(Q=1, P=20, d=112, dtype="float64"), (1, 20, 112, "float64")),
            ("jsd_pairwise", dict(Q=1, P=32, d=112, dtype="float64"), (1, 32, 112, "float64")),
            ("jsd_pairwise", dict(Q=1, P=33, d=112, dtype="float64"), (1, 64, 112, "float64")),
            ("jsd_pairwise", dict(Q=1, P=200, d=112, dtype="float64"), (1, 256, 112, "float64")),
            ("jsd_pairwise", dict(Q=1, P=256, d=112, dtype="float64"), (1, 256, 112, "float64")),
        ],
    )
    def test_shape_class(self, name, shape, cls):
        assert ops.shape_class(name, **shape) == cls

    def test_shape_class_unknown_kernel(self):
        with pytest.raises(KeyError):
            ops.shape_class("apex_nothing", Q=1)

    def test_reset_clears_shape_counts(self):
        ops.SHAPE_LAUNCHES["jsd_pairwise"][(1, 256, 112, "float64")] = 3
        ops.reset_launches()
        assert all(by == {} for by in ops.SHAPE_LAUNCHES.values())
        assert set(ops.SHAPE_LAUNCHES) == set(ops.LAUNCHES)
