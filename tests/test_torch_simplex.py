"""The twin of ``tests/test_simplex.py`` for the port: simplex
construction, the bound guarantees, the apex forms against each other
(Algorithm 2, ``apex_addition``, ``apex_solve``, ``apex_gemm``) and the
projector's three modes, ``out_dim`` and ``truncated`` (Lemma 2), each held
against the JAX package's counterpart on the same numpy inputs (float64,
the reference under ``enable_x64``; tolerances as the reference test's, and
1e-10 between the packages' float64 apexes).  An apex's altitude is a sqrt
that is ~0 for a row at a pivot, where 1e-16 of rounding under it becomes
1e-8 over it: the last column is compared squared (``_apex_close``).  The
reference's Euclidean ``cross`` is the bare GEMM identity, whose
cancellation leaves ~1e-9 in a near-pivot distance that the port recomputes
in difference form: bounds agree across packages within 1e-8."""

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import NSimplexProjector as RProjector
from repro.core import apex_addition_jax as rapex_jax
from repro.core import apex_gemm as rapex_gemm
from repro.core import apex_solve as rapex_solve
from repro.core import select_pivots as rselect
from repro.core import two_sided as rtwo_sided
from repro.data import colors_like
from repro.metrics import get_metric as rget
from repro_torch.core import (
    NSimplexProjector,
    apex_addition,
    apex_addition_np,
    apex_gemm,
    apex_solve,
    base_lower_triangular,
    select_pivots,
    simplex_build_np,
    two_sided,
)
from repro_torch.metrics import get_metric

torch.set_num_threads(1)

XPKG = dict(rtol=1e-10, atol=1e-10)


def _euclid_D(P):
    diff = P[:, None, :] - P[None, :, :]
    return np.sqrt((diff**2).sum(-1))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _apex_close(got, want, tol=1e-10):
    np.testing.assert_allclose(got[..., :-1], want[..., :-1], rtol=tol, atol=tol)
    np.testing.assert_allclose(got[..., -1] ** 2, want[..., -1] ** 2, rtol=tol, atol=tol)


def _proj(pivots, name="euclidean", mode="gemm"):
    return NSimplexProjector(pivots, get_metric(name), mode=mode, device="cpu")


class TestSimplexBuild:
    @pytest.mark.parametrize("n_points", [2, 3, 5, 10, 24])
    def test_reconstructs_distances_euclidean(self, n_points, rng):
        P = rng.normal(size=(n_points, 40))
        D = _euclid_D(P)
        sigma = simplex_build_np(D)
        assert sigma.shape == (n_points, n_points - 1)
        np.testing.assert_allclose(_euclid_D(np.pad(sigma, ((0, 0), (0, 1)))), D, atol=1e-8)

    def test_lower_triangular_invariant(self, rng):
        sigma = simplex_build_np(_euclid_D(rng.normal(size=(8, 20))))
        for i in range(8):
            assert np.all(sigma[i, i:] == 0.0)
            if i > 0:
                assert sigma[i, i - 1] >= 0.0

    @pytest.mark.parametrize("metric_name", ["euclidean", "cosine", "jensen_shannon", "triangular"])
    def test_supermetrics_embed(self, metric_name):
        X = colors_like(n=16, seed=3).astype(np.float64)
        D = get_metric(metric_name).pairwise(_t(X)).numpy().copy()
        np.fill_diagonal(D, 0.0)
        sigma = simplex_build_np(D)
        np.testing.assert_allclose(_euclid_D(np.pad(sigma, ((0, 0), (0, 1)))), D, atol=1e-5)


class TestApexEquivalence:
    """Algorithm 2 == the batched loop == the triangular solve == the GEMM,
    in the port and against the JAX package's forms."""

    @pytest.mark.parametrize("n_pivots", [2, 4, 8, 16, 32])
    def test_all_forms_agree(self, n_pivots, rng):
        P = rng.normal(size=(n_pivots, 64))
        x = rng.normal(size=(64,))
        sigma = simplex_build_np(_euclid_D(P))
        dists = np.sqrt(((P - x) ** 2).sum(-1))
        ref = apex_addition_np(sigma, dists)
        L = base_lower_triangular(sigma)
        sq = np.sum(L**2, axis=1)
        loop = apex_addition(_t(sigma), _t(dists)).numpy()
        solve = apex_solve(L, sq, _t(dists[None, :])).numpy()[0]
        gemm = apex_gemm(np.linalg.inv(L), sq, _t(dists[None, :])).numpy()[0]
        np.testing.assert_allclose(loop, ref, atol=1e-8)
        np.testing.assert_allclose(solve, ref, atol=1e-8)
        np.testing.assert_allclose(gemm, ref, atol=1e-7)
        with enable_x64(True):
            np.testing.assert_allclose(loop, np.asarray(rapex_jax(sigma, dists)), **XPKG)
            np.testing.assert_allclose(solve, np.asarray(rapex_solve(L, sq, dists[None, :]))[0], **XPKG)
            np.testing.assert_allclose(gemm, np.asarray(rapex_gemm(np.linalg.inv(L), sq, dists[None, :]))[0],
                                       **XPKG)

    def test_solve_batches_and_takes_a_vector(self, rng):
        P = rng.normal(size=(10, 30))
        X = rng.normal(size=(25, 30))
        sigma = simplex_build_np(_euclid_D(P))
        L = base_lower_triangular(sigma)
        sq = np.sum(L**2, axis=1)
        D = np.sqrt(((X[:, None, :] - P[None]) ** 2).sum(-1))
        got = apex_solve(L, sq, _t(D)).numpy()
        want = np.stack([apex_addition_np(sigma, d) for d in D])
        np.testing.assert_allclose(got, want, atol=1e-8)
        np.testing.assert_allclose(apex_solve(L, sq, _t(D[3])).numpy()[0], want[3], atol=1e-8)

    def test_f32_gemm_close_to_f64_oracle(self, rng):
        P = rng.normal(size=(16, 64))
        x = rng.normal(size=(64,))
        sigma = simplex_build_np(_euclid_D(P))
        dists = np.sqrt(((P - x) ** 2).sum(-1))
        ref = apex_addition_np(sigma, dists)
        L = base_lower_triangular(sigma)
        got = apex_gemm(np.linalg.inv(L).astype(np.float32), np.sum(L**2, axis=1).astype(np.float32),
                        _t(dists[None, :].astype(np.float32))).numpy()[0]
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)

    def test_apex_satisfies_distance_equations(self, rng):
        P = rng.normal(size=(12, 30))
        x = rng.normal(size=(30,))
        sigma = simplex_build_np(_euclid_D(P))
        dists = np.sqrt(((P - x) ** 2).sum(-1))
        apex = apex_addition(_t(sigma), _t(dists)).numpy()
        V = np.pad(sigma, ((0, 0), (0, 1)))
        np.testing.assert_allclose(np.sqrt(((V - apex) ** 2).sum(-1)), dists, atol=1e-8)
        assert apex[-1] >= 0.0


class TestBounds:
    @pytest.mark.parametrize("metric_name", ["euclidean", "cosine", "jensen_shannon"])
    @pytest.mark.parametrize("n_pivots", [4, 10, 20])
    def test_lower_le_true_le_upper(self, metric_name, n_pivots):
        X = colors_like(n=300, seed=11).astype(np.float64)
        m = get_metric(metric_name)
        proj = _proj(select_pivots(X, n_pivots, seed=5), metric_name)
        A, B = _t(X[n_pivots:n_pivots + 100]), _t(X[n_pivots + 100:n_pivots + 200])
        lwb, upb = two_sided(proj(A), proj(B))
        true = m.dist(A, B)
        assert torch.all(lwb <= true + 1e-7), float((lwb - true).max())
        assert torch.all(upb >= true - 1e-7), float((true - upb).max())
        with enable_x64(True):
            r = RProjector(pivots=rselect(X, n_pivots, seed=5), metric=rget(metric_name), dtype=np.float64)
            rl, ru = rtwo_sided(np.asarray(r(X[n_pivots:n_pivots + 100])),
                                np.asarray(r(X[n_pivots + 100:n_pivots + 200])))
        np.testing.assert_allclose(lwb.numpy(), np.asarray(rl), rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(upb.numpy(), np.asarray(ru), rtol=1e-8, atol=1e-8)

    @pytest.mark.parametrize("n_max", [22, pytest.param(30, marks=pytest.mark.slow)])
    def test_monotone_convergence_lemma2(self, n_max):
        """lwb non-decreasing and upb non-increasing in the number of pivots,
        over ``truncated`` projectors."""
        X = colors_like(n=400, seed=21).astype(np.float64)
        proj = _proj(select_pivots(X, n_max, seed=9))
        A, B = _t(X[50:80]), _t(X[100:130])
        prev_l = torch.zeros(30, dtype=torch.float64)
        prev_u = torch.full((30,), np.inf, dtype=torch.float64)
        for mdim in range(2, n_max + 1, 4):
            sub = proj.truncated(mdim)
            assert sub.out_dim == mdim and sub.mode == proj.mode
            lwb, upb = two_sided(sub(A), sub(B))
            assert torch.all(lwb >= prev_l - 1e-7)
            assert torch.all(upb <= prev_u + 1e-7)
            prev_l, prev_u = lwb, upb

    def test_bounds_tighten_to_truth(self):
        X = colors_like(n=500, seed=31).astype(np.float64)
        m = get_metric("euclidean")
        proj = _proj(select_pivots(X, 40, seed=2))
        A, B = _t(X[60:110]), _t(X[120:170])
        lwb, upb = two_sided(proj(A), proj(B))
        true = m.dist(A, B)
        rel = (upb - lwb) / torch.clamp_min(true, 1e-9)
        assert float(torch.median(rel)) < 0.15


class TestProjectorModes:
    @pytest.mark.parametrize("metric_name", ["euclidean", "jensen_shannon"])
    def test_modes_identical_and_equal_the_reference(self, metric_name):
        X = colors_like(n=200, seed=1).astype(np.float64)
        pv = select_pivots(X, 12, seed=0)
        outs = {mode: _proj(pv, metric_name, mode)(_t(X[20:60])).numpy() for mode in ("paper", "solve", "gemm")}
        np.testing.assert_allclose(outs["solve"], outs["paper"], atol=1e-8)
        np.testing.assert_allclose(outs["gemm"], outs["paper"], atol=1e-7)
        with enable_x64(True):
            for mode, got in outs.items():
                r = RProjector(pivots=pv, metric=rget(metric_name), dtype=np.float64, mode=mode)
                _apex_close(got, np.asarray(r(X[20:60])))

    @pytest.mark.parametrize("mode", ["paper", "solve", "gemm"])
    def test_truncated_keeps_the_mode_and_slices(self, mode):
        X = colors_like(n=120, seed=2).astype(np.float64)
        proj = _proj(select_pivots(X, 10, seed=3), mode=mode)
        assert proj.out_dim == 10
        sub = proj.truncated(6)
        assert sub.mode == mode and sub.out_dim == 6 and sub.n_pivots == 6
        np.testing.assert_array_equal(sub.pivots, proj.pivots[:6])
        fresh = _proj(proj.pivots[:6], mode=mode)
        np.testing.assert_allclose(sub(_t(X[30:50])).numpy(), fresh(_t(X[30:50])).numpy(), atol=1e-9)

    @pytest.mark.parametrize("mode", ["paper", "solve", "gemm"])
    def test_one_vector_projects_as_a_row(self, mode):
        X = colors_like(n=60, seed=4).astype(np.float64)
        proj = _proj(select_pivots(X, 8, seed=1), mode=mode)
        d = proj.pivot_distances(_t(X[40:45]))
        block = proj.project_distances(d)
        one = proj.project_distances(d[2])
        assert one.shape == (8,)
        np.testing.assert_allclose(one.numpy(), block[2].numpy(), atol=1e-12)

    def test_unknown_mode_rejected(self):
        X = colors_like(n=40, seed=5).astype(np.float64)
        with pytest.raises(ValueError, match="unknown mode"):
            _proj(select_pivots(X, 4, seed=0), mode="fast")

    def test_degenerate_pivots_rejected(self):
        P = np.repeat(np.ones((1, 16), dtype=np.float64), 4, axis=0)
        with pytest.raises(ValueError):
            _proj(P)
