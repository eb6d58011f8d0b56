"""The twin of ``tests/test_properties.py`` for the port: hypothesis over
generated point clouds, at the reference's settings plus
``derandomize=True`` (the same examples on every run, so the count of
passes cannot move).  Invariants:
  I1. the built simplex preserves all pairwise distances;
  I2. the projected apex (``apex_addition``, on tensors) lies at the
      measured distances from the base vertices;
  I3. lwb <= d <= upb for every pair (the paper's Lemma 2.3);
  I4. lwb is a metric: symmetry, identity, triangle inequality;
  I5. the paper's loop equals the GEMM form (``apex_gemm``).
Each also holds the port against the JAX package on the same cloud
(float64, the reference under ``enable_x64``): I1 bit for bit (the same
numpy code), I2 and I5 within 1e-9 of the scale, I3's apexes within 1e-9
of the scale (the altitude compared squared)."""

import numpy as np
import pytest
import torch

from repro.compat import enable_x64

pytest.importorskip("hypothesis", reason="property tests need hypothesis (dev extra)")
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core import NSimplexProjector as RProjector
from repro.core import apex_addition_np as rapex_np
from repro.core import apex_gemm as rapex_gemm
from repro.core import simplex_build_np as rbuild
from repro.metrics import get_metric as rget
from repro_torch.core import NSimplexProjector, apex_addition, apex_gemm, simplex_build_np, two_sided
from repro_torch.core.simplex import base_lower_triangular
from repro_torch.metrics import get_metric

torch.set_num_threads(1)

SETTINGS = dict(
    max_examples=25,
    deadline=None,
    derandomize=True,
    suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large],
)


@st.composite
def point_cloud(draw, min_points=4, max_points=18, extra_dim_min=2, extra_dim_max=32):
    """A Gaussian cloud in dim >= n_points + 2: general position, so every
    sub-simplex is non-degenerate (pivots << physical dimension)."""
    n = draw(st.integers(min_points, max_points))
    d = n + draw(st.integers(extra_dim_min, extra_dim_max))
    seed = draw(st.integers(0, 2**31 - 1))
    scale = draw(st.sampled_from([0.01, 1.0, 100.0]))
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) * scale


def _euclid_D(P):
    return np.linalg.norm(P[:, None, :] - P[None, :, :], axis=-1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@given(point_cloud())
@settings(**SETTINGS)
def test_I1_simplex_reconstructs_all_distances(X):
    D = _euclid_D(X)
    sigma = simplex_build_np(D)
    np.testing.assert_array_equal(sigma, rbuild(D))
    D2 = _euclid_D(np.pad(sigma, ((0, 0), (0, 1))))
    scale = max(D.max(), 1e-12)
    np.testing.assert_allclose(D2 / scale, D / scale, atol=1e-7)


@given(point_cloud(min_points=5))
@settings(**SETTINGS)
def test_I2_apex_hits_measured_distances(X):
    piv, x = X[:-1], X[-1]
    sigma = simplex_build_np(_euclid_D(piv))
    dists = np.linalg.norm(piv - x, axis=-1)
    apex = apex_addition(_t(sigma), _t(dists)).numpy()
    V = np.pad(sigma, ((0, 0), (0, 1)))
    got = np.linalg.norm(V - apex, axis=-1)
    scale = max(dists.max(), 1e-12)
    np.testing.assert_allclose(got / scale, dists / scale, atol=1e-7)
    want = rapex_np(sigma, dists)
    np.testing.assert_allclose(apex[:-1] / scale, want[:-1] / scale, atol=1e-9)
    np.testing.assert_allclose((apex[-1] / scale) ** 2, (want[-1] / scale) ** 2, atol=1e-9)


@given(point_cloud(min_points=8, max_points=20), st.integers(3, 6))
@settings(**SETTINGS)
def test_I3_bound_sandwich(X, n_pivots):
    piv, rest = X[:n_pivots], X[n_pivots:]
    if len(rest) < 2:
        return
    try:
        proj = NSimplexProjector(piv, get_metric("euclidean"), device="cpu")
    except ValueError:
        return  # degenerate pivots: rejection is the correct behaviour
    if np.linalg.cond(proj.L) > 1e7:
        return  # ill-conditioned base simplex: error amplification expected
    P = proj(_t(rest))
    lwb, upb = two_sided(P[:, None, :], P[None, :, :])
    true = _euclid_D(rest)
    tol = 1e-7 * max(true.max(), 1.0)
    assert np.all(lwb.numpy() <= true + tol)
    assert np.all(upb.numpy() >= true - tol)
    with enable_x64(True):
        want = np.asarray(RProjector(pivots=piv, metric=rget("euclidean"), dtype=np.float64)(rest))
    got = P.numpy()
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got[:, :-1] / scale, want[:, :-1] / scale, atol=1e-9)
    np.testing.assert_allclose((got[:, -1] / scale) ** 2, (want[:, -1] / scale) ** 2, atol=1e-9)


@given(point_cloud(min_points=9, max_points=16))
@settings(**SETTINGS)
def test_I4_lower_bound_is_metric(X):
    piv, rest = X[:5], X[5:]
    try:
        proj = NSimplexProjector(piv, get_metric("euclidean"), device="cpu")
    except ValueError:
        return
    if np.linalg.cond(proj.L) > 1e7:
        return
    D = _euclid_D(proj(_t(rest)).numpy())
    tol = 1e-9 * max(D.max(), 1.0)
    assert np.allclose(np.diag(D), 0.0, atol=tol)
    assert np.allclose(D, D.T, atol=tol)
    n = len(D)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                assert D[i, j] <= D[i, k] + D[k, j] + 1e-7 * max(D.max(), 1.0)


@given(point_cloud(min_points=6, max_points=14))
@settings(**SETTINGS)
def test_I5_paper_loop_equals_gemm(X):
    piv, x = X[:-1], X[-1]
    sigma = simplex_build_np(_euclid_D(piv))
    L = base_lower_triangular(sigma)
    if np.any(np.diag(L) <= 1e-9 * max(np.abs(L).max(), 1e-12)):
        return
    dists = np.linalg.norm(piv - x, axis=-1)
    ref = apex_addition(_t(sigma), _t(dists)).numpy()
    got = apex_gemm(np.linalg.inv(L), np.sum(L**2, 1), _t(dists[None])).numpy()[0]
    scale = max(np.abs(ref).max(), 1e-12)
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-6)
    with enable_x64(True):
        want = np.asarray(rapex_gemm(np.linalg.inv(L), np.sum(L**2, 1), dists[None]))[0]
    np.testing.assert_allclose(got[:-1] / scale, want[:-1] / scale, atol=1e-9)
    np.testing.assert_allclose((got[-1] / scale) ** 2, (want[-1] / scale) ** 2, atol=1e-9)
