"""The twin of ``tests/test_npoint.py`` for the port's metrics: the n-point
property per registered metric.  (n+1) points of a supermetric space embed
isometrically in R^n, so the inductive simplex construction must succeed
with finite coordinates and non-negative altitudes and reproduce every
distance; the distances come from ``repro_torch.metrics`` on CPU tensors
and equal the JAX package's host forms (``one_to_many_np``) on the same
points within 1e-12 (the reference under ``enable_x64``: its quadratic
form is a jnp expression).  Negative control: the Chebyshev (L∞) metric is a
metric but not a supermetric, so some quadruple must fail to embed."""

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.metrics import get_metric as rget
from repro_torch.core.simplex import base_lower_triangular, simplex_build_np
from repro_torch.metrics import METRIC_REGISTRY, get_metric

torch.set_num_threads(1)

#: (registry name, kwargs) — every metric the factory can produce
ALL_METRICS = [(name, {}) for name in sorted(set(METRIC_REGISTRY) - {"jsd"})]
ALL_METRICS.append(("quadratic_form", {"dim": 0}))  # dim patched per case

#: tolerance on the isometry check (float64 construction), as the reference's
RTOL = 1e-6
ATOL = 1e-8


def _sample_points(name: str, m: int, dim: int, rng, dtype):
    if name in ("jensen_shannon", "triangular"):
        x = rng.gamma(2.0, size=(m, dim)) + 1e-6
        x /= x.sum(axis=1, keepdims=True)
    else:
        x = rng.normal(size=(m, dim))
    return x.astype(dtype)


def _metric_for(name: str, kwargs: dict, dim: int, seed: int, get=get_metric):
    if name == "quadratic_form":
        return get(name, dim=dim, seed=seed)
    return get(name, **kwargs)


def _pairwise(metric, X) -> np.ndarray:
    """One ``one_to_many`` row per point in float64, symmetrised, zero
    diagonal (the reference test's ``_pairwise``)."""
    Xt = torch.as_tensor(np.asarray(X, dtype=np.float64))
    D = torch.stack([metric.one_to_many(x, Xt) for x in Xt]).numpy()
    D = 0.5 * (D + D.T)
    np.fill_diagonal(D, 0.0)
    return D


def _ref_pairwise(metric, X) -> np.ndarray:
    X = np.asarray(X, dtype=np.float64)
    D = np.stack([metric.one_to_many_np(x, X) for x in X])
    D = 0.5 * (D + D.T)
    np.fill_diagonal(D, 0.0)
    return D


def _embedded_pairwise(sigma: np.ndarray) -> np.ndarray:
    diff = sigma[:, None, :] - sigma[None, :, :]
    return np.sqrt(np.sum(diff**2, axis=-1))


class TestNPointProperty:
    @pytest.mark.parametrize("name,kwargs", ALL_METRICS, ids=[n for n, _ in ALL_METRICS])
    @pytest.mark.parametrize("m,dim", [(3, 6), (4, 6), (6, 6), (4, 16), (8, 16), (12, 16)])
    def test_simplex_construction_succeeds(self, name, kwargs, m, dim):
        rng = np.random.default_rng(hash((name, m, dim)) % 2**32)
        metric = _metric_for(name, kwargs, dim, seed=m)
        for trial in range(5):
            X = _sample_points(name, m, dim, rng, np.float64)
            D = _pairwise(metric, X)
            with enable_x64(True):
                want = _ref_pairwise(_metric_for(name, kwargs, dim, seed=m, get=rget), X)
            np.testing.assert_allclose(D, want, rtol=1e-12, atol=1e-12)
            sigma = simplex_build_np(D)
            assert np.isfinite(sigma).all(), (name, m, dim, trial)
            assert sigma.shape == (m, m - 1)
            assert (np.diag(base_lower_triangular(sigma)) >= 0.0).all()
            np.testing.assert_allclose(
                _embedded_pairwise(sigma), D, rtol=RTOL, atol=ATOL,
                err_msg=f"{name} (m={m}, dim={dim}, trial={trial}) not isometric",
            )

    @pytest.mark.parametrize("name,kwargs", ALL_METRICS, ids=[n for n, _ in ALL_METRICS])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_dtype_robustness(self, name, kwargs, dtype):
        """float32 inputs still construct (float64 internally)."""
        rng = np.random.default_rng(7)
        dim, m = 10, 6
        metric = _metric_for(name, kwargs, dim, seed=1)
        X = _sample_points(name, m, dim, rng, dtype)
        D = _pairwise(metric, X)
        sigma = simplex_build_np(D)
        assert np.isfinite(sigma).all()
        tol = 1e-3 if dtype == np.float32 else RTOL
        np.testing.assert_allclose(_embedded_pairwise(sigma), D, rtol=tol, atol=tol)


class _ChebyshevMetric:
    """L∞ — a metric WITHOUT the four-point property (negative control)."""

    name = "chebyshev"

    def one_to_many(self, q, X):
        return (X - q[None, :]).abs().amax(dim=1)


class TestFourPointNegativeControl:
    def test_chebyshev_fails_four_point(self):
        metric = _ChebyshevMetric()
        rng = np.random.default_rng(0)
        failures = 0
        for _ in range(200):
            D = _pairwise(metric, rng.normal(size=(4, 3)))
            try:
                sigma = simplex_build_np(D)
            except ValueError:
                failures += 1
                continue
            if np.max(np.abs(_embedded_pairwise(sigma) - D)) > 1e-3 * np.max(D):
                failures += 1
        assert failures > 0, "every sampled Chebyshev quadruple embedded: the four-point check is vacuous"

    def test_euclidean_quadruples_all_pass(self):
        metric = get_metric("euclidean")
        rng = np.random.default_rng(0)
        for _ in range(50):
            D = _pairwise(metric, rng.normal(size=(4, 3)))
            np.testing.assert_allclose(_embedded_pairwise(simplex_build_np(D)), D, rtol=1e-8, atol=1e-10)
