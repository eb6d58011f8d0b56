"""The twin of ``tests/test_metrics.py`` for the port's metrics
(``repro_torch.metrics``), with ``dist`` and ``pairwise``: the metric
axioms, known values, the batched forms against each other and the
four-point property, each also held against the JAX package's value on the
same numpy inputs (float64 under ``enable_x64``, 1e-12; the JAX package's
jnp forms reach ~1e-7 in float32 where the reference test says so).

``dist`` on two (B, d) blocks gives the B row-pair distances without a
(B, B) cross: held to the diagonal of ``cross`` and to the reference's
per-pair ``dist``."""

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.data import colors_like
from repro.metrics import QuadraticFormMetric as RQuadratic
from repro.metrics import get_metric as rget
from repro_torch.core import simplex_build_np
from repro_torch.metrics import QuadraticFormMetric, get_metric

torch.set_num_threads(1)

ALL = ["euclidean", "cosine", "jensen_shannon", "triangular"]
F64 = dict(rtol=1e-12, atol=1e-12)


def _data(n=40, seed=0):
    return colors_like(n=n, seed=seed).astype(np.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name", ALL)
class TestMetricAxioms:
    def test_identity_and_symmetry(self, name):
        m = get_metric(name)
        X = _data(20)
        D = m.pairwise(_t(X)).numpy()
        np.testing.assert_allclose(np.diag(D), 0.0, atol=1e-6)
        np.testing.assert_allclose(D, D.T, atol=1e-6)
        assert np.all(D >= -1e-9)
        with enable_x64(True):
            want = np.asarray(rget(name).pairwise(X))
        np.testing.assert_allclose(D, want, rtol=1e-10, atol=1e-7)

    def test_triangle_inequality(self, name):
        m = get_metric(name)
        X = _data(25, seed=4)
        D = m.pairwise(_t(X)).numpy()
        n = D.shape[0]
        for i in range(0, n, 3):
            for j in range(0, n, 3):
                for k in range(0, n, 3):
                    assert D[i, j] <= D[i, k] + D[k, j] + 1e-7

    def test_one_to_many_matches_cross(self, name):
        m = get_metric(name)
        X = _t(_data(15, seed=2))
        D = m.cross(X, X).numpy()
        np.testing.assert_allclose(m.one_to_many(X[3], X).numpy(), D[3], atol=1e-7)

    def test_dist_rows_match_cross_diagonal(self, name):
        """Row-pair ``dist`` equals the cross's diagonal and the reference's
        per-pair ``dist`` in float64."""
        m = get_metric(name)
        X, Y = _data(30, seed=5), _data(30, seed=6)
        got = m.dist(_t(X), _t(Y))
        assert got.shape == (30,) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.diag(m.cross(_t(X), _t(Y)).numpy()), rtol=1e-9, atol=1e-7)
        r = rget(name)
        with enable_x64(True):
            want = np.array([float(r.dist(x, y)) for x, y in zip(X, Y)])
        np.testing.assert_allclose(got.numpy(), want, **F64)
        # a scalar pair is a 0-d tensor
        one = m.dist(_t(X[0]), _t(Y[0]))
        assert one.ndim == 0 and float(one) == pytest.approx(want[0], rel=1e-12, abs=1e-12)

    def test_four_point_property(self, name):
        """Every quadruple must embed isometrically in l2^3 (supermetric!)."""
        m = get_metric(name)
        X = _data(12, seed=9)
        D = m.pairwise(_t(X)).numpy().copy()
        np.fill_diagonal(D, 0.0)
        for a in range(0, 12, 4):
            quad = [a, a + 1, a + 2, a + 3]
            simplex_build_np(D[np.ix_(quad, quad)])  # raises if not embeddable


class TestKnownValues:
    def test_euclidean_exact(self):
        m = get_metric("euclidean")
        assert float(m.dist(np.array([0.0, 0.0]), np.array([3.0, 4.0]))) == pytest.approx(5.0)

    def test_cosine_orthogonal(self):
        m = get_metric("cosine")
        d = float(m.dist(np.array([1.0, 0.0]), np.array([0.0, 1.0])))
        assert d == pytest.approx(np.sqrt(2.0), rel=1e-6)

    def test_jsd_disjoint_is_one(self):
        m = get_metric("jensen_shannon")
        p = np.array([1.0, 0.0, 0.0, 0.0])
        q = np.array([0.0, 0.0, 0.5, 0.5])
        assert float(m.dist(p, q)) == pytest.approx(1.0, abs=1e-5)

    def test_jsd_scale_invariant(self):
        m = get_metric("jensen_shannon")
        p = np.array([0.2, 0.3, 0.5])
        q = np.array([0.1, 0.6, 0.3])
        assert float(m.dist(p, q)) == pytest.approx(float(m.dist(10 * p, 7 * q)), abs=1e-6)

    def test_triangular_bounds(self):
        m = get_metric("triangular")
        p = np.array([1.0, 0.0])
        q = np.array([0.0, 1.0])
        assert float(m.dist(p, q)) == pytest.approx(1.0, abs=1e-6)

    def test_quadratic_form_identity_is_euclidean(self):
        mq = QuadraticFormMetric(np.eye(6))
        me = get_metric("euclidean")
        x, y = np.random.default_rng(0).normal(size=(2, 6))
        assert float(mq.dist(x, y)) == pytest.approx(float(me.dist(x, y)), rel=1e-6)

    def test_quadratic_form_psd_metric(self):
        m = QuadraticFormMetric.random(8, seed=3)
        X = np.random.default_rng(1).normal(size=(10, 8))
        D = m.pairwise(_t(X)).numpy()
        assert np.all(np.diag(D) < 1e-6)
        assert np.all(D >= -1e-9)
        with enable_x64(True):
            want = np.asarray(RQuadratic.random(8, seed=3).pairwise(X))
        np.testing.assert_allclose(D, want, rtol=1e-10, atol=1e-10)

    def test_quadratic_form_rows(self):
        m = QuadraticFormMetric.random(8, seed=3)
        X, Y = np.random.default_rng(2).normal(size=(2, 12, 8))
        with enable_x64(True):
            r = RQuadratic.random(8, seed=3)
            want = np.array([float(r.dist(x, y)) for x, y in zip(X, Y)])
        np.testing.assert_allclose(m.dist(_t(X), _t(Y)).numpy(), want, **F64)
