"""The port's distortion measurement (``repro_torch.core.distortion``) and
Fig. 2 baselines (``repro_torch.baselines``) against the JAX package's, on
the CPU, on the same numpy inputs (float64; the reference under
``enable_x64``, without which its ``pair_distances`` runs in float32).

* ``distortion_from_ratios`` and ``measure_distortion``: the same D within
  1e-9 relative, the same sampled pairs, true distances within 1e-12 and
  apex distances within 1e-9 relative and 1e-8 absolute (a row at a pivot
  has an altitude that is the sqrt of ~1e-16 of rounding, ~1e-8);
* JL's matrix bit-equal (the same generator calls);
* PCA and LMDS through their projected pairwise distances (SVD and
  eigenvector signs are free) within 1e-9 of the largest."""

import numpy as np
import pytest
import torch

from repro.baselines import LandmarkMDS as RLMDS
from repro.baselines import jl_project as rjl
from repro.baselines import pca_project as rpca
from repro.compat import enable_x64
from repro.core import NSimplexProjector as RProjector
from repro.core import select_pivots as rselect
from repro.core.distortion import distortion_from_ratios as rdist_ratios
from repro.core.distortion import measure_distortion as rmeasure
from repro.core.distortion import pair_distances as rpairs
from repro.data import colors_like
from repro.metrics import get_metric as rget
from repro_torch.baselines import LandmarkMDS, jl_project, pca_project
from repro_torch.core import NSimplexProjector, distortion_from_ratios, measure_distortion, select_pivots
from repro_torch.core.distortion import pair_distances, sample_pairs
from repro_torch.metrics import get_metric

torch.set_num_threads(1)

D_RTOL = 1e-9
METRICS = ["euclidean", "cosine", "jensen_shannon", "triangular"]


@pytest.fixture(scope="module")
def X():
    return colors_like(n=600, seed=2024).astype(np.float64)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _pdist(Y):
    Y = np.asarray(Y, dtype=np.float64)
    return np.sqrt(np.maximum(((Y[:, None, :] - Y[None, :, :]) ** 2).sum(-1), 0.0))


def test_distortion_from_ratios_matches():
    rng = np.random.default_rng(3)
    true = rng.uniform(0.0, 2.0, size=500)
    approx = true * rng.uniform(0.5, 1.0, size=500)
    true[:5] = 0.0                           # masked pairs
    approx[5:8] = 1e-13
    want = rdist_ratios(true, approx)
    assert distortion_from_ratios(true, approx) == pytest.approx(want, rel=D_RTOL)
    assert distortion_from_ratios(_t(true), _t(approx)) == pytest.approx(want, rel=D_RTOL)
    assert distortion_from_ratios(np.zeros(3), np.ones(3)) == np.inf


def test_sample_pairs_are_the_reference_draws(X):
    with enable_x64(True):
        _, t_ref, _ = rmeasure(rget("euclidean"), X, lambda A: A, n_pairs=300, seed=7)
    i, j = sample_pairs(len(X), 300, 7)
    assert np.all(i != j)
    np.testing.assert_allclose(np.linalg.norm(X[i] - X[j], axis=1), np.asarray(t_ref), rtol=1e-12)


@pytest.mark.parametrize("name", METRICS)
def test_pair_distances_match(name, X):
    A, B = X[:257], X[300:557]
    got = pair_distances(get_metric(name), _t(A), _t(B), chunk=100)
    assert got.dtype == torch.float64 and got.shape == (257,)
    with enable_x64(True):
        want = rpairs(rget(name), A, B, chunk=100)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["euclidean", "jensen_shannon"])
@pytest.mark.parametrize("k", [5, 12])
def test_nsimplex_distortion_matches(name, k, X):
    pv = select_pivots(X, k, seed=3)
    proj = NSimplexProjector(pv, get_metric(name), device="cpu")
    D, true_d, approx_d = measure_distortion(get_metric(name), X, proj, n_pairs=2000, seed=1, device="cpu")
    with enable_x64(True):
        rproj = RProjector(pivots=rselect(X, k, seed=3), metric=rget(name), dtype=np.float64)
        D_ref, t_ref, a_ref = rmeasure(rget(name), X, lambda A: np.asarray(rproj(A)), n_pairs=2000, seed=1)
    assert D == pytest.approx(D_ref, rel=D_RTOL)
    np.testing.assert_allclose(true_d.numpy(), t_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(approx_d.numpy(), a_ref, rtol=1e-9, atol=1e-8)
    # the apex distance is a lower bound: every ratio true / apex is >= 1
    keep = approx_d > 1e-12
    assert torch.all(true_d[keep] / approx_d[keep] >= 1.0 - 1e-9)


def test_jl_matrix_bit_equal_and_distortion(X):
    f, rf = jl_project(X.shape[1], 12, seed=5, device="cpu"), rjl(X.shape[1], 12, seed=5)
    eye = np.eye(X.shape[1])
    np.testing.assert_array_equal(f(_t(eye)).numpy(), rf(eye))
    D, _, _ = measure_distortion(get_metric("euclidean"), X, f, n_pairs=2000, seed=2, device="cpu")
    with enable_x64(True):
        D_ref, _, _ = rmeasure(rget("euclidean"), X, rf, n_pairs=2000, seed=2)
    assert D == pytest.approx(D_ref, rel=D_RTOL)


@pytest.mark.parametrize("k", [5, 20])
def test_pca_projected_distances(k, X):
    f = pca_project(_t(X), k, device="cpu")
    rf = rpca(X, k)
    A = X[:120]
    got, want = _pdist(f(_t(A)).numpy()), _pdist(rf(A))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * want.max())
    fit = pca_project(_t(X), k, fit_on=_t(X[:300]), device="cpu")
    want = _pdist(rpca(X, k, fit_on=X[:300])(A))
    np.testing.assert_allclose(_pdist(fit(_t(A)).numpy()), want, rtol=1e-9, atol=1e-9 * want.max())


@pytest.mark.parametrize("name", ["euclidean", "jensen_shannon"])
@pytest.mark.parametrize("k", [5, 10])
def test_lmds_projected_distances(name, k, X):
    landmarks = X[np.random.default_rng(k).choice(len(X), size=3 * k, replace=False)]
    f = LandmarkMDS(_t(landmarks), get_metric(name), k, device="cpu")
    with enable_x64(True):
        rf = RLMDS(landmarks, rget(name), k)
        want = _pdist(rf(X[:100]))
    got = _pdist(f(_t(X[:100])).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * want.max())
    D, _, _ = measure_distortion(get_metric(name), X, f, n_pairs=2000, seed=4, device="cpu")
    with enable_x64(True):
        D_ref, _, _ = rmeasure(rget(name), X, rf, n_pairs=2000, seed=4)
    assert D == pytest.approx(D_ref, rel=1e-8)


def test_entry_points_default_to_the_card(X):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jl_project(4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_distortion(get_metric("euclidean"), X, lambda A: A)
