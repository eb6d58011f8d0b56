"""The port's metrics, simplex construction and projector against the JAX
package's, on the CPU.

The reference measures the inter-pivot distances of its projector fit with
its jnp ``cross``, which runs in float32 unless jax's 64-bit mode is on; the
port fits in float64.  So the reference side runs under ``enable_x64`` where
a fit is compared, and float64 results are held at 1e-12.
"""

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import simplex as rsx
from repro.core.surrogate import NSimplexProjector as RProjector
from repro.core.surrogate import select_pivots as rselect
from repro.core.surrogate import truncate_apexes_np as rtrunc
from repro.data import colors_like
from repro.metrics import get_metric as rget
from repro_torch.core import NSimplexProjector, select_pivots, simplex as tsx, truncate_apexes_np
from repro_torch.metrics import get_metric, metric_from_config, metric_to_config

# small shapes: one intra-op thread keeps these tests from crowding the
# other pytest workers
torch.set_num_threads(1)

F64 = dict(rtol=1e-12, atol=1e-12)
METRICS = ["euclidean", "cosine", "jensen_shannon", "triangular"]


@pytest.fixture(scope="module")
def hist():
    X = colors_like(n=260, seed=3).astype(np.float64)
    return X[:200], X[200:]


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name", METRICS)
def test_cross_and_one_to_many_f64(name, hist):
    X, Y = hist
    m, r = get_metric(name), rget(name)
    np.testing.assert_allclose(m.cross(_t(Y), _t(X)).numpy(), r.cross_np(Y, X), **F64)
    for q in Y[:5]:
        got = m.one_to_many(_t(q), _t(X)).numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, r.one_to_many_np(q, X), **F64)


@pytest.mark.parametrize("name", ["cosine", "jensen_shannon", "triangular"])
def test_one_to_many_upcasts_f32(name, hist):
    X, Y = hist[0].astype(np.float32), hist[1].astype(np.float32)
    got = get_metric(name).one_to_many(_t(Y[0]), _t(X)).numpy()
    want = rget(name).one_to_many_np(Y[0], X)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, **F64)


def test_euclidean_one_to_many_keeps_f32(hist):
    """The reference refines a float32 corpus in float32 under Euclidean."""
    X, Y = hist[0].astype(np.float32), hist[1].astype(np.float32)
    got = get_metric("euclidean").one_to_many(_t(Y[0]), _t(X)).numpy()
    want = rget("euclidean").one_to_many_np(Y[0], X)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_euclidean_cross_repairs_near_coincident_pairs():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(6, 30)) * 1e4
    Y = X + 1e-7 * rng.normal(size=X.shape)
    got = get_metric("euclidean").cross(_t(X), _t(Y)).numpy()
    want = rget("euclidean").cross_np(X, Y)
    np.testing.assert_allclose(np.diag(got), np.linalg.norm(X - Y, axis=1), rtol=1e-9)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_quadratic_form_and_config_roundtrip(hist):
    X, Y = hist
    m = get_metric("quadratic_form", dim=X.shape[1], seed=4)
    with enable_x64(True):
        r = rget("quadratic_form", dim=X.shape[1], seed=4)
        want = np.asarray(r.one_to_many(Y[0], X))
    np.testing.assert_allclose(m.one_to_many(_t(Y[0]), _t(X)).numpy(), want, **F64)
    cfg = metric_to_config(m)
    back = metric_from_config({"name": cfg["name"]}, cfg["arrays"])
    np.testing.assert_array_equal(back.W, m.W)
    with pytest.raises(ValueError):
        get_metric("quadratic_form")
    with pytest.raises(KeyError):
        get_metric("no_such_metric")


def test_simplex_build_and_apex_addition():
    rng = np.random.default_rng(1)
    P = rng.normal(size=(7, 5))
    D = np.linalg.norm(P[:, None] - P[None], axis=-1)
    sigma = tsx.simplex_build_np(D)
    np.testing.assert_allclose(sigma, rsx.simplex_build_np(D), **F64)
    apex = tsx.apex_addition_np(sigma[:6, :5], D[6, :6])
    np.testing.assert_allclose(apex, rsx.apex_addition_np(sigma[:6, :5], D[6, :6]), **F64)


@pytest.mark.parametrize("name", ["euclidean", "jensen_shannon", "cosine"])
def test_projector_matches_reference(name, hist):
    X, Y = hist
    P = select_pivots(X, 12, seed=5)
    proj = NSimplexProjector(P, get_metric(name), device="cpu")
    with enable_x64(True):
        rproj = RProjector(pivots=P, metric=rget(name), dtype=np.float64)
    for attr in ("sigma", "Linv", "sq_norms"):
        np.testing.assert_allclose(getattr(proj, attr), getattr(rproj, attr), **F64)
    qd = rget(name).cross_np(Y, P)
    got = proj.project_distances(_t(qd)).numpy()
    np.testing.assert_allclose(got, rsx.apex_gemm_np(rproj.Linv, rproj.sq_norms, qd), **F64)
    np.testing.assert_allclose(got, tsx.apex_gemm_np(proj.Linv, proj.sq_norms, qd), **F64)
    np.testing.assert_allclose(proj.project_distances(_t(qd[0])).numpy(), got[0], **F64)
    sub = proj.truncate(5)
    np.testing.assert_allclose(
        sub.project_distances(_t(qd[:, :5])).numpy(), rtrunc(got, 5), rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(truncate_apexes_np(got, 5), rtrunc(got, 5), **F64)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("strategy", ["random", "pca"])
def test_select_pivots_draws_the_same_rows(seed, strategy, hist):
    X = hist[0]
    np.testing.assert_array_equal(
        select_pivots(X, 9, strategy=strategy, seed=seed),
        rselect(X, 9, strategy=strategy, seed=seed),
    )


def test_degenerate_pivots_raise():
    """The same ValueError as the reference on a duplicated pivot pair."""
    base = colors_like(n=80, seed=11)
    data = np.concatenate([base, base, base[:40]])
    P = select_pivots(data, 6, seed=1)           # rows 188 and 28: copies
    with pytest.raises(ValueError, match="degenerate"):
        NSimplexProjector(P, get_metric("euclidean"), device="cpu")
    with pytest.raises(ValueError, match="degenerate"):
        RProjector(pivots=P, metric=rget("euclidean"), dtype=np.float64)


def test_projector_default_device_raises_without_a_card(hist):
    """Like ``build_index``: the projector runs on the card unless the caller
    asks for the CPU, and raises when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    P = select_pivots(hist[0], 6, seed=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NSimplexProjector(P, get_metric("euclidean"))
    fitted = NSimplexProjector(P, get_metric("euclidean"), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NSimplexProjector.from_fitted(P, fitted.metric, fitted.sigma, fitted.Linv, fitted.sq_norms)
    restored = NSimplexProjector.from_fitted(
        P, fitted.metric, fitted.sigma, fitted.Linv, fitted.sq_norms, device="cpu"
    )
    assert restored.device == torch.device("cpu")
