"""The serving step of the port's CLI and the pieces it uses, on the CPU,
held against the JAX package.

* ``repro_torch.search.distributed.build_serve_step`` against the
  reference's ``build_serve_step`` on its one-device mesh under ``jax.jit``
  (as ``tests/test_models_smoke.py`` runs it): for ``projection`` "gemm" (K4's
  plain version) and "paper" (Algorithm 2) and ``selection`` "topk" (K3's
  plain version) and "sort", the histogram equal and each query's packed
  (id, code) set equal, on grids of 1, 2 and 4 CPU devices; the projected
  query apexes within 1e-5 (f32).  The threshold is checked first to lie
  more than 1e-5 (relative) from every f32 bound.
* ``apex_addition`` against ``apex_addition_jax`` within 1e-5 in f32 and
  ``apex_addition_np`` within 1e-8 in f64, one row and batched.
* ``load_or_generate_colors`` equal to the reference's, generated and read
  from a file.
* The signature check of ``tests/test_sharding.py``: ``selection`` defaults
  to "topk", and the parameters are the reference's.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import NSimplexProjector as RProjector, select_pivots as rselect
from repro.core.simplex import apex_addition_jax, apex_addition_np as rapex_addition_np, simplex_build_np
from repro.data import load_or_generate_colors as rload_colors
from repro.launch.mesh import make_host_mesh
from repro.metrics import get_metric as rmetric
from repro.search import distributed as rdistributed
from repro_torch.core import apex_addition, apex_addition_np
from repro_torch.data import colors_like, load_or_generate_colors
from repro_torch.kernels import apex_project
from repro_torch.search import distributed
from repro_torch.sharding import make_scaleout_mesh

torch.set_num_threads(1)

N_ROWS, N_Q, K = 2048, 16, 64
#: thresholds whose bands lie > 1e-5 (relative) from every f32 bound: at
#: 0.035 no query's candidates overflow the 64 slots, at 0.0465 14 of 16
#: do and two queries have rows accepted on the upper bound alone
THRESHOLDS = (0.035, 0.0465)


@pytest.fixture(scope="module")
def fitted():
    X = colors_like(n=N_ROWS + N_Q, seed=5)
    m = rmetric("euclidean")
    proj = RProjector(pivots=rselect(X[:N_ROWS], 8, seed=1), metric=m, dtype=np.float64)
    table = np.asarray(proj(X[:N_ROWS]), dtype=np.float32)
    qd = np.asarray(m.cross_np(X[N_ROWS:], proj.pivots), dtype=np.float32)
    consts = [np.asarray(a, dtype=np.float32) for a in (proj.Linv, proj.sq_norms, proj.sigma)]
    return table, qd, consts


def _reference(table, qd, consts, projection, selection, T):
    mesh = make_host_mesh(1, 1)
    serve = rdistributed.build_serve_step(mesh, n_pivots=qd.shape[1], max_candidates=K,
                                          projection=projection, selection=selection)
    out = jax.jit(serve)(jnp.asarray(table), *[jnp.asarray(c) for c in consts], jnp.asarray(qd), jnp.float32(T))
    return [np.asarray(o) for o in out]


def _port(table, qd, consts, projection, selection, n_dev, T):
    mesh = make_scaleout_mesh(devices=[torch.device("cpu")] * n_dev)
    serve = distributed.build_serve_step(mesh, n_pivots=qd.shape[1], max_candidates=K,
                                         projection=projection, selection=selection)
    out = serve(torch.from_numpy(table), *[torch.from_numpy(c) for c in consts], torch.from_numpy(qd), T)
    return [o.numpy() for o in out]


def _apexes(qd, consts, projection):
    Linv, sq, sigma = (torch.from_numpy(c) for c in consts)
    q = torch.from_numpy(qd)
    return (apex_project(q, Linv, sq) if projection == "gemm" else apex_addition(sigma, q)).numpy()


def _reference_apexes(qd, consts, projection):
    Linv, sq, sigma = consts
    if projection == "paper":
        return np.asarray(jax.vmap(lambda d: apex_addition_jax(jnp.asarray(sigma), d))(jnp.asarray(qd)))
    d1sq = qd[:, :1] ** 2
    g = 0.5 * (d1sq + sq[None, :] - qd[:, 1:] ** 2)
    w = g @ Linv.T
    alt = np.sqrt(np.maximum(d1sq[:, 0] - np.sum(w * w, axis=-1), 0.0))
    return np.concatenate([w, alt[:, None]], axis=-1)


def _pairs(idx, code, qi):
    return sorted((int(i), int(c)) for i, c in zip(idx[:, qi, :].ravel(), code[:, qi, :].ravel()) if i >= 0)


@pytest.mark.parametrize("projection", ["gemm", "paper"])
def test_projected_apexes_match_reference(fitted, projection):
    _, qd, consts = fitted
    np.testing.assert_allclose(_apexes(qd, consts, projection), _reference_apexes(qd, consts, projection),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("T", THRESHOLDS)
@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("selection", ["topk", "sort"])
@pytest.mark.parametrize("projection", ["gemm", "paper"])
def test_serve_step_equals_reference(fitted, projection, selection, n_dev, T):
    """The reference runs on its one-device mesh: one slice of 64 slots.  The
    port's 1 x 1 grid must pack the same (id, code) sets; on grids of 2 and 4
    positions every position keeps its own 64 smallest lower bounds, so a
    query that fits packs the same set and an overflowing one a superset of
    the reference's (the 64 smallest overall lie among each slice's 64
    smallest)."""
    table, qd, consts = fitted
    # the decisions must not hang on an f32 rounding: no bound near a band
    ap = _apexes(qd, consts, projection)
    head = ((table[None, :, :-1] - ap[:, None, :-1]) ** 2).sum(-1)
    for sign in (-1.0, 1.0):
        b = np.sqrt(head + (table[None, :, -1] + sign * ap[:, None, -1]) ** 2)
        for band in (T * (1 + 1e-5) + 1e-9, T * (1 - 1e-5) - 1e-9):
            assert not np.any(np.abs(b - band) <= 1e-5 * band), "a bound lies within 1e-5 of a band: pick another T"
    hist, idx, code = _port(table, qd, consts, projection, selection, n_dev, T)
    rhist, ridx, rcode = _reference(table, qd, consts, projection, selection, T)
    assert hist.shape == (N_Q, 3) and idx.shape == (n_dev, N_Q, K) and code.shape == idx.shape
    np.testing.assert_array_equal(hist, rhist)
    assert (hist[:, 1] + hist[:, 2] > 0).all()
    for qi in range(N_Q):
        got, want = _pairs(idx, code, qi), _pairs(ridx, rcode, qi)
        if n_dev == 1 or hist[qi, 1] + hist[qi, 2] <= K:
            assert got == want, qi
        else:
            assert set(want) <= set(got) and K <= len(got) <= n_dev * K, qi


def test_serve_step_checks_its_inputs(fitted):
    table, qd, consts = fitted
    mesh = make_scaleout_mesh(devices=[torch.device("cpu")])
    with pytest.raises(ValueError, match="projection"):
        distributed.build_serve_step(mesh, n_pivots=8, projection="solve")
    serve = distributed.build_serve_step(mesh, n_pivots=9)
    with pytest.raises(ValueError, match="pivot distances"):
        serve(torch.from_numpy(table), *[torch.from_numpy(c) for c in consts], torch.from_numpy(qd), THRESHOLDS[0])


def test_signatures_match_reference():
    for name in ("build_distributed_filter", "build_serve_step"):
        fn, rfn = getattr(distributed, name), getattr(rdistributed, name)
        assert inspect.signature(fn).parameters["selection"].default == "topk"
        assert list(inspect.signature(fn).parameters) == list(inspect.signature(rfn).parameters)
        for p, rp in zip(inspect.signature(fn).parameters.values(), inspect.signature(rfn).parameters.values()):
            assert p.default == rp.default, p.name


@pytest.mark.parametrize("n", [2, 5, 12, 20])
def test_apex_addition_equals_reference(n):
    rng = np.random.default_rng(n)
    P = rng.normal(size=(n, 32))
    D = np.sqrt(((P[:, None] - P[None]) ** 2).sum(-1))
    sigma = simplex_build_np(D)
    x = rng.normal(size=(6, 32))
    dists = np.sqrt(((x[:, None] - P[None]) ** 2).sum(-1))
    got32 = apex_addition(torch.tensor(sigma, dtype=torch.float32), torch.tensor(dists, dtype=torch.float32))
    want32 = np.stack([np.asarray(apex_addition_jax(jnp.asarray(sigma, jnp.float32), jnp.asarray(d, jnp.float32)))
                       for d in dists])
    np.testing.assert_allclose(got32.numpy(), want32, rtol=0, atol=1e-5)
    got64 = apex_addition(torch.tensor(sigma), torch.tensor(dists))
    with enable_x64(True):
        lax64 = np.stack([np.asarray(apex_addition_jax(sigma, d)) for d in dists])
    np.testing.assert_allclose(got64.numpy(), lax64, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got64.numpy(), np.stack([rapex_addition_np(sigma, d) for d in dists]), atol=1e-8)
    one = apex_addition(torch.tensor(sigma), torch.tensor(dists[0]))
    assert one.shape == (n,)
    np.testing.assert_allclose(one.numpy(), apex_addition_np(sigma, dists[0]), atol=1e-8)


def test_apex_addition_checks_shapes():
    sigma = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="base simplex"):
        apex_addition(torch.zeros((4, 4)), torch.zeros(4))
    with pytest.raises(ValueError, match="distances"):
        apex_addition(sigma, torch.zeros(3))


@pytest.mark.parametrize("kw", [dict(n=500, seed=99), dict(n=64, seed=4242), dict(n=300, dim=16, seed=1)])
def test_load_or_generate_colors_equals_reference(kw):
    np.testing.assert_array_equal(load_or_generate_colors(**kw), rload_colors(**kw))


def test_load_or_generate_colors_reads_a_file(tmp_path):
    rows = colors_like(n=20, seed=3)
    path = tmp_path / "colors.ascii"
    np.savetxt(path, rows)
    got = load_or_generate_colors(str(path), n=5)
    np.testing.assert_array_equal(got, rload_colors(str(path), n=5))
    assert got.shape == (20, 112)
