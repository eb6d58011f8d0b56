"""``repro_torch.core.bounds`` against the JAX package's ``repro.core.bounds``.

The same apexes, made from a numpy seed, go through both.  Held: every
function within 1e-12 in float64 (the JAX side under ``enable_x64``) and
within 2e-6 relative in float32 (the two packages sum the head in different
orders); ``filter_decisions`` codes equal wherever no bound lies within
1e-5 relative of a band, which each case asserts of its data first; the
decision codes equal to the reference's constants.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import bounds as rb
from repro_torch.core import bounds as tb

torch.set_num_threads(1)

FUNCS = ("two_sided", "lower_bound", "upper_bound", "mean_bound")


def _apexes(shape, seed):
    a = np.random.default_rng(seed).normal(size=shape) * 0.4
    a[..., -1] = np.abs(a[..., -1])
    return a


def _close(got, want, dtype):
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_decision_codes_equal_reference():
    assert (tb.EXCLUDE, tb.RECHECK, tb.ACCEPT) == (rb.EXCLUDE, rb.RECHECK, rb.ACCEPT)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", FUNCS)
@pytest.mark.parametrize("dims", [None, 2, 5, 9])
def test_bound_functions_equal_reference(name, dims, dtype):
    """(Q, 1, n) against (1, N, n): the broadcasting of the reference."""
    x, y = _apexes((6, 1, 9), 1).astype(dtype), _apexes((1, 40, 9), 2).astype(dtype)
    with enable_x64(dtype == np.float64):
        want = getattr(rb, name)(jnp.asarray(x), jnp.asarray(y), dims=dims)
    got = getattr(tb, name)(torch.from_numpy(x), torch.from_numpy(y), dims=dims)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert g.shape == (6, 40)
        _close(_np(g), np.asarray(w), dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("dims", [2, 4, 8])
def test_truncate_apexes_equals_reference(dims, dtype):
    x = _apexes((7, 8), 3).astype(dtype)
    with enable_x64(dtype == np.float64):
        want = np.asarray(rb.truncate_apexes(jnp.asarray(x), dims))
    got = tb.truncate_apexes(torch.from_numpy(x), dims)
    assert got.shape == (7, dims)
    _close(got.numpy(), want, dtype)
    # numpy input is taken as well; the identity fold at full width
    np.testing.assert_array_equal(tb.truncate_apexes(x, dims).numpy(), got.numpy())
    np.testing.assert_array_equal(tb.truncate_apexes(torch.from_numpy(x), 8).numpy(), x)


@pytest.mark.parametrize("dims", [1, 9])
def test_truncate_apexes_rejects_bad_dims(dims):
    with pytest.raises(ValueError, match="dims"):
        tb.truncate_apexes(torch.zeros((2, 8)), dims)
    with pytest.raises(ValueError, match="dims"):
        rb.truncate_apexes(jnp.zeros((2, 8)), dims)


def _separated(lwb, upb, t, eps_rel, eps_abs, rel=1e-5):
    hi, lo = t * (1 + eps_rel) + eps_abs, t * (1 - eps_rel) - eps_abs
    near = [np.abs(b - band) <= rel * np.abs(band) for b in (lwb, upb) for band in (hi, lo)]
    return not np.any(near)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("quantile", [0.02, 0.2, 0.6])
@pytest.mark.parametrize("eps", [(1e-5, 1e-6), (0.0, 0.0)])
def test_filter_decisions_equal_reference(quantile, eps, dtype):
    table = _apexes((300, 7), 4).astype(dtype)
    q = _apexes((7,), 5).astype(dtype)
    lwb, upb = (b.numpy().astype(np.float64) for b in tb.two_sided(torch.from_numpy(q)[None], torch.from_numpy(table)))
    # a threshold between two lower bounds, so no bound sits on a band
    srt = np.sort(np.concatenate([lwb, upb]))
    i = int(quantile * len(srt))
    t = float(0.5 * (srt[i] + srt[i + 1]))
    assert _separated(lwb, upb, t, *eps), "the case's bounds must be separated from the bands"
    with enable_x64(dtype == np.float64):
        want = np.asarray(rb.filter_decisions(jnp.asarray(q), jnp.asarray(table), t,
                                              eps_rel=eps[0], eps_abs=eps[1]))
    got = tb.filter_decisions(torch.from_numpy(q), torch.from_numpy(table), t, eps_rel=eps[0], eps_abs=eps[1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert {tb.EXCLUDE, tb.RECHECK} <= set(got.numpy().tolist()) or quantile < 0.1


def test_lower_not_above_upper_and_mean_between():
    x, y = torch.from_numpy(_apexes((50, 6), 6)), torch.from_numpy(_apexes((50, 6), 7))
    lwb, upb = tb.two_sided(x, y)
    assert bool((lwb <= upb).all())
    mid = tb.mean_bound(x, y)
    assert bool(((lwb <= mid) & (mid <= upb)).all())
    # Lemma 2: lwb non-decreasing, upb non-increasing as dims grows
    prev_l, prev_u = None, None
    for d in range(2, 7):
        lo, up = tb.two_sided(x, y, dims=d)
        if prev_l is not None:
            assert bool((lo >= prev_l - 1e-12).all()) and bool((up <= prev_u + 1e-12).all())
        prev_l, prev_u = lo, up
