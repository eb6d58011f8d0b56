"""The twin of ``tests/test_system.py`` for the port, on the CPU: the full
pipeline as a user runs it (generate a supermetric dataset, fit the
projector, build the index, run exact threshold queries) and the paper's
headline behaviours (exactness, cost reduction, a re-indexable surrogate,
distortion below a random projection, the storage win).

The twins of the reference's cases are marked ``slow`` like their
reference.  One fast, unmarked case holds Fig. 2's headline at 600 rows:
n-simplex distortion below JL's at the same dimension budget, in the port
and in the JAX package on the same rows and pairs (the same verdict, and
the same D within 1e-9 relative)."""

import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core import NSimplexProjector as RProjector
from repro.core import measure_distortion as rmeasure
from repro.core import select_pivots as rselect
from repro.data import colors_like
from repro.metrics import get_metric as rget
from repro_torch.baselines import jl_project
from repro_torch.core import NSimplexProjector, measure_distortion, select_pivots
from repro_torch.metrics import get_metric
from repro_torch.search import ExactSearchEngine

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def colors():
    return colors_like(n=3000, seed=2024)


def test_distortion_beats_random_projection_600_rows():
    """Paper Fig. 2 at 600 rows, k = 12, 4,000 pairs."""
    X = colors_like(n=600, seed=2024).astype(np.float64)
    m, k = get_metric("euclidean"), 12
    proj = NSimplexProjector(select_pivots(X, k, seed=3), m, device="cpu")
    D_simplex, _, _ = measure_distortion(m, X, proj, n_pairs=4000, device="cpu")
    D_jl, _, _ = measure_distortion(m, X, jl_project(X.shape[1], k, seed=0, device="cpu"), n_pairs=4000,
                                    device="cpu")
    assert D_simplex < D_jl
    with enable_x64(True):
        rproj = RProjector(pivots=rselect(X, k, seed=3), metric=rget("euclidean"), dtype=np.float64)
        rD_simplex, _, _ = rmeasure(rget("euclidean"), X, lambda A: np.asarray(rproj(A)), n_pairs=4000)
        R = np.random.default_rng(0).normal(size=(X.shape[1], k)) / np.sqrt(k)
        rD_jl, _, _ = rmeasure(rget("euclidean"), X, lambda A: A @ R, n_pairs=4000)
    assert D_simplex == pytest.approx(rD_simplex, rel=1e-9)
    assert D_jl == pytest.approx(rD_jl, rel=1e-9)


@pytest.mark.slow
def test_full_pipeline_euclidean(colors):
    """Build -> query -> exact results with far fewer original-space calls."""
    m = get_metric("euclidean")
    data, queries = colors[:2700], colors[2700:2720]
    eng = ExactSearchEngine(data, m, n_pivots=15, seed=0, device="cpu")
    total_orig, total_n = 0, len(data) * len(queries)
    for q in queries:
        d = m.one_to_many(_t(q), _t(data)).numpy()
        t = float(np.quantile(d, 0.002))
        rep = eng.search("N_seq", q, t)
        assert np.array_equal(rep.results, eng.brute_force(q, t))
        total_orig += rep.original_calls
    assert total_orig < 0.1 * total_n


@pytest.mark.slow
def test_full_pipeline_expensive_metric(colors):
    """JSD search: the same exactness (paper Table 2)."""
    m = get_metric("jensen_shannon")
    data, queries = colors[:2000], colors[2000:2010]
    eng = ExactSearchEngine(data, m, n_pivots=12, seed=1, mechanisms=("N_seq", "tree"), device="cpu")
    for q in queries:
        d = m.one_to_many(_t(q), _t(data)).numpy()
        t = float(np.quantile(d, 0.003))
        rep = eng.search("N_seq", q, t)
        assert np.array_equal(rep.results, eng.brute_force(q, t))


@pytest.mark.slow
def test_surrogate_is_reindexable(colors):
    """A projector fitted ON apex rows (paper §6: the Euclidean metric over
    the table rows has the four-point property)."""
    m = get_metric("euclidean")
    proj = NSimplexProjector(select_pivots(colors[:2000], 10, seed=4), m, device="cpu")
    apexes = proj(_t(colors[:500]))
    proj2 = NSimplexProjector(apexes[:8].numpy(), m, device="cpu")
    twice = proj2(apexes[8:200])
    assert twice.shape == (192, 8)
    assert torch.isfinite(twice).all()


@pytest.mark.slow
def test_distortion_beats_random_projection(colors):
    """Paper Fig. 2 at the reference's 1,500 rows."""
    m = get_metric("euclidean")
    X = colors[:1500].astype(np.float64)
    k = 12
    proj = NSimplexProjector(select_pivots(X, k, seed=3), m, device="cpu")
    D_simplex, _, _ = measure_distortion(m, X, proj, n_pairs=4000, device="cpu")
    D_jl, _, _ = measure_distortion(m, X, jl_project(X.shape[1], k, seed=0, device="cpu"), n_pairs=4000,
                                    device="cpu")
    assert D_simplex < D_jl


@pytest.mark.slow
def test_data_size_reduction(colors):
    """Surrogate rows are n floats against 112: the paper's storage win."""
    m = get_metric("euclidean")
    proj = NSimplexProjector(select_pivots(colors[:1000], 20, seed=5), m, device="cpu")
    apex = proj(_t(colors[:100]))
    assert apex.shape[1] * 4 < colors.shape[1] * 4 * 0.2
