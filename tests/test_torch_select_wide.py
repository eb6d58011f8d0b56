"""K2 and K3 over their whole contract, on the CPU, against the JAX package.

The reference's ``apex_bounds_topk`` and ``apex_bounds_threshold`` (Pallas
in interpret mode) work in the table's dtype at any width; so does the
port (its plain versions here, its kernels on the card:
``tests/test_torch_gpu.py``).

* f64 tables (under ``enable_x64``), every key, dims None and 6 with
  full-width and truncated queries, with and without a row mask, on a
  table whose last quarter repeats earlier rows (equal keys leave by id):
  ids equal, bounds within ``tests/test_kernels.py``'s f64 tolerance
  (1e-12), counts equal; K3's thresholds lie halfway between neighbouring
  lwb values, so no decision hangs on a last ulp.
* f32 selections 4,097-5,000 wide at N = 6,000 on a table of small dyadic
  values, whose squared bounds both packages compute exactly (equal keys
  up to the sqrt's last ulp, many ties): ids equal, bounds within
  ``tests/test_kernels.py``'s f32 tolerance (2e-5).
* exact k-NN at k = 300 over N = 6,000 (K3's width min(N, 16k) = 4,800):
  ids, distances (1e-12) and ``QueryStats`` equal to the reference's
  ``knn_batch``, and ``overflow_queries`` counts exactly the queries whose
  count exceeds the width (those the reference sends to its dense route).
* the sharded device filter at ``max_candidates = 5,000`` against the
  reference's ``build_distributed_filter``: histogram equal, the same
  (row, code) slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import enable_x64
from repro.core.surrogate import select_pivots as rselect, truncate_apexes_np
from repro.index.nsimplex_index import NSimplexIndex as RIndex
from repro.kernels import ops as rops
from repro.metrics import get_metric as rget
from repro.search.distributed import build_distributed_filter as rfilter
from repro_torch.index import NSimplexIndex
from repro_torch.kernels import ops, ref
from repro_torch.metrics import get_metric
from repro_torch.search import distributed
from repro_torch.sharding import ShardLayout, make_scaleout_mesh

torch.set_num_threads(1)

F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=2e-5, atol=2e-5)
BLOCKS = dict(block_q=8, block_n=256)
SENTINEL = 2**31 - 1


def _apexes(N, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(N, n)) * 0.3
    a[:, -1] = np.abs(a[:, -1])
    return a.astype(dtype)


@pytest.fixture(scope="module")
def f64_data():
    base = _apexes(600, 12, seed=41)
    table = np.concatenate([base, base[:200:2]])          # rows 600.. repeat rows 0, 2, 4, ...
    queries = _apexes(7, 12, seed=42)
    mask = np.random.default_rng(43).random(table.shape[0]) < 0.7
    return table, queries, mask


def _queries(queries, dims, narrow):
    return truncate_apexes_np(queries, dims) if narrow else queries


def _same_selection(got, want, with_counts=False):
    gids, gl, gu = (np.asarray(x) for x in got[:3])
    wids, wl, wu = (np.asarray(x) for x in want[:3])
    np.testing.assert_array_equal(gids, wids)
    live = gids != SENTINEL
    np.testing.assert_allclose(gl[live], wl[live], **F64)
    np.testing.assert_allclose(gu[live], wu[live], **F64)
    assert np.all(np.isinf(gl[~live])) and np.all(np.isinf(gu[~live]))
    if with_counts:
        np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))


DIMS = [(None, False), (6, False), (6, True)]


@pytest.mark.parametrize("key", ["lwb", "upb", "mid"])
@pytest.mark.parametrize("dims,narrow", DIMS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 37, 700])
def test_f64_topk_equals_the_reference(f64_data, key, dims, narrow, masked, k):
    table, queries, mask = f64_data
    q = _queries(queries, dims, narrow)
    m = mask if masked else None
    got = ops.apex_bounds_topk(torch.as_tensor(table), torch.as_tensor(q), k, key=key, dims=dims, rowmask=m)
    assert got[1].dtype == torch.float64 and got[0].dtype == torch.int32
    with enable_x64(True):
        want = rops.apex_bounds_topk(table, q, k, key=key, dims=dims, rowmask=m, **BLOCKS)
        want = tuple(np.asarray(w) for w in want)
    _same_selection(got, want)
    # and the plain selection over the port's own f64 bound matrices
    L, U = ops.apex_bounds_batch(torch.as_tensor(table), torch.as_tensor(q), dims=dims)
    for g, w in zip(got, ref.topk_from_bounds(L, U, k, key, None if m is None else torch.as_tensor(m))):
        assert torch.equal(g, w)


def _between(lwb, live, ranks):
    """Per query a threshold halfway between the r-th and the next distinct
    live lwb value, r cycling through ``ranks``."""
    out = []
    for q in range(lwb.shape[0]):
        s = np.unique(lwb[q][live])
        r = min(ranks[q % len(ranks)], len(s) - 2)
        out.append(0.5 * (s[r] + s[r + 1]))
    return np.asarray(out)


@pytest.mark.parametrize("dims,narrow", DIMS)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cap", [1, 37, 700])
def test_f64_threshold_equals_the_reference(f64_data, dims, narrow, masked, cap):
    table, queries, mask = f64_data
    q = _queries(queries, dims, narrow)
    m = mask if masked else None
    L, U = (x.numpy() for x in ops.apex_bounds_batch(torch.as_tensor(table), torch.as_tensor(q), dims=dims))
    live = np.ones(table.shape[0], bool) if m is None else m
    t = _between(L, live, [0, 5, 30, 36, 37, 60, 400])
    got = ops.apex_bounds_threshold(torch.as_tensor(table), torch.as_tensor(q), t, cap, dims=dims, rowmask=m)
    assert got[1].dtype == torch.float64
    with enable_x64(True):
        want = tuple(np.asarray(w) for w in rops.apex_bounds_threshold(table, q, t, cap, dims=dims, rowmask=m,
                                                                        **BLOCKS))
    np.testing.assert_array_equal(got[3].numpy(), (live & (L <= t[:, None])).sum(1))
    _same_selection(got, want, with_counts=True)
    assert (got[3].numpy() > cap).any() or cap == 700


def test_f64_thresholds_compare_in_f64(f64_data):
    """A threshold one f64 ulp below an lwb value drops that row; an f32
    compare would keep it."""
    table, queries, _ = f64_data
    L, _ = ops.apex_bounds_batch(torch.as_tensor(table), torch.as_tensor(queries))
    t = torch.nextafter(L[:, 5], torch.zeros(()))
    _, _, _, counts = ops.apex_bounds_threshold(torch.as_tensor(table), torch.as_tensor(queries), t, 50)
    assert torch.equal(counts, (L <= t[:, None]).sum(1).to(torch.int32))
    assert torch.equal(counts, (L < L[:, 5:6]).sum(1).to(torch.int32))


@pytest.fixture(scope="module")
def dyadic():
    """6,000 rows of multiples of 1/8 in [-1, 1] (altitudes in [0, 1]):
    squares and dot products are exact in f32, so the bounds are the
    correctly rounded sqrt of exact values in both packages."""
    rng = np.random.default_rng(51)
    a = rng.integers(-8, 9, size=(6000, 8)) / 8.0
    a[:, -1] = np.abs(a[:, -1])
    a = a.astype(np.float32)
    mask = rng.random(6000) < 0.9
    return a, a[:3] + np.float32(0.125), mask


@pytest.mark.parametrize("key", ["lwb", "upb", "mid"])
@pytest.mark.parametrize("k", [4097, 4500, 5000])
@pytest.mark.parametrize("masked", [False, True])
def test_wide_topk_equals_the_reference(dyadic, key, k, masked):
    table, queries, mask = dyadic
    m = mask if masked else None
    got = ops.apex_bounds_topk(torch.as_tensor(table), torch.as_tensor(queries), k, key=key, rowmask=m)
    want = rops.apex_bounds_topk(table, queries, k, key=key, rowmask=m)
    ids, lwb, upb = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), ids)
    live = ids != SENTINEL
    np.testing.assert_allclose(got[1].numpy()[live], lwb[live], **F32)
    np.testing.assert_allclose(got[2].numpy()[live], upb[live], **F32)
    assert (~live).any() == (masked and k > mask.sum())


@pytest.mark.parametrize("cap", [4097, 4600, 5000])
@pytest.mark.parametrize("masked", [False, True])
def test_wide_threshold_equals_the_reference(dyadic, cap, masked):
    table, queries, mask = dyadic
    m = mask if masked else None
    L, _ = (x.numpy() for x in ops.apex_bounds_batch(torch.as_tensor(table), torch.as_tensor(queries)))
    live = np.ones(6000, bool) if m is None else m
    # counts below the cap, just past it, and far past it
    t = []
    for q, r in zip(range(3), (3000, cap + 50, 5000)):
        srt = np.sort(L[q][live])
        t.append(0.5 * (srt[r] + srt[srt > srt[r]][0]))
    t = np.asarray(t, np.float32)
    got = ops.apex_bounds_threshold(torch.as_tensor(table), torch.as_tensor(queries), t, cap, rowmask=m)
    want = [np.asarray(w) for w in rops.apex_bounds_threshold(table, queries, t, cap, rowmask=m)]
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    live_slot = want[0] != SENTINEL
    np.testing.assert_allclose(got[1].numpy()[live_slot], want[1][live_slot], **F32)
    assert (got[3].numpy() > cap).sum() >= 1 and (got[3].numpy() <= cap).sum() >= 1


def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


@pytest.fixture(scope="module")
def knn300():
    X = np.random.default_rng(61).normal(size=(6000 + 12, 12))
    data, queries = X[:6000], X[6000:]
    pivots = rselect(data, 9, seed=4)           # 4 of the 12 queries overflow the width
    with enable_x64(True):
        ref_k = RIndex(data, pivots, rget("euclidean"), use_kernel=True)
    return NSimplexIndex(data, pivots, get_metric("euclidean"), device="cpu"), ref_k, queries


def test_exact_knn_at_k_300_equals_the_reference(knn300, monkeypatch):
    """Pass B runs K3 at min(N, 16k) = 4,800; only queries whose count
    exceeds it take the dense route, in both packages."""
    port, ref_k, queries = knn300
    dense = []
    one = ref_k._knn_one
    monkeypatch.setattr(ref_k, "_knn_one", lambda *a, **k: (dense.append(1), one(*a, **k))[1])
    want = ref_k.knn_batch(queries, 300)
    before = port.overflow_queries
    got = port.knn_batch(queries, 300)
    assert port.overflow_queries - before == len(dense) and 0 < len(dense) < len(queries)
    for (gi, gd, gs), (wi, wd, ws) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gd, wd, **F64)
        assert _stats(gs) == _stats(ws)


@pytest.mark.parametrize("t", [0.6, 1.6])
def test_sharded_filter_at_5000_slots_equals_the_reference(t):
    """K3 at 5,000 slots over 12,000 rows: at t 0.6 every query's count is
    below the slots, at 1.6 above (the accepted column then comes from
    K1), as the reference's ``lax.top_k``."""
    rng = np.random.default_rng(71)
    table = (rng.normal(size=(12_000, 6)) * 0.3).astype(np.float32)
    table[:, -1] = np.abs(table[:, -1])
    queries = table[:5].copy()
    mesh = jax.make_mesh((1,), ("data",))
    want = [np.asarray(a) for a in rfilter(mesh, max_candidates=5000)(
        jnp.asarray(table), jnp.asarray(queries), jnp.float32(t))]
    grid = make_scaleout_mesh(ShardLayout(), [torch.device("cpu")])
    got = [x.numpy() for x in distributed.build_distributed_filter(grid, max_candidates=5000)(
        torch.from_numpy(table), torch.from_numpy(queries), t)]
    np.testing.assert_array_equal(got[0], want[0])
    counts = got[0][:, 1] + got[0][:, 2]
    assert (counts <= 5000).all() if t < 1 else (counts > 5000).all()
    for q in range(queries.shape[0]):
        a = sorted(zip(got[1][0, q].tolist(), got[2][0, q].tolist()))
        b = sorted(zip(want[1][0, q].tolist(), want[2][0, q].tolist()))
        assert a == b


@pytest.mark.parametrize("key_bytes", [8, 16])
@pytest.mark.parametrize("width", [4097, 8192, 16384, 65536, 1_000_000])
@pytest.mark.parametrize("Q", [1, 19, 64, 1000])
def test_wide_plan_sizes_its_scratch(key_bytes, width, Q):
    """The global-memory plan: G candidate buffers of 512 keys in 64 KiB (16
    f32 keys or 8 f64 keys per block), S row slices under the default rule,
    slots of min(2 wp, slice rows) keys, and queries in chunks whose scratch
    stays within 1 GiB: at Q 64, 132 SMs and width 65,536 one slot per
    slice's rows, not (Q, S, 2 wp)."""
    N = 1_000_000
    G, S, chunk = ops.wide_plan(width, Q, N, 132, key_bytes=key_bytes)
    assert 1 <= G <= min(Q, 64 * 1024 // (512 * key_bytes)) and G <= chunk
    assert 1 <= S <= 64 and 1 <= chunk <= Q
    wp = 1 << (width - 1).bit_length()
    slot = ops._wide_slot(width, N, S)
    assert slot == min(wp + max(wp, 512), -(-N // S))
    per = ops._wide_query_bytes(width, N, S, key_bytes)
    assert per == (S * slot + 2 * width) * key_bytes + (S + -(-S // 8) + 1) * 4
    assert chunk * per <= ops._WIDE_SCRATCH_BYTES or chunk == 1
    assert S * slot <= N + S                           # a slot never outgrows its slice


def test_forced_plans_are_checked_against_the_plan_a_width_takes():
    table = torch.as_tensor(_apexes(5000, 8, seed=3, dtype=np.float32))
    q = table[:4]
    with pytest.raises(ValueError, match="invalid launch plan"):
        ops.apex_bounds_threshold(table, q, np.ones(4), 4097, _plan=(0, 4))      # no first design above 4096
    with pytest.raises(ValueError, match="invalid launch plan"):
        ops.apex_bounds_topk(table.double(), q.double(), 4097, key="lwb", _plan=(9, 4))   # 8 f64 keys a block
    got = ops.apex_bounds_topk(table.double(), q.double(), 4097, key="lwb", _plan=(8, 4))
    assert torch.equal(got[0], ops.apex_bounds_topk(table.double(), q.double(), 4097, key="lwb")[0])
