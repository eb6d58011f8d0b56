"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; without a CUDA device every test skips (the decision is
taken inside the ``cuda`` fixture, so every pytest worker collects the same
tests).  Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: rtol = atol = 2e-5 in float32, 1e-12 in float64 for K1 and K6
(and K1's two launch plans bit-equal to each other); K2 and K3 must equal a
selection over K1's own matrices exactly, in f32 and f64 and on both sides
of 4,096 (the global-memory plan above it), and at the k-NN overflow
route's widths over 112,682 rows;
K4's plans bit-equal to its first design, and at 3e-4 in float32 (``tests/test_kernels.py::TestApexProject``) and K5 at
1e-4 (``TestJsdPairwise``, here squared, before the final sqrt), both at
1e-12 in float64.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, ops, ref

pytestmark = pytest.mark.gpu

SENTINEL = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


def _apexes(N, n, seed, dtype, device):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(N, n)) * 0.3
    a[:, -1] = np.abs(a[:, -1])
    return torch.tensor(a, dtype=dtype, device=device)


def _close(got, want, dtype):
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [1, 1000, 70_001])
def test_k6_apex_bounds(cuda, dtype, N):
    table, query = _apexes(N, 20, 1, dtype, cuda), _apexes(1, 20, 2, dtype, cuda)[0]
    before = LAUNCHES["apex_bounds"]
    got = ops.apex_bounds(table, query)
    assert LAUNCHES["apex_bounds"] == before + 1
    for g, w in zip(got, ref.apex_bounds_ref(table, query)):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dims", [None, 2, 9])
@pytest.mark.parametrize("pretruncated", [False, True])
def test_k1_apex_bounds_batch(cuda, dtype, dims, pretruncated):
    table, queries = _apexes(50_003, 20, 3, dtype, cuda), _apexes(37, 20, 4, dtype, cuda)
    if pretruncated and dims is not None:
        queries = queries[:, :dims].contiguous()
    got = ops.apex_bounds_batch(table, queries, dims=dims)
    for g, w in zip(got, ref.apex_bounds_batch_ref(table, queries, dims or 20)):
        _close(g, w, dtype)


#: query blocks on both sides of the stream plan's 64-query chunks
K1_Q = [1, 2, 3, 37, 64, 65, 130]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [9, 10, 11, 20])
@pytest.mark.parametrize("N", [1, 127, 50_003])
@pytest.mark.parametrize("Q", K1_Q)
def test_k1_plans(cuda, dtype, n, N, Q):
    """The default plan (the stream plan at every Q: 16-byte row loads at
    n = 20 f32 and n = 10, 20 f64; scalar loads at n = 9, 11 and 10 f32;
    one, two or three 64-query chunks) against the plain version, one launch
    per call, and bit-equal to the stream plan forced and to the tile plan."""
    table, queries = _apexes(N, n, N + n, dtype, cuda), _apexes(Q, n, Q + 1, dtype, cuda)
    before = LAUNCHES["apex_bounds_batch"]
    got = ops.apex_bounds_batch(table, queries)
    assert LAUNCHES["apex_bounds_batch"] == before + 1
    for g, w in zip(got, ref.apex_bounds_batch_ref(table, queries, n)):
        _close(g, w, dtype)
    for plan in ("stream", "tile"):
        for g, w in zip(got, ops.apex_bounds_batch(table, queries, _plan=plan)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,n", [(torch.float64, 96), (torch.float64, 128), (torch.float32, 200)])
@pytest.mark.parametrize("Q", [1, 64, 130])
def test_k1_wide_table(cuda, dtype, n, Q):
    """Tables wide enough that a block's queries take more than the default
    48 KiB of shared memory (64 queries x 98 f64 values and up): both plans
    launch, agree with the plain version and give the same bits."""
    table, queries = _apexes(3001, n, 17, dtype, cuda), _apexes(Q, n, 18, dtype, cuda)
    got = {plan: ops.apex_bounds_batch(table, queries, _plan=plan) for plan in ("stream", "tile")}
    for g, w in zip(got["stream"], ref.apex_bounds_batch_ref(table, queries, n)):
        _close(g, w, dtype)
    for g, w in zip(got["stream"], got["tile"]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [10, 20])
@pytest.mark.parametrize("dims,narrow", [(2, False), (7, False), (7, True), (9, True)])
@pytest.mark.parametrize("Q", [1, 3, 37])
def test_k1_plans_truncated(cuda, dtype, n, dims, narrow, Q):
    """dims truncation under both plans, with full-width queries (the kernel
    folds their tail) and with queries ``dims`` wide."""
    table, queries = _apexes(50_003, n, 13, dtype, cuda), _apexes(Q, n, 14, dtype, cuda)
    if narrow:
        head, alt = ref.split_trunc(queries, dims)
        queries = torch.cat([head, alt[:, None]], dim=1).contiguous()
    got = ops.apex_bounds_batch(table, queries, dims=dims)
    for g, w in zip(got, ref.apex_bounds_batch_ref(table, queries, dims)):
        _close(g, w, dtype)
    for g, w in zip(got, ops.apex_bounds_batch(table, queries, dims=dims, _plan="tile")):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", ["row", "element"])
@pytest.mark.parametrize("Q", [1, 5, 37, 70])
def test_k1_table_with_storage_offset(cuda, dtype, offset, Q):
    """A contiguous table view that starts past its storage's base: one row
    in (16-byte aligned at n = 20) or one element in (not aligned: the stream
    plan takes scalar loads).  Same bits as the tile plan, which stages
    through shared memory."""
    N, n = 20_011, 20
    flat = _apexes(N + 1, n, 15, dtype, cuda).reshape(-1)
    table = flat[n:].view(N, n) if offset == "row" else flat[1:1 + N * n].view(N, n)
    assert table.is_contiguous() and table.storage_offset() > 0
    queries = _apexes(Q, n, 16, dtype, cuda)
    got = ops.apex_bounds_batch(table, queries)
    for g, w in zip(got, ref.apex_bounds_batch_ref(table, queries, n)):
        _close(g, w, dtype)
    for g, w in zip(got, ops.apex_bounds_batch(table, queries, _plan="tile")):
        assert torch.equal(g, w)


def _selection(packed, L, U, width):
    return ref._take(packed, L, U, width)


#: k on both sides of every group-size boundary of ops.topk_plan
K2_WIDTHS = [1, 10, 32, 33, 64, 65, 128, 129, 256, 257, 512, 513, 1024, 1025, 2048, 2049, 4096]


@pytest.fixture(scope="module")
def k2_table():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return _apexes(30_011, 20, 5, torch.float32, "cuda"), _apexes(257, 20, 6, torch.float32, "cuda")


@pytest.mark.parametrize("key", ["lwb", "upb", "mid"])
@pytest.mark.parametrize("k", K2_WIDTHS)
@pytest.mark.parametrize("Q", [1, 19, 64, 257])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dims,narrow", [(None, False), (11, False), (11, True)])
def test_k2_topk_equals_selection_over_k1(cuda, k2_table, key, k, Q, masked, dims, narrow):
    """Bit-equal to a selection over K1's own matrices, with and without a
    rowmask and dims = 11; with dims, the queries are sent full width (the
    kernel folds their tail into the altitude) or ``narrow``, truncated to 11
    wide."""
    table, queries = k2_table[0], k2_table[1][:Q]
    if narrow:
        queries = ref.split_trunc(queries, dims)
        queries = torch.cat([queries[0], queries[1][:, None]], dim=1).contiguous()
    mask = torch.rand(30_011, generator=torch.Generator().manual_seed(7)).lt(0.3).to(cuda) if masked else None
    before = LAUNCHES["apex_topk"]
    ids, lwb, upb = ops.apex_bounds_topk(table, queries, k, key=key, dims=dims, rowmask=mask)
    assert LAUNCHES["apex_topk"] == before + 1
    L, U = ops.apex_bounds_batch(table, queries, dims=dims)
    keys = {"lwb": L, "upb": U}.get(key, 0.5 * (L + U))
    live = torch.ones_like(L, dtype=torch.bool) if mask is None else mask[None].expand_as(L)
    want = _selection(ref.pack_keys(keys, live), L, U, k)
    for g, w in zip((ids, lwb, upb), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [10, 64, 257])
@pytest.mark.parametrize("Q", [19, 64])
def test_k2_duplicate_keys_break_by_id(cuda, k, Q):
    """Every row four times: equal keys leave the group kernel by id."""
    table = _apexes(5003, 12, 11, torch.float32, cuda).repeat_interleave(4, dim=0).contiguous()
    queries = _apexes(Q, 12, 12, torch.float32, cuda)
    ids, lwb, upb = ops.apex_bounds_topk(table, queries, k, key="mid")
    L, U = ops.apex_bounds_batch(table, queries)
    want = _selection(ref.pack_keys(0.5 * (L + U), torch.ones_like(L, dtype=torch.bool)), L, U, k)
    for g, w in zip((ids, lwb, upb), want):
        assert torch.equal(g, w)


#: cap on both sides of powers of two up to 4096: every selection width
#: (next_pow2(cap)) the kernels size their state by; K3's G does not depend
#: on cap (the keys a query keeps live in global memory)
K3_CAPS = [1, 2, 3, 16, 17, 128, 129, 256, 257, 512, 513, 1024, 1025, 2048, 2049, 4096]


def _k3_thresholds(L, cap, seed):
    """One threshold per query, of six kinds in turn: a rank below cap, an
    f32 lwb value itself and one ulp below it (the pre-filter's edge), -1
    (an empty query), +inf (every live row), and a rank above cap
    (overflow)."""
    Q, N = L.shape
    srt = torch.sort(L, dim=1).values
    r = torch.arange(Q, device=L.device)
    below = srt[r, min(N - 1, max(0, cap // 2))]
    at = srt[r, min(N - 1, cap - 1)]
    over = srt[r, min(N - 1, 2 * cap + 100)]
    kinds = [below, at, torch.nextafter(at, torch.full_like(at, -float("inf"))),
             torch.full_like(at, -1.0), torch.full_like(at, float("inf")), over]
    kind = (torch.arange(Q, device=L.device) + seed) % len(kinds)
    return torch.stack(kinds)[kind, r].contiguous()


@pytest.mark.parametrize("cap", K3_CAPS)
@pytest.mark.parametrize("Q", [1, 19, 64, 257])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dims,narrow", [(None, False), (10, False), (11, True)])
def test_k3_threshold_equals_selection_over_k1(cuda, k2_table, cap, Q, masked, dims, narrow):
    """Bit-equal to a selection over K1's own matrices with exact counts, at
    every cap boundary of the plan, with and without a rowmask, with dims
    None, dims 10 with full-width queries and dims 11 with 11-wide queries;
    thresholds of every kind of ``_k3_thresholds``; the plan asserted."""
    table, queries = k2_table[0], k2_table[1][:Q]
    if narrow:
        head, alt = ref.split_trunc(queries, dims)
        queries = torch.cat([head, alt[:, None]], dim=1).contiguous()
    N = table.shape[0]
    G, S = ops.threshold_plan(cap, Q, N, ops._sm_count(0))
    assert (G == 1) == (Q == 1)
    assert G == min(Q, 16) or Q > 16 and G == -(-Q // -(-Q // 16))
    assert G * ops._THR_CAND * 8 <= ops._THR_GROUP_BYTES
    mask = torch.rand(N, generator=torch.Generator().manual_seed(3)).lt(0.6).to(cuda) if masked else None
    L, U = ops.apex_bounds_batch(table, queries, dims=dims)
    thr = _k3_thresholds(L, cap, Q + cap)
    before = LAUNCHES["apex_threshold"]
    ids, lwb, upb, counts = ops.apex_bounds_threshold(table, queries, thr, cap, dims=dims, rowmask=mask)
    assert LAUNCHES["apex_threshold"] == before + 1
    live = torch.ones_like(L, dtype=torch.bool) if mask is None else mask[None].expand_as(L)
    hit = live & (L <= thr[:, None])
    assert torch.equal(counts, hit.sum(dim=1).to(torch.int32))
    assert bool((counts[thr < 0] == 0).all())             # t = -1 passes nothing
    want = _selection(ref.pack_keys(L, hit), L, U, cap)
    for g, w in zip((ids, lwb, upb), want):
        assert torch.equal(g, w)


def test_k3_cases_include_every_threshold_kind(cuda, k2_table):
    """The Q = 19 cases hold empty, full and overflowing queries, and
    thresholds at an lwb value and one ulp below it."""
    table, queries = k2_table[0], k2_table[1][:19]
    L, _ = ops.apex_bounds_batch(table, queries)
    thr = _k3_thresholds(L, 512, 19 + 512)
    _, _, _, counts = ops.apex_bounds_threshold(table, queries, thr, 512)
    assert bool((counts == 0).any()) and bool((counts == table.shape[0]).any())
    assert bool(((counts > 512) & (counts < table.shape[0])).any())
    assert bool((L == thr[:, None]).any(dim=1).sum() >= 3)


@pytest.mark.parametrize("cap", [10, 512, 4096])
@pytest.mark.parametrize("Q", [19, 64])
def test_k3_duplicate_keys_break_by_id(cuda, cap, Q):
    """Every row four times: equal keys leave the grouped scan by id, and
    thresholds set to lwb values count every copy."""
    table = _apexes(5003, 12, 11, torch.float32, cuda).repeat_interleave(4, dim=0).contiguous()
    queries = _apexes(Q, 12, 12, torch.float32, cuda)
    L, U = ops.apex_bounds_batch(table, queries)
    thr = _k3_thresholds(L, cap, 1)
    ids, lwb, upb, counts = ops.apex_bounds_threshold(table, queries, thr, cap)
    hit = L <= thr[:, None]
    assert torch.equal(counts, hit.sum(dim=1).to(torch.int32))
    want = _selection(ref.pack_keys(L, hit), L, U, cap)
    for g, w in zip((ids, lwb, upb), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cap", [10, 512, 4096])
@pytest.mark.parametrize("Q", [8, 64])
@pytest.mark.parametrize("dims", [None, 10])
def test_k3_many_slices_heavy_overflow(cuda, cap, Q, dims):
    """200,003 rows give 25 slices, so the gather runs several blocks per
    query; thresholds at the 10th smallest upb (k-NN pass B) and, for every
    other query, +inf, whose slots all overflow and select, as at 1M rows."""
    table = _apexes(200_003, 20, 21, torch.float32, cuda)
    queries = _apexes(Q, 20, 22, torch.float32, cuda)
    G, S = ops.threshold_plan(cap, Q, table.shape[0], ops._sm_count(0))
    assert S > 8
    L, U = ops.apex_bounds_batch(table, queries, dims=dims)
    thr = torch.kthvalue(U, 10, dim=1).values
    thr[1::2] = float("inf")
    ids, lwb, upb, counts = ops.apex_bounds_threshold(table, queries, thr, cap, dims=dims)
    hit = L <= thr[:, None]
    assert torch.equal(counts, hit.sum(dim=1).to(torch.int32)) and bool((counts[1::2] > cap).all())
    want = _selection(ref.pack_keys(L, hit), L, U, cap)
    for g, w in zip((ids, lwb, upb), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("plan", [(0, 3), (0, 64), (1, 3), (2, 5), (3, 1), (7, 4), (11, 2), (13, 9), (16, 3)])
def test_k3_every_group_size_agrees(cuda, k2_table, plan):
    """Forced plans, the first design (G = 0: one query per block) and
    groups of one included, give the default plan's result, with partial
    last groups (Q = 64 is no multiple of 3, 7, 11 or 13)."""
    table, queries = k2_table[0], k2_table[1][:64]
    L, _ = ops.apex_bounds_batch(table, queries)
    thr = _k3_thresholds(L, 512, 5)
    got = ops.apex_bounds_threshold(table, queries, thr, 512, _plan=plan)
    for g, w in zip(got, ops.apex_bounds_threshold(table, queries, thr, 512)):
        assert torch.equal(g, w)


def test_k3_plan_outside_its_budget_is_refused(cuda, k2_table):
    table, queries = k2_table[0], k2_table[1][:64]
    thr = torch.ones(64, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        ops.apex_bounds_threshold(table, queries, thr, 4096, _plan=(17, 4))


#: selection widths on both sides of MAX_SELECT_WIDTH (the shared-memory
#: plans up to it, the global-memory plan above)
WIDE_WIDTHS = [4096, 4097, 5000, 8192, 8193, 16384]
#: f64 widths at every plan of the f64 key (16 bytes: half the f32 groups)
F64_WIDTHS = [1, 10, 33, 257, 1025, 2049, 4096, 4097, 8193]


@pytest.fixture(scope="module")
def wide_tables():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return {dt: (_apexes(30_011, 20, 5, dt, "cuda"), _apexes(64, 20, 6, dt, "cuda"))
            for dt in (torch.float32, torch.float64)}


def _f64_or_wide_cases():
    return [(torch.float64, w) for w in F64_WIDTHS] + [(torch.float32, w) for w in WIDE_WIDTHS]


@pytest.mark.parametrize("dtype,k", _f64_or_wide_cases())
@pytest.mark.parametrize("key", ["lwb", "upb", "mid"])
@pytest.mark.parametrize("Q", [1, 19, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dims", [None, 11])
def test_k2_f64_and_wide_equal_selection_over_k1(cuda, wide_tables, dtype, k, key, Q, masked, dims):
    """f64 tables at every plan and f32 selections wider than 4096 (the
    global-memory plan): equal to the plain selection over K1's own matrices
    (ids and bounds), with and without a rowmask, dims None and 11."""
    table, queries = wide_tables[dtype][0], wide_tables[dtype][1][:Q]
    mask = torch.rand(30_011, generator=torch.Generator().manual_seed(7)).lt(0.3).to(cuda) if masked else None
    before = LAUNCHES["apex_topk"]
    got = ops.apex_bounds_topk(table, queries, k, key=key, dims=dims, rowmask=mask)
    assert LAUNCHES["apex_topk"] == before + 1
    assert got[1].dtype == dtype and got[2].dtype == dtype
    L, U = ops.apex_bounds_batch(table, queries, dims=dims)
    for g, w in zip(got, ref.topk_from_bounds(L, U, k, key, mask)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,cap", _f64_or_wide_cases())
@pytest.mark.parametrize("Q", [1, 19, 64])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dims", [None, 10])
def test_k3_f64_and_wide_equal_selection_over_k1(cuda, wide_tables, dtype, cap, Q, masked, dims):
    """K3 the same way, with exact counts and thresholds of every kind of
    ``_k3_thresholds`` (in the table's dtype)."""
    table, queries = wide_tables[dtype][0], wide_tables[dtype][1][:Q]
    mask = torch.rand(30_011, generator=torch.Generator().manual_seed(3)).lt(0.6).to(cuda) if masked else None
    L, U = ops.apex_bounds_batch(table, queries, dims=dims)
    thr = _k3_thresholds(L, cap, Q + cap)
    assert thr.dtype == dtype
    before = LAUNCHES["apex_threshold"]
    got = ops.apex_bounds_threshold(table, queries, thr, cap, dims=dims, rowmask=mask)
    assert LAUNCHES["apex_threshold"] == before + 1
    for g, w in zip(got, ref.threshold_from_bounds(L, U, thr, cap, mask)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("plan", [(1, 1), (2, 2), (3, 5), (8, 3)])
@pytest.mark.parametrize("width", [4097, 6000])
def test_wide_plan_compacts_inside_the_scan(cuda, dtype, plan, width):
    """Forced wide plans of few slices over 200,003 rows: each slice has more
    rows than its slot (2 wp keys), so the scan's own select runs, for K2's
    upb key and for K3 at +inf and at a rank past the cap."""
    table = _apexes(200_003, 20, 21, dtype, cuda)
    queries = _apexes(8, 20, 22, dtype, cuda)
    S = plan[1]
    assert -(-200_003 // S) > 2 * (1 << (width - 1).bit_length())
    L, U = ops.apex_bounds_batch(table, queries)
    got = ops.apex_bounds_topk(table, queries, width, key="upb", _plan=plan)
    for g, w in zip(got, ref.topk_from_bounds(L, U, width, "upb")):
        assert torch.equal(g, w)
    thr = torch.sort(L, dim=1).values[:, 3 * width]
    thr[::2] = float("inf")
    got = ops.apex_bounds_threshold(table, queries, thr, width, _plan=plan)
    assert bool((got[3] > width).all())
    for g, w in zip(got, ref.threshold_from_bounds(L, U, thr, width)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_plan_in_query_chunks(cuda, wide_tables, dtype, monkeypatch):
    """A scratch budget of a few queries splits a 64-query call into chunks
    (one count); the result is the one-chunk result."""
    table, queries = wide_tables[dtype]
    L, U = ops.apex_bounds_batch(table, queries)
    thr = _k3_thresholds(L, 5000, 1)
    whole = ops.apex_bounds_topk(table, queries, 5000, key="mid"), ops.apex_bounds_threshold(table, queries, thr, 5000)
    _, S, _ = ops.wide_plan(5000, 64, table.shape[0], ops._sm_count(0), key_bytes=ops._KEY_BYTES[dtype])
    monkeypatch.setattr(ops, "_WIDE_SCRATCH_BYTES", 5 * ops._wide_query_bytes(5000, table.shape[0], S,
                                                                             ops._KEY_BYTES[dtype]))
    assert ops.wide_plan(5000, 64, table.shape[0], ops._sm_count(0), key_bytes=ops._KEY_BYTES[dtype])[2] == 5
    before = dict(LAUNCHES)
    parts = ops.apex_bounds_topk(table, queries, 5000, key="mid"), ops.apex_bounds_threshold(table, queries, thr, 5000)
    assert LAUNCHES["apex_topk"] == before["apex_topk"] + 1
    assert LAUNCHES["apex_threshold"] == before["apex_threshold"] + 1
    for a, b in zip(whole, parts):
        for g, w in zip(a, b):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_selection_duplicate_keys_break_by_id_in_every_plan(cuda, dtype):
    """Every row four times: equal keys leave the f64 and the wide plans by
    id."""
    table = _apexes(5003, 12, 11, dtype, cuda).repeat_interleave(4, dim=0).contiguous()
    queries = _apexes(19, 12, 12, dtype, cuda)
    L, U = ops.apex_bounds_batch(table, queries)
    for k in (10, 257, 4097, 9000):
        for g, w in zip(ops.apex_bounds_topk(table, queries, k, key="mid"), ref.topk_from_bounds(L, U, k, "mid")):
            assert torch.equal(g, w)
        thr = _k3_thresholds(L, k, 1)
        for g, w in zip(ops.apex_bounds_threshold(table, queries, thr, k), ref.threshold_from_bounds(L, U, thr, k)):
            assert torch.equal(g, w)


def _fitted(n, seed, device):
    """(Linv, sq_norms, distances) of a Euclidean projector fitted on the CPU
    and 5000 held-out points: altitudes well away from 0."""
    from repro_torch.core import NSimplexProjector
    from repro_torch.metrics import get_metric

    X = torch.as_tensor(np.random.default_rng(seed).normal(size=(n + 5000, n + 3)))
    proj = NSimplexProjector(X[:n].numpy(), get_metric("euclidean"), device="cpu")
    dists = proj.pivot_distances(X[n:])
    return (torch.as_tensor(proj.Linv, device=device), torch.as_tensor(proj.sq_norms, device=device),
            dists.to(device))


#: K4 widths: the warp and stream plans' templated heads (n - 1 <= 32) at
#: the main path's n = 10, 20 and both edges, and wider n, which only the
#: first design serves
K4_N = [2, 3, 10, 20, 21, 33, 64, 65, 100]
#: K4 row counts: empty, the warp plan's query shapes around warp-size edges,
#: and the stream plan's partial tiles of 128 rows; 300,001 rows give most
#: persistent blocks several tiles, so the ring wraps
K4_B = [0, 1, 2, 31, 32, 33, 63, 64, 65, 1000, 5000, 300_001]


def _k4_plans(n):
    return ("row", "stream", "warp") if n - 1 <= ops._K4_MAX_HEAD else ("row",)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", K4_N)
@pytest.mark.parametrize("B", K4_B)
def test_k4_apex_project(cuda, dtype, n, B):
    """The default plan and every plan K4 serves at n, forced, bit-equal to
    the first design (``"row"``); the default within 3e-4 (f32) or 1e-12
    (f64) of the plain version; one launch per call that has rows (an empty
    call launches nothing)."""
    Linv, sq, dists = (t.to(dtype) for t in _fitted(n, n, cuda))
    dists = dists.repeat(-(-B // dists.shape[0]), 1)[:B]
    before = LAUNCHES["apex_project"]
    got = ops.apex_project(dists, Linv, sq)
    assert LAUNCHES["apex_project"] == before + (B > 0)
    assert got.shape == (B, n) and got.dtype == dtype
    for plan in _k4_plans(n):
        before = LAUNCHES["apex_project"]
        assert torch.equal(ops.apex_project(dists, Linv, sq, _plan=plan), got), plan
        assert LAUNCHES["apex_project"] == before + (B > 0)
    tol = 3e-4 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got, ref.apex_project_ref(dists, Linv, sq), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [10, 20, 65])
@pytest.mark.parametrize("B", [1, 64, 5000])
def test_k4_non_contiguous_distances(cuda, dtype, n, B):
    """A strided view of the distances (every other row, and one row of a
    transposed block) gives the bits of its contiguous copy under every plan."""
    Linv, sq, dists = (t.to(dtype) for t in _fitted(n, n, cuda))
    view = dists.repeat(2, 1)[: 2 * B : 2]
    assert not view.is_contiguous() or B == 1
    want = ops.apex_project(view.contiguous(), Linv, sq, _plan="row")
    for plan in (None,) + _k4_plans(n):
        assert torch.equal(ops.apex_project(view, Linv, sq, _plan=plan), want), plan
    column = dists[:n].T.contiguous().T[:1]          # (1, n) with strides (1, n)
    assert torch.equal(ops.apex_project(column, Linv, sq), ops.apex_project(column.contiguous(), Linv, sq))


def test_k4_plan_and_shape_class(cuda):
    """The wrapper's plan at the main path's shapes and the shape class its
    launch counts under; the templated plans refuse n - 1 > 32."""
    sms = ops._sm_count(0)
    assert [ops.apex_project_plan(B, n, sms) for B, n in ((1, 20), (64, 10), (10**6, 20), (64, 65))] == [
        "warp", "warp", "stream", "row"]
    Linv, sq, dists = _fitted(20, 20, cuda)
    ops.reset_launches()
    ops.apex_project(dists[:64], Linv, sq)
    assert ops.SHAPE_LAUNCHES["apex_project"] == {ops.shape_class("apex_project", B=64, n=20, dtype="float64"): 1}
    Linv, sq, dists = _fitted(34, 34, cuda)
    for plan in ("stream", "warp"):
        with pytest.raises(ValueError, match="launch plan"):
            ops.apex_project(dists[:3], Linv, sq, _plan=plan)
    assert torch.equal(ops.apex_project(dists[:3], Linv, sq), ops.apex_project(dists[:3], Linv, sq, _plan="row"))


@pytest.mark.parametrize("n", [10, 20, 40])
def test_k4_projector_vector_path(cuda, n):
    """A projector on the card projects an (n,) vector through one launch,
    to the bits of the (1, n) call, counted under the (1, n) class."""
    from repro_torch.core import NSimplexProjector
    from repro_torch.metrics import get_metric

    X = np.random.default_rng(n).normal(size=(n + 8, n + 3))
    proj = NSimplexProjector(X[:n], get_metric("euclidean"), device="cuda")
    d = proj.pivot_distances(torch.as_tensor(X[n:], device=cuda))
    ops.reset_launches()
    one = proj.project_distances(d[3])
    assert ops.SHAPE_LAUNCHES["apex_project"] == {(1, n, "float64"): 1}
    assert one.shape == (n,) and torch.equal(one, ops.apex_project(d[3:4], proj._Linv_t, proj._sq_norms_t)[0])
    assert torch.equal(proj.project_distances(d), ops.apex_project(d, proj._Linv_t, proj._sq_norms_t, _plan="row"))


def _histograms(rows, d, seed, dtype, device):
    return torch.tensor(np.random.default_rng(seed).dirichlet(np.full(d, 0.5), size=rows), dtype=dtype,
                        device=device)


#: (Q, P) that ops.jsd_plan serves with the split plan (lanes > 1) at d >= 2,
#: and with the tile plan (one lane per pair, up to 4 pairs per thread)
K5_SPLIT = [(1, 1), (1, 64), (1, 256), (1, 4097), (64, 20), (1000, 20)]
K5_TILE = [(3001, 20), (64, 4096), (1000, 333)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 17, 112, 600])
@pytest.mark.parametrize("Q,P", K5_SPLIT + K5_TILE)
def test_k5_jsd_pairwise(cuda, dtype, d, Q, P):
    """Both launch plans against the plain version, one launch per call: the
    split plan for few pairs, the tile plan for many pairs (multi-chunk
    staging of d, partial tiles) and at d = 1, where a pair has one lane."""
    lanes, _, _ = ops.jsd_plan(Q, P, d, ops._sm_count(0))
    assert (lanes == 1) == (d == 1 or (Q, P) in K5_TILE), lanes
    X, Y = _histograms(Q, d, Q + d, dtype, cuda) * 3.0, _histograms(P, d, P + 1, dtype, cuda)
    before = LAUNCHES["jsd_pairwise"]
    got = ops.jsd_pairwise(X, Y)
    assert LAUNCHES["jsd_pairwise"] == before + 1 and got.shape == (Q, P) and got.dtype == dtype
    Xn, Yn = X / X.sum(dim=1, keepdim=True), Y / Y.sum(dim=1, keepdim=True)
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    # compared squared, before the final sqrt, like chip_smoke.py: where the
    # divergence is 0 up to rounding (d = 1), the sqrt turns ~1e-16 into ~1e-8
    torch.testing.assert_close(got * got, ref.jsd_pairwise_ref(Xn, Yn) ** 2, rtol=tol, atol=tol)


@pytest.mark.parametrize("rows", [8, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_row_against_itself_is_zero(cuda, rows, dtype):
    """Exactly 0 on the diagonal, under the split plan (8 rows: 64 pairs)
    and the tile plan (300 rows: 90,000 pairs)."""
    X = _histograms(rows, 112, 9, dtype, cuda) * 5.0
    assert ops.jsd_plan(rows, rows, 112, ops._sm_count(0))[0] == (32 if rows == 8 else 1)
    assert bool((torch.diagonal(ops.jsd_pairwise(X, X)) == 0).all())
    # the same row reached through another tensor
    assert bool((ops.jsd_pairwise(X[3:4].clone(), X)[0, 3] == 0).all())


def test_k5_wrapper_launches_one_kernel_and_no_tensor_op(cuda):
    """On the card the wrapper allocates its output and launches one kernel:
    no normalisation, cast or copy runs as a PyTorch operation."""
    from torch.profiler import ProfilerActivity, profile

    X = _histograms(1, 112, 1, torch.float64, cuda) * 2.0
    Y = _histograms(256, 112, 2, torch.float64, cuda)
    ops.jsd_pairwise(X, Y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.jsd_pairwise(X, Y)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    aten = {e.name for e in prof.events() if e.name.startswith("aten::")}
    if not kernels:
        pytest.skip("the profiler recorded no device activity on this machine")
    assert len(kernels) == 1 and "jsd" in kernels[0], kernels
    assert aten <= {"aten::empty"}, aten


def _brute_jsd(q, data_t):
    """Plain f64 JSD of one query against every row (not through K5)."""
    q = torch.as_tensor(q, device=data_t.device, dtype=torch.float64)[None, :]
    X = data_t.double()
    return ref.jsd_pairwise_ref(q / q.sum(), X / X.sum(dim=1, keepdim=True))[0]


@pytest.fixture(scope="module")
def jsd_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    from repro_torch.data import colors_like

    X = colors_like(n=60_000 + 16, seed=5).astype(np.float64)
    return X[:60_000], X[60_000:]


def test_index_on_card_matches_brute_force(cuda, jsd_card):
    """k-NN and range through the kernels equal a plain float64 scan on the card."""
    from repro_torch.api import Query, build_index

    data, queries = jsd_card
    index = build_index(data, "jensen_shannon", n_pivots=16, seed=1)
    data_t = index.data
    for q, r in zip(queries, index.query(queries, Query.knn(10))):
        d = _brute_jsd(q, data_t)
        want = torch.sort(d, stable=True).indices[:10].cpu().numpy()
        np.testing.assert_array_equal(r.ids, want)
        np.testing.assert_allclose(r.distances, d[want].cpu().numpy(), rtol=1e-12, atol=1e-12)
    t = 0.5 * float(r.distances[-1] + r.distances[-2])
    for q, r in zip(queries, index.query(queries, Query.range(t))):
        d = _brute_jsd(q, data_t)
        np.testing.assert_array_equal(r.ids, torch.nonzero(d <= t).flatten().cpu().numpy())


@pytest.mark.parametrize("refine", [64, 5000])
def test_approx_knn_on_card_refines_k2_candidates(cuda, jsd_card, refine):
    """Approximate k-NN returns the k smallest (f64 distance, id) among the
    ``refine`` rows with the smallest K1 f32 mid key (the K2 route, and the
    host route for a selection wider than K2 holds)."""
    from repro_torch.api import Query, build_index

    data, queries = jsd_card
    index = build_index(data, "jensen_shannon", n_pivots=16, seed=1, apex_dims=8, refine=refine)
    inner = index._inner
    res = index.query(queries, Query.knn(10))
    apexes = inner.query_apex_batch(queries, dims=8).float()
    for qi, (q, r) in enumerate(zip(queries, res)):
        assert r.approx == {"dims": 8, "refine": refine} and r.stats.original_calls == 8 + refine
        L, U = ops.apex_bounds_batch(inner._kernel_table(), apexes[qi][None, :], dims=8)
        mid = (0.5 * (L + U))[0].cpu().numpy()
        ids = np.arange(mid.shape[0])
        cand = np.lexsort((ids, mid))[:refine]
        d = _brute_jsd(q, index.data).cpu().numpy()
        want = cand[np.lexsort((cand, d[cand]))][:10]
        np.testing.assert_array_equal(r.ids, want)
        np.testing.assert_allclose(r.distances, d[want], rtol=1e-12, atol=1e-12)


#: the row masks that filtered and online queries hand K2 and K3: a thin
#: predicate (0.1% of the rows), fewer allowed rows than the selection
#: width, and none allowed
MASK_CASES = ["thin", "fewer_than_width", "none_allowed"]


def _mask_case(case, N, width, device):
    allowed = torch.zeros(N, dtype=torch.bool)
    g = torch.Generator().manual_seed(11)
    if case == "thin":
        allowed = torch.rand(N, generator=g) < 1e-3
    elif case == "fewer_than_width":
        allowed[torch.randperm(N, generator=g)[: max(width // 2, 1)]] = True
    return allowed.to(torch.uint8).to(device)


@pytest.mark.parametrize("case", MASK_CASES)
@pytest.mark.parametrize("key", ["upb", "mid"])
@pytest.mark.parametrize("k", [10, 64])
@pytest.mark.parametrize("Q", [1, 64])
def test_k2_pushdown_masks_equal_plain(cuda, k2_table, case, key, k, Q):
    """K2 under the masks of filtered queries equals the plain selection
    (``ref``'s packed-key top-k) over K1's own f32 matrices bit for bit; a
    short selection pads with the sentinel id and +inf bounds (the indexes
    drop those slots); the launch counts in the masked class."""
    table, queries = k2_table[0], k2_table[1][:Q]
    N = table.shape[0]
    mask = _mask_case(case, N, k, cuda)
    ops.reset_launches()
    got = ops.apex_bounds_topk(table, queries, k, key=key, rowmask=mask)
    assert ops.SHAPE_LAUNCHES["apex_topk"] == {(Q, k, key, 20, "masked"): 1}
    L, U = ops.apex_bounds_batch(table, queries)
    keys = {"lwb": L, "upb": U}.get(key, 0.5 * (L + U))
    want = _selection(ref.pack_keys(keys, mask.bool()[None].expand_as(L)), L, U, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    n_allowed = int(mask.sum())
    real = got[0] != SENTINEL
    assert bool((real.sum(dim=1) == min(k, n_allowed)).all())
    assert bool(torch.isinf(got[1][~real]).all()) and bool(torch.isinf(got[2][~real]).all())
    assert bool(mask[got[0][real].long()].bool().all())


@pytest.mark.parametrize("case", MASK_CASES)
@pytest.mark.parametrize("cap", [512, 4096])
@pytest.mark.parametrize("Q", [1, 64])
def test_k3_pushdown_masks_equal_plain(cuda, k2_table, case, cap, Q):
    """K3 under the masks of filtered queries equals the plain selection
    over K1's own f32 matrices bit for bit with exact counts, at a
    threshold every allowed row passes and at one that passes about a tenth
    of the rows."""
    table, queries = k2_table[0], k2_table[1][:Q]
    N = table.shape[0]
    mask = _mask_case(case, N, cap, cuda)
    L, U = ops.apex_bounds_batch(table, queries)
    for thr in (torch.full((Q,), float("inf"), device=cuda),
                torch.kthvalue(L, N // 10, dim=1).values.contiguous()):
        ops.reset_launches()
        got = ops.apex_bounds_threshold(table, queries, thr, cap, rowmask=mask)
        assert ops.SHAPE_LAUNCHES["apex_threshold"] == {(Q, cap, 20, "masked"): 1}
        hit = mask.bool()[None].expand_as(L) & (L <= thr[:, None])
        assert torch.equal(got[3], hit.sum(dim=1).to(torch.int32))
        for g, w in zip(got[:3], _selection(ref.pack_keys(L, hit), L, U, cap)):
            assert torch.equal(g, w)
        assert bool((got[3] <= int(mask.sum())).all())


def _apex_gemm_np(Linv, sq_norms, distances):
    """The JAX package's host apex solve (``repro.core.simplex.apex_gemm_np``)
    restated in numpy: the card's machine has no jax to import it from."""
    d1sq = distances[:, :1] ** 2
    w = (0.5 * (d1sq + sq_norms[None, :] - distances[:, 1:] ** 2)) @ Linv.T
    alt2 = np.maximum(d1sq[:, 0] - np.einsum("bi,bi->b", w, w), 0.0)
    return np.concatenate([w, np.sqrt(alt2)[:, None]], axis=-1)


@pytest.mark.parametrize("B", [256, 2048, 2304])
def test_k4_add_burst_equals_apex_gemm_np(cuda, B):
    """K4 at the online path's add bursts (upserts of 256 rows, adds of
    2,048, both since the last query: 2,304), n = 20, f64, as
    ``NSimplexIndex.extended`` calls it: within 2.8e-16 of the host solve on
    the same fitted factors and distances (the head coordinates, and the
    altitude squared), bit-equal to its first design, and the appended
    table equal to a fresh projection of the same rows."""
    from repro_torch.data import colors_like
    from repro_torch.index import NSimplexIndex
    from repro_torch.metrics import get_metric

    X = colors_like(n=20_000 + B, dim=112, seed=29)
    idx = NSimplexIndex(X[:20_000], X[:20], get_metric("euclidean"), device="cuda")
    proj = idx.projector
    new = torch.as_tensor(X[20_000:], device=cuda)
    dists = proj.pivot_distances(new).contiguous()
    ops.reset_launches()
    ext = idx.extended(new)
    assert ops.SHAPE_LAUNCHES["apex_project"] == {(B, 20, "float64"): 1}
    got = ext.table[20_000:]
    assert torch.equal(got, ops.apex_project(dists, proj._Linv_t, proj._sq_norms_t, _plan="row"))
    want = _apex_gemm_np(proj.Linv, proj.sq_norms, dists.cpu().numpy())
    got = got.cpu().numpy()
    np.testing.assert_allclose(got[:, :-1], want[:, :-1], rtol=0, atol=2.8e-16)
    np.testing.assert_allclose(got[:, -1] ** 2, want[:, -1] ** 2, rtol=0, atol=2.8e-16)
    assert torch.equal(ext.table[:20_000], idx.table)


#: the benchmark cells' table size: the exact k-NN overflow route re-runs K3
#: over a batch's overflowing queries at the next power of two of their
#: largest count, up to N
OVERFLOW_N = 112_682


@pytest.fixture(scope="module")
def overflow_table():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return _apexes(OVERFLOW_N, 20, 21, torch.float32, "cuda"), _apexes(64, 20, 22, torch.float32, "cuda")


@pytest.mark.parametrize("width", [16_384, 65_536, OVERFLOW_N])
@pytest.mark.parametrize("masked", [False, True])
def test_k3_at_the_overflow_route_widths(cuda, overflow_table, width, masked):
    """K3 at Q = 64 over 112,682 rows, at the widths the overflow route asks
    for, with counts from a quarter of the width up to the width itself:
    bit-equal to a selection over K1's own matrices, with exact counts."""
    table, queries = overflow_table
    Q, N = queries.shape[0], table.shape[0]
    mask = torch.rand(N, generator=torch.Generator().manual_seed(9)).lt(0.6).to(cuda) if masked else None
    L, U = ops.apex_bounds_batch(table, queries)
    live = torch.ones_like(L, dtype=torch.bool) if mask is None else mask[None].expand_as(L)
    srt = torch.sort(torch.where(live, L, float("inf")), dim=1).values
    n_live = int(live[0].sum())
    ranks = torch.linspace(width // 4, width - 1, Q).long().clamp_max(n_live - 1).to(cuda)
    thr = srt[torch.arange(Q, device=cuda), ranks].contiguous()
    before = LAUNCHES["apex_threshold"]
    ids, lwb, upb, counts = ops.apex_bounds_threshold(table, queries, thr, width, rowmask=mask)
    assert LAUNCHES["apex_threshold"] == before + 1
    hit = live & (L <= thr[:, None])
    assert torch.equal(counts, hit.sum(dim=1).to(torch.int32))
    assert int(counts.max()) <= width and int(counts.max()) > width // 2
    want = _selection(ref.pack_keys(L, hit), L, U, width)
    for g, w in zip((ids, lwb, upb), want):
        assert torch.equal(g, w)


def test_k3_from_threads_at_different_widths(cuda, k2_table):
    """Host threads launching K3 at once, each at its own width (a sharded
    fan-out's segments re-running their overflowing queries): every launch
    succeeds and equals the same launch made alone.  The kernels' dynamic
    shared memory size is set per kernel function before each launch, which
    threads would otherwise overwrite for each other."""
    import threading

    table, queries = k2_table[0], k2_table[1][:19]
    L, _ = ops.apex_bounds_batch(table, queries)
    srt = torch.sort(L, dim=1).values
    widths = [512, 1024, 2048, 4096, 16_384]
    thr = {w: srt[:, w - 1].contiguous() for w in widths}
    want = {w: ops.apex_bounds_threshold(table, queries, thr[w], w) for w in widths}
    got, errors = {}, []

    def work(w):
        try:
            for _ in range(25):
                got[w] = ops.apex_bounds_threshold(table, queries, thr[w], w)
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=work, args=(w,)) for w in widths]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and errors == []
    torch.cuda.synchronize()
    for w in widths:
        for g, x in zip(got[w], want[w]):
            assert torch.equal(g, x)


@pytest.mark.parametrize("name", ["euclidean", "jensen_shannon"])
def test_knn_overflow_route_on_card(cuda, name):
    """Exact k-NN where every query of a 64-query batch overflows pass B:
    one K2 and two K3 launches (pass B, then the route's re-run), no K1; the
    answers equal a float64 scan on the card, and ids and ``QueryStats``
    equal the CPU twin's (the same state, the plain kernels)."""
    from repro_torch.data import colors_like
    from repro_torch.index import NSimplexIndex
    from repro_torch.metrics import get_metric

    X = colors_like(n=20_000 + 64, seed=23).astype(np.float64)
    data, queries = X[:20_000], X[20_000:]
    pivots = data[np.random.default_rng(3).choice(20_000, 8, replace=False)]
    host = NSimplexIndex(data, pivots, get_metric(name), device="cpu")
    card = NSimplexIndex.from_state(host.state_arrays(), get_metric(name), device=cuda)
    before = dict(LAUNCHES)
    got = card.knn_batch(queries, 10)
    assert card.overflow_queries == len(queries)
    grew = {k: LAUNCHES[k] - before[k] for k in ("apex_topk", "apex_threshold", "apex_bounds_batch")}
    assert grew == {"apex_topk": 1, "apex_threshold": 2, "apex_bounds_batch": 0}
    want = host.knn_batch(queries, 10)
    for q, (gi, gd, gs), (wi, _, ws) in zip(queries, got, want):
        d = card.metric.one_to_many(torch.as_tensor(q, device=cuda), card.data).cpu().numpy()
        oracle = np.lexsort((np.arange(d.shape[0]), d))[:10]
        np.testing.assert_array_equal(gi, oracle)
        np.testing.assert_allclose(gd, d[oracle], rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(gi, wi)
        assert (gs.original_calls, gs.surrogate_calls, gs.candidates) == (ws.original_calls, ws.surrogate_calls,
                                                                          ws.candidates)
