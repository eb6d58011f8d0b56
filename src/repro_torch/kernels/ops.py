"""Wrappers of the six kernels.

Each wrapper checks its operands, then runs its CUDA kernel for tensors on
a CUDA device, or its plain PyTorch version (``ref.py``) for tensors on the
CPU.  A CUDA tensor is never sent to the plain version: the kernel launches
or the wrapper raises.  ``LAUNCHES`` counts kernel launches per wrapper (one
per call that reaches the card), so a run can show that its main path went
through the kernels; ``SHAPE_LAUNCHES`` splits the same counts by shape class
(``shape_class``), so each kernel can be timed at the shapes it is launched
with.

  ====  ==========================  ============================================
  id    wrapper                     TPU kernel it replaces
  ====  ==========================  ============================================
  K6    ``apex_bounds``             ``apex_bounds.py::apex_bounds_pallas``
  K1    ``apex_bounds_batch``       ``apex_bounds_batch.py::apex_bounds_batch_pallas``
  K2    ``apex_bounds_topk``        ``select_epilogue.py::apex_topk_pallas``
  K3    ``apex_bounds_threshold``   ``select_epilogue.py::apex_threshold_pallas``
  K4    ``apex_project``            ``apex_project.py::apex_project_pallas``
  K5    ``jsd_pairwise``            ``jsd_distance.py::jsd_pairwise_pallas``
  ====  ==========================  ============================================
"""

from __future__ import annotations

import functools
import threading

import torch

from repro_torch.kernels import ref, tuning
from repro_torch.kernels.ref import SENTINEL_ID, TOPK_KEYS
from repro_torch.kernels.tuning import DEFAULT_CONFIG, KernelConfig

__all__ = [
    "LAUNCHES",
    "MAX_SELECT_WIDTH",
    "SHAPE_LAUNCHES",
    "SENTINEL_ID",
    "TOPK_KEYS",
    "apex_bounds",
    "apex_bounds_batch",
    "apex_bounds_threshold",
    "apex_bounds_topk",
    "apex_project",
    "apex_project_plan",
    "jsd_pairwise",
    "jsd_plan",
    "reset_launches",
    "shape_class",
    "threshold_plan",
    "topk_plan",
]

#: widest selection (k of K2, cap of K3) the CUDA kernels hold in shared
#: memory; ``select_epilogue.cu`` states the same limit
MAX_SELECT_WIDTH = 4096

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES = {
    "apex_bounds": 0,
    "apex_bounds_batch": 0,
    "apex_topk": 0,
    "apex_threshold": 0,
    "apex_project": 0,
    "jsd_pairwise": 0,
}
#: kernel launches per wrapper and per shape class (a plain tuple, see
#: ``shape_class``) since the last ``reset_launches``
SHAPE_LAUNCHES = {name: {} for name in LAUNCHES}
_launch_lock = threading.Lock()

_KEY_MODE = {"lwb": 0, "upb": 1, "mid": 2}


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
            SHAPE_LAUNCHES[name].clear()


def _p_bucket(P: int) -> int:
    """K5's row-count class: P itself up to 32, else the next power of two
    (refinement chunks of up to 256 rows share one class)."""
    return P if P <= 32 else 1 << (P - 1).bit_length()


def shape_class(name: str, **s) -> tuple:
    """The shape class a launch of kernel ``name`` counts under:

    ====================  =====================================
    ``apex_bounds``       ``(n, dtype)``
    ``apex_bounds_batch`` ``(Q, dims)``
    ``apex_topk``         ``(Q, k, key, dims)``
    ``apex_threshold``    ``(Q, cap, dims)``
    ``apex_project``      ``(B, n, dtype)``
    ``jsd_pairwise``      ``(Q, P bucket, d, dtype)``
    ====================  =====================================

    A K2 or K3 launch under a row mask (``masked=True``) counts in its own
    class, the tuple above followed by ``"masked"``.
    """
    if name == "apex_bounds":
        return (s["n"], s["dtype"])
    if name == "apex_bounds_batch":
        return (s["Q"], s["dims"])
    masked = ("masked",) if s.get("masked") else ()
    if name == "apex_topk":
        return (s["Q"], s["k"], s["key"], s["dims"]) + masked
    if name == "apex_threshold":
        return (s["Q"], s["cap"], s["dims"]) + masked
    if name == "apex_project":
        return (s["B"], s["n"], s["dtype"])
    if name == "jsd_pairwise":
        return (s["Q"], _p_bucket(s["P"]), s["d"], s["dtype"])
    raise KeyError(name)


_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64"}


def _dtype_name(t: torch.Tensor) -> str:
    return _DTYPE_NAMES[t.dtype]


def _count(name: str, cls: tuple) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
        by = SHAPE_LAUNCHES[name]
        by[cls] = by.get(cls, 0) + 1


def _counted(name: str, **shape) -> None:
    _count(name, shape_class(name, **shape))


def _on_cuda(*tensors) -> bool:
    """True for CUDA operands, False for CPU ones; raises on a mix."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors if t is not None}) == 1:
        return True
    raise ValueError(f"operands must all lie on one CPU or CUDA device; got {kinds}")


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


#: the current stream's raw handle without building a ``torch.cuda.Stream``
#: (absent from CPU-only builds, which never launch)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device) -> int:
    """The current CUDA stream's handle on ``device`` (a device or its index)."""
    index = device if isinstance(device, int) else device.index
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_table(table: torch.Tensor, queries: torch.Tensor, dims):
    if table.ndim != 2 or queries.ndim != 2:
        raise ValueError(f"table and queries must be 2-D; got {tuple(table.shape)}, {tuple(queries.shape)}")
    if table.dtype not in (torch.float32, torch.float64) or queries.dtype != table.dtype:
        raise TypeError(f"table and queries must share float32 or float64; got {table.dtype}, {queries.dtype}")
    n = table.shape[1]
    dims = n if dims is None else int(dims)
    if not (2 <= dims <= n) or queries.shape[1] not in (n, dims):
        raise ValueError(
            f"dims must be in [2, {n}] with queries {n} or dims wide; "
            f"got dims={dims}, queries {tuple(queries.shape)}"
        )
    return dims


def _mask_operand(rowmask, N: int, device):
    """The row mask as the kernels read it: uint8, nonzero = allowed, on the
    table's device.  A contiguous uint8 tensor already there (the indexes
    make one per batch) is used as it is; anything else is converted, which
    copies a host mask to the card on every call."""
    if rowmask is None:
        return None
    m = torch.as_tensor(rowmask, device=device).reshape(-1)
    if m.shape[0] != N:
        raise ValueError(f"rowmask length {m.shape[0]} != table rows {N}")
    if m.dtype == torch.uint8 and m.is_contiguous():
        return m
    return (m != 0).to(torch.uint8).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


#: the most row slices a selection launch takes
_MAX_SLICES = 64


def _slices(sms: int, blocks_per_slice: int, N: int, waves: int = 2, slice_rows: int = 8192) -> int:
    """Row slices of the selection kernels, for ``blocks_per_slice`` blocks
    over each slice (one per query group): enough blocks for ``waves``
    waves over the card, at least ``slice_rows`` rows each, at most 64
    slices (the defaults: two waves, 8192 rows)."""
    want = -(-waves * sms // max(blocks_per_slice, 1))
    return int(max(1, min(want, -(-N // slice_rows), _MAX_SLICES)))


#: shared memory K2 gives the selection state (running selection and
#: candidate buffer) of one query group, its largest group, and its
#: candidate buffer length floor: ``kGroupBytes``, ``kMaxGroup`` and
#: ``kMinCandGroup`` in select_epilogue.cu, which refuses a G outside them
_TOPK_GROUP_BYTES = 64 * 1024
_TOPK_MAX_GROUP = 32
_TOPK_MIN_CAND = 512


def _topk_max_group(k: int) -> int:
    """The most K2 queries whose selection state fits one block's 64 KiB."""
    wp = 1 << (k - 1).bit_length()
    return min(_TOPK_MAX_GROUP, _TOPK_GROUP_BYTES // ((wp + max(wp, _TOPK_MIN_CAND)) * 8))


def topk_plan(k: int, Q: int, N: int, sms: int, config: KernelConfig = DEFAULT_CONFIG) -> tuple:
    """K2's launch plan ``(G, S)``: G queries per block, each holding a
    running selection of ``wp = next_pow2(k)`` keys and a candidate buffer of
    ``max(wp, 512)``, as many as fit in 64 KiB (at most ``config.max_group``,
    32 by default, at least 1), balanced over the ``ceil(Q / G)`` groups; and
    S row slices so that groups x slices fill the card (``_slices`` under
    the config's slice rule).  The table is read once per group; G = 1 runs
    the one-query-per-block kernel K3 also uses."""
    G = max(1, min(config.max_group, _topk_max_group(k), Q))
    groups = -(-Q // G)
    G = -(-Q // groups)
    return G, _slices(sms, groups, N, config.waves, config.slice_rows)


#: K3's group budget, candidate buffer length and slices per gather block:
#: ``kThrGroupBytes``, ``kThrCand`` and ``kGatherSlices`` in
#: select_epilogue.cu, which refuses a G outside the budget
_THR_GROUP_BYTES = 64 * 1024
_THR_CAND = 512
_THR_GATHER = 8


def threshold_plan(cap: int, Q: int, N: int, sms: int, config: KernelConfig = DEFAULT_CONFIG) -> tuple:
    """K3's launch plan ``(G, S)``: G queries per block, as many 512-key
    candidate buffers as fit in 64 KiB (16; the keys a query keeps live in
    its slot of the global scratch, so G does not depend on ``cap``), at
    most ``config.max_group``, balanced over the ``ceil(Q / G)`` groups; and
    S row slices so that groups x slices fill the card (``_slices`` under
    the config's slice rule).  One query is a group of one, which on the
    H100 was faster than one query per block at half-cap thresholds and
    slower by a tenth at k-NN pass B's at cap 512 (PERF.md).  G = 0, one
    query per block (the first design), comes only from a config with
    ``max_group=0`` (a tuned cache entry) or a caller's forced plan."""
    if config.max_group == 0:
        return 0, _slices(sms, Q, N, config.waves, config.slice_rows)
    G = max(1, min(config.max_group, _THR_GROUP_BYTES // (_THR_CAND * 8), Q))
    groups = -(-Q // G)
    G = -(-Q // groups)
    return G, _slices(sms, groups, N, config.waves, config.slice_rows)


#: K1's launch plans: ``"stream"`` (one thread per row, row in registers,
#: 64-query chunks), which the wrapper runs at every Q by default, and
#: ``"tile"`` (table tile x 16-query tile, the first design), which a tuned
#: cache entry or a caller that forces it runs
_K1_PLANS = {"tile": 0, "stream": 1}


def _check_plan(plan, valid: bool, what: str):
    if plan is not None and not valid:
        raise ValueError(f"{what}: invalid launch plan {plan!r}")


def apex_bounds(table: torch.Tensor, query: torch.Tensor):
    """K6: (lwb, upb), each (N,), of one (n,) query apex against an (N, n) table."""
    if table.ndim != 2 or query.shape != (table.shape[1],):
        raise ValueError(f"need an (N, n) table and an (n,) query; got {tuple(table.shape)}, {tuple(query.shape)}")
    if table.dtype not in (torch.float32, torch.float64) or query.dtype != table.dtype:
        raise TypeError(f"table and query must share float32 or float64; got {table.dtype}, {query.dtype}")
    if not _on_cuda(table, query):
        return ref.apex_bounds_ref(table, query)
    from repro_torch.kernels.build import library

    table, query = table.contiguous(), query.contiguous()
    N, n = table.shape
    lwb = torch.empty(N, dtype=table.dtype, device=table.device)
    upb = torch.empty_like(lwb)
    fn = library().repro_apex_bounds_f32 if table.dtype == torch.float32 else library().repro_apex_bounds_f64
    _check(fn(table.data_ptr(), N, n, query.data_ptr(), lwb.data_ptr(), upb.data_ptr(), _stream(table.device)), "apex_bounds")
    _counted("apex_bounds", n=n, dtype=_dtype_name(table))
    return lwb, upb


def apex_bounds_batch(table: torch.Tensor, queries: torch.Tensor, *, dims: int = None, _plan: str = None):
    """K1: (lwb, upb), each (Q, N), of a (Q, n or dims) query block against
    an (N, n) table; ``dims=k`` gives the truncated k-prefix bounds.  On the
    card the plan is the tuning cache's for (n, dims, dtype)
    (``tuning.lookup``; ``"stream"`` without a cache); the private ``_plan``
    forces one (``"tile"`` is the first design); both give the same bits."""
    if queries.ndim == 1:   # cheaper than torch.atleast_2d on this per-query path
        queries = queries[None]
    dims = _check_table(table, queries, dims)
    _check_plan(_plan, _plan in _K1_PLANS, "apex_bounds_batch")
    if not _on_cuda(table, queries):
        return ref.apex_bounds_batch_ref(table, queries, dims)
    from repro_torch.kernels.build import library

    table, queries = table.contiguous(), queries.contiguous()
    (N, n), (Q, qw) = table.shape, queries.shape
    lwb, upb = torch.empty((2, Q, N), dtype=table.dtype, device=table.device)   # one allocation
    lib = library()
    fn = lib.repro_apex_bounds_batch_f32 if table.dtype == torch.float32 else lib.repro_apex_bounds_batch_f64
    if _plan is None:
        _plan = tuning.lookup("apex_bounds_batch", n, dims, table.dtype).plan
    code = _K1_PLANS[_plan]
    _check(
        fn(table.data_ptr(), N, n, queries.data_ptr(), Q, qw, dims, code, lwb.data_ptr(), upb.data_ptr(),
           _stream(table.device)),
        "apex_bounds_batch",
    )
    _counted("apex_bounds_batch", Q=Q, dims=dims)
    return lwb, upb


def _check_select(table, queries, dims, width: int, what: str):
    dims = _check_table(table, queries, dims)
    if table.dtype != torch.float32:
        raise TypeError(f"{what} takes a float32 table only; got {table.dtype}")
    if width < 1:
        raise ValueError(f"{what} width must be >= 1; got {width}")
    return dims


def _scratch(Q: int, S: int, width: int, device):
    wp = 1 << (width - 1).bit_length()
    return torch.empty((Q, S, wp), dtype=torch.int64, device=device)


def _threshold_scratch(Q: int, S: int, cap: int, device):
    """K3's key scratch: per (query, slice) a slot of ``wp + max(wp, 512)``
    keys, then per query ``ceil(S / 8)`` gathered selections of ``wp``
    (``thr_slot`` and ``kGatherSlices`` in select_epilogue.cu)."""
    wp = 1 << (cap - 1).bit_length()
    slot = wp + max(wp, _THR_CAND)
    return torch.empty(Q * S * slot + Q * -(-S // _THR_GATHER) * wp, dtype=torch.int64, device=device)


def _select_outputs(Q: int, width: int, device):
    return (
        torch.empty((Q, width), dtype=torch.int32, device=device),
        torch.empty((Q, width), dtype=torch.float32, device=device),
        torch.empty((Q, width), dtype=torch.float32, device=device),
    )


def _check_width(width: int, what: str):
    if width > MAX_SELECT_WIDTH:
        raise ValueError(
            f"{what} width {width} exceeds the kernel's {MAX_SELECT_WIDTH}; "
            "route wider selections through per-query apex_bounds_batch"
        )


def apex_bounds_topk(table, queries, k: int, *, key: str = "mid", dims: int = None, rowmask=None,
                     _plan: tuple = None):
    """K2: per query the ``k`` rows with the smallest ``(key, id)``, sorted,
    as (ids int32, lwb, upb), each (Q, k); ``k`` is clamped to N.  Masked
    rows never enter; a short selection pads with ``SENTINEL_ID`` and +inf.
    On the card the plan is ``topk_plan`` under the tuning cache's config for
    (n, dims, float32) (``DEFAULT_CONFIG`` without a cache); the private
    ``_plan`` forces a launch plan ``(G, S)`` (timing, tuning and tests);
    every plan gives the same result."""
    queries = torch.atleast_2d(queries)
    if key not in TOPK_KEYS:
        raise ValueError(f"key must be one of {TOPK_KEYS}; got {key!r}")
    k = int(min(k, table.shape[0]))
    _check_plan(_plan, _plan is None or (len(_plan) == 2 and 1 <= _plan[0] <= _topk_max_group(max(k, 1))
                                         and _plan[1] >= 1), "apex_bounds_topk")
    dims = _check_select(table, queries, dims, k, "apex_bounds_topk")
    mask = _mask_operand(rowmask, table.shape[0], table.device)
    if not _on_cuda(table, queries):
        return ref.apex_topk_ref(table, queries, k, key, dims, mask)
    _check_width(k, "apex_bounds_topk")
    from repro_torch.kernels.build import library

    table, queries = table.contiguous(), queries.contiguous()
    (N, n), (Q, qw) = table.shape, queries.shape
    G, S = _plan or topk_plan(k, Q, N, _sm_count(table.device.index or 0),
                              tuning.lookup("apex_topk", n, dims, table.dtype))
    part = _scratch(Q, S, k, table.device)
    ids, lwb, upb = _select_outputs(Q, k, table.device)
    _check(
        library().repro_apex_topk(
            table.data_ptr(), N, n, queries.data_ptr(), Q, qw, dims, _ptr(mask), _KEY_MODE[key], k, G, S,
            part.data_ptr(), ids.data_ptr(), lwb.data_ptr(), upb.data_ptr(), _stream(table.device),
        ),
        "apex_bounds_topk",
    )
    _counted("apex_topk", Q=Q, k=k, key=key, dims=dims, masked=mask is not None)
    return ids, lwb, upb


def apex_bounds_threshold(table, queries, thresholds, cap: int, *, dims: int = None, rowmask=None,
                          _plan: tuple = None):
    """K3: per query the up-to-``cap`` smallest ``(lwb, id)`` among rows with
    ``lwb <= thresholds[q]`` (f32 compare), sorted, as (ids, lwb, upb), each
    (Q, cap), plus the exact per-query count of passing rows — a count above
    ``cap`` flags overflow.  ``cap`` is clamped to N.  The private ``_plan``
    forces a launch plan ``(G, S)`` on the card (timing and tests; by
    default ``threshold_plan``; G = 0 is the first design, one query per
    block); every plan gives the same result."""
    queries = torch.atleast_2d(queries)
    _check_plan(_plan, _plan is None or (len(_plan) == 2 and 0 <= _plan[0] <= _TOPK_MAX_GROUP and _plan[1] >= 1),
                "apex_bounds_threshold")
    cap = int(min(cap, table.shape[0]))
    dims = _check_select(table, queries, dims, cap, "apex_bounds_threshold")
    thresholds = torch.as_tensor(thresholds, dtype=torch.float32, device=table.device).reshape(-1)
    if thresholds.shape[0] != queries.shape[0]:
        raise ValueError(f"need one threshold per query; got {thresholds.shape[0]} for {queries.shape[0]}")
    mask = _mask_operand(rowmask, table.shape[0], table.device)
    if not _on_cuda(table, queries):
        return ref.apex_threshold_ref(table, queries, thresholds, cap, dims, mask)
    _check_width(cap, "apex_bounds_threshold")
    from repro_torch.kernels.build import library

    table, queries, thresholds = table.contiguous(), queries.contiguous(), thresholds.contiguous()
    (N, n), (Q, qw) = table.shape, queries.shape
    G, S = _plan or threshold_plan(cap, Q, N, _sm_count(table.device.index or 0),
                                   tuning.lookup("apex_threshold", n, dims, table.dtype))
    part = _threshold_scratch(Q, S, cap, table.device)
    part_counts = torch.empty((Q, S), dtype=torch.int32, device=table.device)
    ids, lwb, upb = _select_outputs(Q, cap, table.device)
    counts = torch.empty(Q, dtype=torch.int32, device=table.device)
    _check(
        library().repro_apex_threshold(
            table.data_ptr(), N, n, queries.data_ptr(), Q, qw, dims, _ptr(mask), thresholds.data_ptr(), cap, G, S,
            part.data_ptr(), part_counts.data_ptr(), ids.data_ptr(), lwb.data_ptr(), upb.data_ptr(),
            counts.data_ptr(), _stream(table.device),
        ),
        "apex_bounds_threshold",
    )
    _counted("apex_threshold", Q=Q, cap=cap, dims=dims, masked=mask is not None)
    return ids, lwb, upb, counts


def _check_float(*tensors, what: str):
    dt = tensors[0].dtype
    if dt not in (torch.float32, torch.float64) or any(t.dtype != dt for t in tensors):
        raise TypeError(f"{what} operands must share float32 or float64; got {[t.dtype for t in tensors]}")


#: K4's launch plans (``kPlanRow``, ``kPlanStream``, ``kPlanWarp`` in
#: apex_project.cu): ``"row"``, one thread per row (the first design, every
#: n); ``"stream"``, rows streamed through a cp.async ring by persistent
#: blocks; ``"warp"``, one warp per row
_K4_PLANS = {"row": 0, "stream": 1, "warp": 2}
#: widest head n - 1 of the stream and warp plans: ``kMaxHead`` in
#: apex_project.cu, which refuses either plan above it
_K4_MAX_HEAD = 32
#: the warp plan serves calls of at most this many rows per SM (one
#: 32-thread block per row; on the H100 it beat the stream plan up to 1024
#: rows and tied or lost from 4096, PERF.md)
_K4_WARP_ROWS_PER_SM = 16
#: K4's ctypes functions by dtype, looked up at the first launch
_K4_FN = {}


def apex_project_plan(B: int, n: int, sms: int) -> str:
    """K4's launch plan for B rows of n pivot distances on ``sms`` SMs: the
    first design (``"row"``) where n - 1 exceeds the templated widths, else
    one warp per row while the rows are few (the query shapes), else the
    stream plan (table builds).  Every plan gives the same bits."""
    if n - 1 > _K4_MAX_HEAD:
        return "row"
    return "warp" if B <= _K4_WARP_ROWS_PER_SM * sms else "stream"


def _k4_fn(dtype):
    from repro_torch.kernels.build import library

    lib = library()
    fn = _K4_FN[dtype] = lib.repro_apex_project_f32 if dtype is torch.float32 else lib.repro_apex_project_f64
    return fn


def apex_project(distances: torch.Tensor, Linv: torch.Tensor, sq_norms: torch.Tensor, *,
                 _plan: str = None) -> torch.Tensor:
    """K4: (B, n) apexes of (B, n) pivot distances against the fitted
    (n-1, n-1) ``Linv`` and (n-1,) ``sq_norms``, in the distances' dtype
    (f64 accumulates in f64).  The private ``_plan`` forces a launch plan on
    the card (timing and tests; by default ``apex_project_plan``; ``"row"``
    is the first design); every plan gives the same bits."""
    if distances.ndim != 2 or distances.shape[1] < 2:
        raise ValueError(f"need (B, n) pivot distances with n >= 2; got {tuple(distances.shape)}")
    B, n = distances.shape
    return _project(distances, B, n, Linv, sq_norms, _plan)


def _apex_project_vector(distances: torch.Tensor, Linv: torch.Tensor, sq_norms: torch.Tensor) -> torch.Tensor:
    """K4 on one (n,) row of pivot distances: its (n,) apex, with the checks
    of ``apex_project`` and no view in or out (the projector's per-query
    path)."""
    if distances.ndim != 1 or distances.shape[0] < 2:
        raise ValueError(f"need (n,) pivot distances with n >= 2; got {tuple(distances.shape)}")
    return _project(distances, 1, distances.shape[0], Linv, sq_norms, None)


def _project(distances, B: int, n: int, Linv, sq_norms, plan):
    """``apex_project`` on ``distances`` read as (B, n) rows; the output
    takes the distances' shape.  Its checks read attributes directly rather
    than through the shared helpers: this runs once per query."""
    h = n - 1
    if Linv.shape != (h, h) or sq_norms.shape != (h,):
        raise ValueError(
            f"need a ({h}, {h}) Linv and ({h},) sq_norms for n = {n}; "
            f"got {tuple(Linv.shape)}, {tuple(sq_norms.shape)}"
        )
    dt = distances.dtype
    if dt not in _DTYPE_NAMES or Linv.dtype is not dt or sq_norms.dtype is not dt:
        raise TypeError(
            f"apex_project operands must share float32 or float64; got {[dt, Linv.dtype, sq_norms.dtype]}"
        )
    if plan is not None:
        _check_plan(plan, plan in _K4_PLANS and (plan == "row" or h <= _K4_MAX_HEAD), "apex_project")
    dev = distances.get_device()
    if Linv.get_device() != dev or sq_norms.get_device() != dev:
        raise ValueError(
            "operands must all lie on one CPU or CUDA device; got "
            f"{[str(t.device) for t in (distances, Linv, sq_norms)]}"
        )
    if dev < 0:
        return ref.apex_project_ref(distances.reshape(B, n), Linv, sq_norms).reshape(distances.shape)
    if not distances.is_contiguous():
        distances = distances.contiguous()
    if not Linv.is_contiguous():
        Linv = Linv.contiguous()
    if not sq_norms.is_contiguous():
        sq_norms = sq_norms.contiguous()
    out = torch.empty_like(distances)
    if B == 0:
        return out
    sms = _sm_count(dev)
    fn = _K4_FN.get(dt) or _k4_fn(dt)
    _check(
        fn(distances.data_ptr(), B, n, Linv.data_ptr(), sq_norms.data_ptr(), out.data_ptr(),
           _K4_PLANS[plan or apex_project_plan(B, n, sms)], sms, _stream(dev)),
        "apex_project",
    )
    _count("apex_project", (B, n, _DTYPE_NAMES[dt]))
    return out


#: K5's split plan serves a call whose pairs, ``lanes`` threads each, would
#: take at most this many threads per SM (about a quarter of what an SM holds)
_JSD_SPLIT_THREADS_PER_SM = 512
#: pairs per block the tile plan aims at, and its largest bq and bp
_JSD_BLOCK_PAIRS = 1024
_JSD_MAX_TILE_ROWS = 128


def jsd_plan(Q: int, P: int, d: int, sms: int) -> tuple:
    """K5's launch plan for a (Q, P) call over d coordinates on ``sms`` SMs,
    as ``(lanes, bq, bp)``.  ``lanes > 1``: the split plan, ``lanes`` (a power
    of two <= 32, at most d) share each pair's coordinates, doubled while
    the pairs still leave the card mostly idle.  ``lanes == 1``: the tile
    plan, a block takes ``bq`` X rows x ``bp`` Y rows (each <= 128, at most
    1024 pairs: up to 4 per thread)."""
    lanes = 1
    while lanes < 32 and 2 * lanes <= d and Q * P * lanes * 2 <= sms * _JSD_SPLIT_THREADS_PER_SM:
        lanes *= 2
    if lanes > 1:
        return lanes, 0, 0
    bp = min(P, _JSD_MAX_TILE_ROWS, max(32, _JSD_BLOCK_PAIRS // min(Q, 32)))
    bq = min(Q, _JSD_MAX_TILE_ROWS, max(1, _JSD_BLOCK_PAIRS // bp))
    return 1, bq, bp


def jsd_pairwise(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """K5: (Q, P) sqrt-Jensen-Shannon distances in bits between the rows of
    X (Q, d) and Y (P, d), in X's dtype; rows are L1-normalised with
    ``max(sum, 1e-12)``, as the JAX package's wrapper does.  On the card the
    kernel normalises inside its one launch: the wrapper only allocates the
    output (for contiguous operands of one dtype, as the index passes)."""
    if X.ndim != 2 or Y.ndim != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"need (Q, d) and (P, d) operands; got {tuple(X.shape)}, {tuple(Y.shape)}")
    if Y.dtype != X.dtype:
        Y = Y.to(X.dtype)
    _check_float(X, Y, what="jsd_pairwise")
    if not _on_cuda(X, Y):
        return ref.jsd_pairwise_ref(ref.l1_normalise(X), ref.l1_normalise(Y))
    from repro_torch.kernels.build import library

    if not X.is_contiguous():
        X = X.contiguous()
    if not Y.is_contiguous():
        Y = Y.contiguous()
    (Q, d), P = X.shape, Y.shape[0]
    out = torch.empty((Q, P), dtype=X.dtype, device=X.device)
    lanes, bq, bp = jsd_plan(Q, P, d, _sm_count(X.device.index or 0))
    fn = library().repro_jsd_pairwise_f32 if X.dtype == torch.float32 else library().repro_jsd_pairwise_f64
    _check(
        fn(X.data_ptr(), Q, Y.data_ptr(), P, d, lanes, bq, bp, out.data_ptr(), _stream(X.device)),
        "jsd_pairwise",
    )
    _counted("jsd_pairwise", Q=Q, P=P, d=d, dtype=_dtype_name(X))
    return out
