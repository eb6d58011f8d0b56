"""Wrappers of the four bound-scan kernels.

Each wrapper checks its operands, then runs its CUDA kernel for tensors on
a CUDA device, or its plain PyTorch version (``ref.py``) for tensors on the
CPU.  A CUDA tensor is never sent to the plain version: the kernel launches
or the wrapper raises.  ``LAUNCHES`` counts kernel launches per wrapper (one
per call that reaches the card), so a run can show that its main path went
through the kernels.

  ====  ==========================  ============================================
  id    wrapper                     TPU kernel it replaces
  ====  ==========================  ============================================
  K6    ``apex_bounds``             ``apex_bounds.py::apex_bounds_pallas``
  K1    ``apex_bounds_batch``       ``apex_bounds_batch.py::apex_bounds_batch_pallas``
  K2    ``apex_bounds_topk``        ``select_epilogue.py::apex_topk_pallas``
  K3    ``apex_bounds_threshold``   ``select_epilogue.py::apex_threshold_pallas``
  ====  ==========================  ============================================
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import SENTINEL_ID, TOPK_KEYS

__all__ = [
    "LAUNCHES",
    "MAX_SELECT_WIDTH",
    "SENTINEL_ID",
    "TOPK_KEYS",
    "apex_bounds",
    "apex_bounds_batch",
    "apex_bounds_threshold",
    "apex_bounds_topk",
    "reset_launches",
]

#: widest selection (k of K2, cap of K3) the CUDA kernels hold in shared
#: memory; ``select_epilogue.cu`` states the same limit
MAX_SELECT_WIDTH = 4096

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES = {"apex_bounds": 0, "apex_bounds_batch": 0, "apex_topk": 0, "apex_threshold": 0}
_launch_lock = threading.Lock()

_KEY_MODE = {"lwb": 0, "upb": 1, "mid": 2}


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _counted(name: str) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1


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


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
    if rowmask is None:
        return None
    m = torch.as_tensor(rowmask, device=device).reshape(-1)
    if m.shape[0] != N:
        raise ValueError(f"rowmask length {m.shape[0]} != table rows {N}")
    return (m != 0).to(torch.uint8).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _slices(device, Q: int, N: int) -> int:
    """Row slices per query of the selection kernels: enough blocks for two
    waves over the card, at least 8192 rows each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-2 * sms // max(Q, 1))
    return int(max(1, min(want, -(-N // 8192), 64)))


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
    _counted("apex_bounds")
    return lwb, upb


def apex_bounds_batch(table: torch.Tensor, queries: torch.Tensor, *, dims: int = None):
    """K1: (lwb, upb), each (Q, N), of a (Q, n or dims) query block against
    an (N, n) table; ``dims=k`` gives the truncated k-prefix bounds."""
    queries = torch.atleast_2d(queries)
    dims = _check_table(table, queries, dims)
    if not _on_cuda(table, queries):
        return ref.apex_bounds_batch_ref(table, queries, dims)
    from repro_torch.kernels.build import library

    table, queries = table.contiguous(), queries.contiguous()
    (N, n), (Q, qw) = table.shape, queries.shape
    lwb = torch.empty((Q, N), dtype=table.dtype, device=table.device)
    upb = torch.empty_like(lwb)
    lib = library()
    fn = lib.repro_apex_bounds_batch_f32 if table.dtype == torch.float32 else lib.repro_apex_bounds_batch_f64
    _check(
        fn(table.data_ptr(), N, n, queries.data_ptr(), Q, qw, dims, lwb.data_ptr(), upb.data_ptr(), _stream(table.device)),
        "apex_bounds_batch",
    )
    _counted("apex_bounds_batch")
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


def apex_bounds_topk(table, queries, k: int, *, key: str = "mid", dims: int = None, rowmask=None):
    """K2: per query the ``k`` rows with the smallest ``(key, id)``, sorted,
    as (ids int32, lwb, upb), each (Q, k); ``k`` is clamped to N.  Masked
    rows never enter; a short selection pads with ``SENTINEL_ID`` and +inf."""
    queries = torch.atleast_2d(queries)
    if key not in TOPK_KEYS:
        raise ValueError(f"key must be one of {TOPK_KEYS}; got {key!r}")
    k = int(min(k, table.shape[0]))
    dims = _check_select(table, queries, dims, k, "apex_bounds_topk")
    mask = _mask_operand(rowmask, table.shape[0], table.device)
    if not _on_cuda(table, queries):
        return ref.apex_topk_ref(table, queries, k, key, dims, mask)
    _check_width(k, "apex_bounds_topk")
    from repro_torch.kernels.build import library

    table, queries = table.contiguous(), queries.contiguous()
    (N, n), (Q, qw) = table.shape, queries.shape
    S = _slices(table.device, Q, N)
    part = _scratch(Q, S, k, table.device)
    ids, lwb, upb = _select_outputs(Q, k, table.device)
    _check(
        library().repro_apex_topk(
            table.data_ptr(), N, n, queries.data_ptr(), Q, qw, dims, _ptr(mask), _KEY_MODE[key], k, S,
            part.data_ptr(), ids.data_ptr(), lwb.data_ptr(), upb.data_ptr(), _stream(table.device),
        ),
        "apex_bounds_topk",
    )
    _counted("apex_topk")
    return ids, lwb, upb


def apex_bounds_threshold(table, queries, thresholds, cap: int, *, dims: int = None, rowmask=None):
    """K3: per query the up-to-``cap`` smallest ``(lwb, id)`` among rows with
    ``lwb <= thresholds[q]`` (f32 compare), sorted, as (ids, lwb, upb), each
    (Q, cap), plus the exact per-query count of passing rows — a count above
    ``cap`` flags overflow.  ``cap`` is clamped to N."""
    queries = torch.atleast_2d(queries)
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
    S = _slices(table.device, Q, N)
    part = _scratch(Q, S, cap, table.device)
    part_counts = torch.empty((Q, S), dtype=torch.int32, device=table.device)
    ids, lwb, upb = _select_outputs(Q, cap, table.device)
    counts = torch.empty(Q, dtype=torch.int32, device=table.device)
    _check(
        library().repro_apex_threshold(
            table.data_ptr(), N, n, queries.data_ptr(), Q, qw, dims, _ptr(mask), thresholds.data_ptr(), cap, S,
            part.data_ptr(), part_counts.data_ptr(), ids.data_ptr(), lwb.data_ptr(), upb.data_ptr(),
            counts.data_ptr(), _stream(table.device),
        ),
        "apex_bounds_threshold",
    )
    _counted("apex_threshold")
    return ids, lwb, upb, counts
