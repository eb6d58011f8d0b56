"""Plain PyTorch versions of the six kernels.

Each computes the same function as its CUDA kernel with ordinary tensor
operations: the wrappers in ``ops.py`` run them for tensors on the CPU, and
``chip_smoke.py`` holds each kernel against them on the card.  They
materialise the (Q, N) bound matrices, which the kernels K2 and K3 never do,
and the (Q, P, d) tensor of JSD mid-points, which K5 never does.
"""

from __future__ import annotations

import torch

__all__ = [
    "SENTINEL_ID",
    "TOPK_KEYS",
    "apex_bounds_batch_ref",
    "apex_bounds_ref",
    "apex_project_ref",
    "apex_threshold_ref",
    "apex_topk_ref",
    "threshold_from_bounds",
    "topk_from_bounds",
    "jsd_pairwise_ref",
    "l1_normalise",
    "pack_keys",
    "split_trunc",
    "xlogx",
]

#: id of an empty selection slot (pad or masked rows): sorts after every id
SENTINEL_ID = 2**31 - 1
#: packed key of an empty slot: larger than every packed (key, id)
_EMPTY_KEY = 2**63 - 1
#: selection keys of the top-k epilogue
TOPK_KEYS = ("lwb", "upb", "mid")
#: the xlogx cut-off of the JSD kernels: v log v for v > _EPS, else 0
_EPS = 1e-12
_LN2 = 0.6931471805599453


def split_trunc(x: torch.Tensor, dims: int):
    """(head, altitude) of apex rows truncated to ``dims`` coordinates: the
    first ``dims - 1`` columns and ``sqrt(Σ_{i >= dims-1} x_i²)``."""
    head = x[:, : dims - 1]
    alt = torch.sqrt(torch.clamp_min((x[:, dims - 1:] ** 2).sum(dim=1), 0.0))
    return head, alt


def apex_bounds_ref(table: torch.Tensor, query: torch.Tensor):
    """K6: (lwb, upb), each (N,), of one query apex, difference form."""
    head = ((table[:, :-1] - query[None, :-1]) ** 2).sum(dim=1)
    dm = (table[:, -1] - query[-1]) ** 2
    dp = (table[:, -1] + query[-1]) ** 2
    return torch.sqrt(torch.clamp_min(head + dm, 0.0)), torch.sqrt(torch.clamp_min(head + dp, 0.0))


def apex_bounds_batch_ref(table: torch.Tensor, queries: torch.Tensor, dims: int):
    """K1: (lwb, upb), each (Q, N), GEMM form, truncated to ``dims``."""
    th, ta = split_trunc(table, dims)
    qh, qa = split_trunc(queries, dims)
    q2 = (qh * qh).sum(dim=1, keepdim=True)
    x2 = (th * th).sum(dim=1)[None, :]
    head = torch.clamp_min(q2 + x2 - 2.0 * (qh @ th.T), 0.0)
    dm = (qa[:, None] - ta[None, :]) ** 2
    dp = (qa[:, None] + ta[None, :]) ** 2
    return torch.sqrt(torch.clamp_min(head + dm, 0.0)), torch.sqrt(torch.clamp_min(head + dp, 0.0))


def pack_keys(keys: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """(Q, N) int64 keys ``(float_bits(key) << 32) | id`` (sign bit cleared,
    so a -0.0 packs as 0); rows that are not ``live`` pack as empty."""
    bits = keys.contiguous().view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    ids = torch.arange(keys.shape[1], dtype=torch.int64, device=keys.device)
    return torch.where(live, (bits << 32) | ids[None, :], _EMPTY_KEY)


def _take(packed: torch.Tensor, lwb: torch.Tensor, upb: torch.Tensor, width: int):
    """The ``width`` smallest packed keys per row as (ids, lwb, upb)."""
    top, pos = torch.sort(packed, dim=1)
    top, pos = top[:, :width], pos[:, :width]
    empty = top == _EMPTY_KEY
    inf = torch.tensor(float("inf"), dtype=lwb.dtype, device=lwb.device)
    ids = torch.where(empty, SENTINEL_ID, top & 0xFFFFFFFF).to(torch.int32)
    return (
        ids,
        torch.where(empty, inf, torch.gather(lwb, 1, pos)),
        torch.where(empty, inf, torch.gather(upb, 1, pos)),
    )


def _live(rowmask, N: int, device) -> torch.Tensor:
    if rowmask is None:
        return torch.ones((1, N), dtype=torch.bool, device=device)
    return rowmask.to(torch.bool).reshape(1, N)


def topk_from_bounds(lwb, upb, k: int, key: str, rowmask=None):
    """K2's selection over given (Q, N) bound matrices: per query the ``k``
    rows with the smallest (key, id), sorted."""
    keys = {"lwb": lwb, "upb": upb}.get(key)
    if keys is None:
        keys = 0.5 * (lwb + upb)
    live = _live(rowmask, lwb.shape[1], lwb.device).expand_as(lwb)
    return _take(pack_keys(keys, live), lwb, upb, k)


def threshold_from_bounds(lwb, upb, thresholds, cap: int, rowmask=None):
    """K3's selection over given (Q, N) bound matrices: per query the
    ``cap`` smallest (lwb, id) among rows with ``lwb <= thresholds[q]``,
    plus the exact count of such rows."""
    hit = _live(rowmask, lwb.shape[1], lwb.device) & (lwb <= thresholds[:, None])
    ids, l, u = _take(pack_keys(lwb, hit), lwb, upb, cap)
    return ids, l, u, hit.sum(dim=1).to(torch.int32)


def apex_topk_ref(table, queries, k: int, key: str, dims: int, rowmask=None):
    """K2: per query the ``k`` rows with the smallest (key, id), sorted."""
    lwb, upb = apex_bounds_batch_ref(table, queries, dims)
    return topk_from_bounds(lwb, upb, k, key, rowmask)


def apex_threshold_ref(table, queries, thresholds, cap: int, dims: int, rowmask=None):
    """K3: per query the ``cap`` smallest (lwb, id) among rows with
    ``lwb <= thresholds[q]``, plus the exact count of such rows."""
    lwb, upb = apex_bounds_batch_ref(table, queries, dims)
    return threshold_from_bounds(lwb, upb, thresholds, cap, rowmask)


def apex_project_ref(distances: torch.Tensor, Linv: torch.Tensor, sq_norms: torch.Tensor) -> torch.Tensor:
    """K4: (B, n) apexes of (B, n) pivot distances against the fitted
    ``L⁻¹``: ``g = ½(δ₁² + ‖vᵢ‖² − δᵢ²)``, ``w = g·L⁻ᵀ``, altitude
    ``sqrt(max(δ₁² − ‖w‖², 0))``; in the operands' dtype."""
    d1sq = distances[:, :1] ** 2
    g = 0.5 * (d1sq + sq_norms[None, :] - distances[:, 1:] ** 2)
    w = g @ Linv.T
    alt2 = torch.clamp_min(d1sq[:, 0] - (w * w).sum(dim=1), 0.0)
    return torch.cat([w, torch.sqrt(alt2)[:, None]], dim=1)


def xlogx(v: torch.Tensor) -> torch.Tensor:
    """``v log v`` where ``v > 1e-12``, else 0 (the JSD summand)."""
    return torch.where(v > _EPS, v * torch.log(torch.clamp_min(v, _EPS)), 0.0)


def l1_normalise(X: torch.Tensor) -> torch.Tensor:
    """Rows over ``max(sum, 1e-12)``: K5's normalisation."""
    return X / torch.clamp_min(X.sum(dim=1, keepdim=True), _EPS)


#: element budget of the (rows, P, d) mid-point temporary of one chunk
_JSD_CHUNK_ELEMS = 1 << 24


def jsd_pairwise_ref(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """K5: (Q, P) sqrt-JSD in bits between L1-normalised rows of X (Q, d) and
    Y (P, d), in the cross form ``½hx + ½hy − Σ xlogx((x + y)/2)``; X is
    taken in row chunks so the mid-point temporary stays bounded."""
    hx = xlogx(X).sum(dim=1)
    hy = xlogx(Y).sum(dim=1)
    out = torch.empty((X.shape[0], Y.shape[0]), dtype=X.dtype, device=X.device)
    chunk = max(1, _JSD_CHUNK_ELEMS // max(1, Y.shape[0] * Y.shape[1]))
    for lo in range(0, X.shape[0], chunk):
        hi = min(lo + chunk, X.shape[0])
        cross = xlogx(0.5 * (X[lo:hi, None, :] + Y[None, :, :])).sum(dim=-1)
        out[lo:hi] = 0.5 * hx[lo:hi, None] + 0.5 * hy[None, :] - cross
    return torch.sqrt(torch.clamp(out / _LN2, 0.0, 1.0))
