"""Distributed n-simplex filtering over a sharded apex table, on a device grid.

The apex table — n float32 per object — is split row-wise over the grid's
``data`` axis; queries are tiny and replicated (or split over ``replica``
groups, see ``repro_torch.sharding.rules``).  Each device:

  1. runs the two-sided bound filter over its row slice: one launch of K3
     (``apex_bounds_threshold``) with the exclusion band ``t_hi`` as its
     threshold, which keeps the rows with ``lwb <= t_hi`` ordered by
     (lwb, local row) — the reference's ``lax.top_k`` of ``-lwb`` — up to
     ``min(max_candidates, rows_local)`` of them, and counts them all;
  2. decides each kept row: ACCEPT where ``upb <= t_lo`` (f32 compare), else
     RECHECK; empty slots are -1 / EXCLUDE, padded back to
     ``max_candidates``;
  3. contributes its (Q, 3) decision histogram.  Where a query's count
     exceeds the slots, the accepted rows past them are not in K3's output:
     that column is completed from K1 (``apex_bounds_batch``) over the
     device's rows, for the overflowing queries only, in row tiles.

The grid is driven from one process, as the reference's ``shard_map`` is
from one controller: the ``psum`` of the histograms is a sum and the
``all_gather`` of the candidate slots a concatenation, both onto the grid's
first device.

On a ``ProcessMesh`` (one process per rank, ``make_process_mesh``) the
same body runs on each rank's card over its row slice of the table under
``P(table_axes, None)``: the histograms are all-reduced over the
``table_axes`` group and the globalised slots all-gathered in the
reference's row-major shard order, so every rank holds the step's whole
result; a rank on an axis outside ``table_axes`` holds its peers' rows and
computes their result.

``build_serve_step`` is the serving step of ``python -m
repro_torch.launch.serve``: it projects a block of query pivot distances
(K4, or Algorithm 2 as the ``"paper"`` baseline) and runs the filter.  The
row split of the table over the ``data`` axis is
``repro_torch.sharding.place_rows``.
"""

from __future__ import annotations

import torch

from repro_torch.core.bounds import ACCEPT, EXCLUDE, RECHECK
from repro_torch.core.simplex import apex_addition
from repro_torch.device import on_device
from repro_torch.kernels import (
    SENTINEL_ID,
    apex_bounds_batch,
    apex_bounds_threshold,
    apex_project,
)
from repro_torch.sharding.rules import DeviceGrid, ProcessMesh, place_rows, staged

__all__ = ["build_distributed_filter", "build_process_filter", "build_serve_step"]

#: elements of one (Q, rows) bound block of K1's row tiles: no (Q, N)
#: block is held (at 64 queries x 1M rows it would be 512 MB)
_TILE_ELEMS = 1 << 24


def _k1_tiles(table: torch.Tensor, queries: torch.Tensor):
    """(first row, lwb, upb) of each row tile of ``table`` through K1."""
    rows = max(1, _TILE_ELEMS // max(1, queries.shape[0]))
    for lo in range(0, table.shape[0], rows):
        lwb, upb = apex_bounds_batch(table[lo:lo + rows], queries)
        yield lo, lwb, upb


def _codes(lwb, upb, t_hi, t_lo):
    return torch.where(
        lwb > t_hi[:, None], EXCLUDE, torch.where(upb <= t_lo[:, None], ACCEPT, RECHECK)
    )


def _accepted(table, queries, t_hi, t_lo) -> torch.Tensor:
    """(Q,) rows with ``lwb <= t_hi`` and ``upb <= t_lo``, counted through
    K1 in row tiles."""
    acc = torch.zeros(queries.shape[0], dtype=torch.int64, device=table.device)
    for _, lwb, upb in _k1_tiles(table, queries):
        acc += ((lwb <= t_hi[:, None]) & (upb <= t_lo[:, None])).sum(dim=1)
    return acc


def _sort_select(table, queries, t_hi, t_lo, width: int):
    """The full-argsort selection: K1 bounds in row tiles, codes and the
    histogram per tile, and a running stable sort of ``where(code !=
    EXCLUDE, lwb, inf)`` that keeps the ``width`` smallest (key, row):
    the reference's ``selection="sort"`` baseline."""
    Q = queries.shape[0]
    dev = table.device
    hist = torch.zeros((Q, 3), dtype=torch.int64, device=dev)
    keys = torch.empty((Q, 0), dtype=torch.float32, device=dev)
    rows = torch.empty((Q, 0), dtype=torch.int64, device=dev)
    codes = torch.empty((Q, 0), dtype=torch.int64, device=dev)
    for lo, lwb, upb in _k1_tiles(table, queries):
        code = _codes(lwb, upb, t_hi, t_lo)
        for c in (EXCLUDE, RECHECK, ACCEPT):
            hist[:, c] += (code == c).sum(dim=1)
        tile_rows = torch.arange(lo, lo + lwb.shape[1], device=dev).expand(Q, -1)
        # earlier rows precede later ones in the concatenation, so a stable
        # sort keeps (key, row) order among equal keys
        keys = torch.cat([keys, torch.where(code != EXCLUDE, lwb, float("inf"))], dim=1)
        rows = torch.cat([rows, tile_rows], dim=1)
        codes = torch.cat([codes, code], dim=1)
        order = torch.sort(keys, dim=1, stable=True).indices[:, :width]
        keys, rows, codes = keys.gather(1, order), rows.gather(1, order), codes.gather(1, order)
    picked = codes != EXCLUDE
    return hist, torch.where(picked, rows, -1), torch.where(picked, codes, EXCLUDE)


def _threshold_select(table, queries, t_hi, t_lo, cap: int):
    """K3's selection: the up-to-``cap`` smallest (lwb, row) with
    ``lwb <= t_hi``, their codes, and the histogram (K1 completes the
    accepted column of the queries whose count overflows the slots)."""
    rows_local = table.shape[0]
    ids, _, upb, counts = apex_bounds_threshold(table, queries, t_hi, cap)
    kept = ids != SENTINEL_ID
    code = torch.where(kept, torch.where(upb <= t_lo[:, None], ACCEPT, RECHECK), EXCLUDE)
    counts = counts.to(torch.int64)
    accepted = (code == ACCEPT).sum(dim=1)
    over = torch.nonzero(counts > cap).flatten()
    if over.numel():
        accepted[over] = _accepted(table, queries[over], t_hi[over], t_lo[over])
    hist = torch.stack([rows_local - counts, counts - accepted, accepted], dim=1)
    return hist, torch.where(kept, ids.to(torch.int64), -1), code


def _local_filter(table, query, t_hi, t_lo, max_candidates: int, selection: str = "topk"):
    """Per-device filter and fixed-slot candidate packing.

    table: (rows_local, n) float32; query: (Q, n) float32; t_hi / t_lo: (Q,)
    float32 decision bands (exclude above t_hi, admit at or below t_lo).
    Returns (hist (Q, 3), cand_idx (Q, K) local rows or -1, cand_code
    (Q, K)), K = ``max_candidates``: a slice smaller than K clamps the
    selection width (every row fits) and pads back to K empty slots, so the
    gathered shape and the caller's overflow test are unchanged.

    ``selection="topk"`` is K3 at any width (the default, as the
    reference's ``lax.top_k``); ``"sort"`` is the full-argsort baseline
    (``_sort_select``).
    """
    k_eff = min(int(max_candidates), table.shape[0])
    if selection == "topk" and k_eff > 0:
        hist, idx, code = _threshold_select(table, query, t_hi, t_lo, k_eff)
    else:
        hist, idx, code = _sort_select(table, query, t_hi, t_lo, k_eff)
    pad = int(max_candidates) - k_eff
    if pad:
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        code = torch.nn.functional.pad(code, (0, pad), value=EXCLUDE)
    return hist, idx, code


def _bands(threshold, threshold_lo, eps: float, Q: int, device=None):
    """(t_hi, t_lo), each (Q,) float32 (on ``device`` when given): explicit
    bands, or t·(1±eps) ∓ 1e-9 from one threshold."""
    t = torch.as_tensor(threshold, dtype=torch.float32).reshape(-1)
    if threshold_lo is None:
        t_hi, t_lo = t * (1.0 + eps) + 1e-9, t * (1.0 - eps) - 1e-9
    else:
        t_hi, t_lo = t, torch.as_tensor(threshold_lo, dtype=torch.float32).reshape(-1)
    t_hi, t_lo = t_hi.expand(Q).contiguous(), t_lo.expand(Q).contiguous()
    return (t_hi, t_lo) if device is None else (t_hi.to(device), t_lo.to(device))


def _check_selection(selection: str) -> None:
    if selection not in ("topk", "sort"):
        raise ValueError(f"selection must be 'topk' or 'sort'; got {selection!r}")


def build_distributed_filter(
    mesh: DeviceGrid,
    *,
    table_axes=("data",),
    eps: float = 1e-5,
    max_candidates: int = 128,
    selection: str = "topk",
):
    """Returns filter_fn(table, queries, threshold[, threshold_lo]).

    table        : (N, n) float32, N a multiple of the ``data`` size; or its
                   ``place_rows(mesh, table)`` slices (placed once by a
                   caller that queries the same table again)
    queries      : (Q, n) float32 query apexes, replicated
    threshold    : scalar or (Q,).  With one threshold the decision bands are
                   derived from ``eps`` (t·(1±eps)); callers needing exact
                   fp32 guarantees pass explicit (t_hi, t_lo) bands instead.
    output       : hist (Q, 3) summed over ``data``; cand_idx (n_data, Q, K)
                   GLOBAL row ids (-1 = empty slot); cand_code same shape;
                   all on the grid's first device.

    Replica groups: a grid with a ``replica`` axis splits the QUERY stream
    over the groups while each group scans its own copy of the row
    partition.  Q must then be a multiple of the replica count (callers
    pad).
    """
    axes = tuple(table_axes) if isinstance(table_axes, (tuple, list)) else (table_axes,)
    if axes != ("data",):
        raise ValueError(f"the grid splits table rows over ('data',) only; got {axes}")
    _check_selection(selection)
    K = int(max_candidates)
    out_dev = mesh.devices[0][0]

    def filter_fn(table, queries, threshold, threshold_lo=None):
        placed = table if isinstance(table, tuple) else place_rows(mesh, table)
        R = len(mesh.devices)
        Q = queries.shape[0]
        if Q % R:
            raise ValueError(f"{Q} queries do not split over {R} replica groups; pad them")
        t_hi, t_lo = _bands(threshold, threshold_lo, eps, Q)
        qr = Q // R
        hist_parts, idx_parts, code_parts = [], [], []
        for r, group in enumerate(mesh.devices):
            rows = slice(r * qr, (r + 1) * qr)
            hist_r, idx_r, code_r = None, [], []
            for j, dev in enumerate(group):
                local = placed[r][j]
                with on_device(dev):
                    h, idx, code = _local_filter(
                        local, queries[rows].to(dev), t_hi[rows].to(dev), t_lo[rows].to(dev), K, selection
                    )
                    # globalise local row ids: offset by this slice's first row
                    idx = torch.where(idx >= 0, idx + j * local.shape[0], -1)
                h = h.to(out_dev)
                hist_r = h if hist_r is None else hist_r + h
                idx_r.append(idx.to(out_dev))
                code_r.append(code.to(out_dev))
            hist_parts.append(hist_r)
            idx_parts.append(torch.stack(idx_r))
            code_parts.append(torch.stack(code_r))
        return torch.cat(hist_parts), torch.cat(idx_parts, dim=1), torch.cat(code_parts, dim=1)

    return filter_fn


def build_process_filter(
    mesh: ProcessMesh,
    *,
    table_axes=("data",),
    eps: float = 1e-5,
    max_candidates: int = 128,
    selection: str = "topk",
):
    """Returns filter_fn(table, queries, threshold[, threshold_lo]) on this
    rank of ``mesh``, the reference's ``_shard_fn`` on its own card.

    table     : (N / n_shards, n) float32, this rank's slice of the table
                under ``P(table_axes, None)`` (``NamedSharding.place``),
                on the rank's device
    queries   : (Q, n) float32 query apexes, replicated
    threshold : as ``build_distributed_filter``'s
    output    : hist (Q, 3) summed over the ``table_axes`` group; cand_idx,
                cand_code (n_shards, Q, K): the shards' GLOBAL row ids
                (-1 = empty slot) and codes in the reference's row-major
                shard order; the same on every rank of the group.

    A collective: every rank of the ``table_axes`` group calls it with the
    same queries and thresholds."""
    table_axes = (table_axes,) if isinstance(table_axes, str) else tuple(table_axes)
    axes = tuple(a for a in mesh.axis_names if a in table_axes)
    if not axes or set(axes) != set(table_axes):
        raise ValueError(f"table_axes {tuple(table_axes)} are not all in the mesh's {mesh.axis_names}")
    _check_selection(selection)
    K = int(max_candidates)

    def filter_fn(table, queries, threshold, threshold_lo=None):
        dev = mesh.device
        t_hi, t_lo = _bands(threshold, threshold_lo, eps, queries.shape[0], dev)
        with on_device(dev):
            hist, idx, code = _local_filter(table, queries.to(dev), t_hi, t_lo, K, selection)
        # globalise local row ids: offset by this shard's first row
        idx = torch.where(idx >= 0, idx + mesh.axis_index(axes) * table.shape[0], -1)
        # the collectives run over a group of one too (a world of one on one
        # card takes the same path as many)
        n, group = mesh.axis_size(axes), mesh.group(axes)
        torch.distributed.all_reduce(hist, group=group)
        gathered = []
        for part in (idx, code):
            out = part.new_empty((n * part.shape[0],) + tuple(part.shape[1:]))
            out = staged(torch.distributed.all_gather_into_tensor, out, part.contiguous(), group)
            gathered.append(out.reshape((n,) + tuple(part.shape)))
        return (hist, *gathered)

    return filter_fn



def build_serve_step(
    mesh: DeviceGrid,
    *,
    n_pivots: int,
    eps: float = 1e-5,
    max_candidates: int = 128,
    table_axes=("data",),
    projection: str = "gemm",
    selection: str = "topk",
):
    """Serving step for the paper's own configuration: returns
    ``serve_step(table, Linv, sq_norms, sigma, qdists, threshold)`` ->
    ``(hist (Q, 3), cand_idx, cand_code (n_data, Q, K))`` on the grid's
    first device, as ``build_distributed_filter`` gives them.  On a
    ``ProcessMesh`` every rank projects the replicated query block on its
    card and runs ``build_process_filter`` over its slice of the table
    (rows over ``table_axes``).

    table    : (N, n) float32 apexes (or their ``place_rows`` slices)
    Linv, sq_norms, sigma : the fitted projector's (n-1, n-1), (n-1,) and
               (n, n-1) arrays, float32 on the grid's first device
    qdists   : (Q, n) float32 query-to-pivot distances there

    projection: ``"gemm"`` projects the block with K4 (``apex_project``,
    the three steps of the GEMM form in one launch) or ``"paper"`` with
    Algorithm 2 (``apex_addition``, the sequential baseline).
    selection: ``"topk"`` (K3) or ``"sort"`` (K1 and a stable sort)."""
    if projection not in ("gemm", "paper"):
        raise ValueError(f"projection must be 'gemm' or 'paper'; got {projection!r}")
    build = build_process_filter if isinstance(mesh, ProcessMesh) else build_distributed_filter
    filter_fn = build(mesh, eps=eps, max_candidates=max_candidates, table_axes=table_axes, selection=selection)

    def serve_step(table, Linv, sq_norms, sigma, qdists, threshold):
        if qdists.ndim != 2 or qdists.shape[1] != n_pivots:
            raise ValueError(f"need (Q, {n_pivots}) query pivot distances; got {tuple(qdists.shape)}")
        if projection == "paper":
            queries = apex_addition(sigma, qdists)
        else:
            queries = apex_project(qdists, Linv, sq_norms)
        return filter_fn(table, queries, threshold)

    return serve_step
