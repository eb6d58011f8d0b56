"""What a walkthrough returns, and how it is held to the reference's run.

A summary is a dict of five sections:

  exact    ids, result / live / shard counts, WAL records, plan stages,
           grid shapes, steps: equal to the reference's;
  close    f64 values (distances, thresholds, losses): within ``RTOL`` of
           the reference's, relative to the larger magnitude;
  counts   what hangs on f32 bound roundings (metric evaluations,
           bound-only admits, rechecks, pruned rows, K6 decisions): within
           the run's own margin of the reference's;
  margins  for each count, how far it may move: the decisions of the run
           whose f64 bound lies inside the f32 slack band (``f32_band``) of
           the value it is decided against.  A decision outside that band
           comes out the same in the reference's f32, in the port's plain
           versions and in the kernels, whatever order each rounds in.  For
           an exact per-query field, the queries whose answer hangs on
           such a decision (left out of the comparison);
  seconds  wall times and what hangs on them (QPS, a timed stream's
           batches, the requests a deadline shed), never compared.

``reference_summaries.json`` holds the reference's sections for each
walkthrough, with the flags it ran under; the CPU tests keep it equal to a
fresh run of the JAX package's scripts.  For ``BRIDGED`` walkthroughs the
close and count sections hold only for the reference's own parameters
carried across (``repro_torch.models.convert.from_reference``): a run that
initialises its own parameters is held to the exact section alone.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["BRIDGED", "REFERENCE_PATH", "RTOL", "compare", "approx_knn_margin", "approx_range_margin", "f32_band", "host_bounds", "knn_margin", "load_reference",
           "near", "parse", "range_margin", "summary"]

REFERENCE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference_summaries.json")

#: walkthroughs whose close and count sections need the reference's parameters
BRIDGED = ("retrieval_recsys", "train_lm")

#: relative tolerance of each close field: f64 distances and thresholds
#: 1e-12; losses 1e-5 of their magnitude (f32 forward and AdamW); the drift
#: statistic 1e-5 (the reference measures its witnesses in f32).  A field
#: named ``*_f32`` was measured on an f32 corpus, in f32 as the reference's
#: Euclidean measures it: 1e-6, a few f32 ulps
RTOL = {"losses": 1e-5, "drift_stat": 1e-5}
DEFAULT_RTOL, F32_RTOL = 1e-12, 1e-6

_EPS32 = float(np.finfo(np.float32).eps)


def parse(parser: argparse.ArgumentParser, argv: Optional[Sequence[str]]):
    """(args, torch.device): ``parser`` plus ``--device`` (``cuda`` by
    default, resolved through ``repro_torch.device.resolve_device``, which
    raises without a card)."""
    from repro_torch.device import resolve_device

    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return args, resolve_device(args.device)


def summary(**sections) -> dict:
    """A summary with every section present."""
    out = {k: {} for k in ("exact", "close", "counts", "margins", "seconds")}
    for k, v in sections.items():
        if k not in out:
            raise KeyError(f"unknown summary section {k!r}")
        out[k] = dict(v)
    return out


def load_reference(path: str = REFERENCE_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def _close(got, want, rtol: float) -> bool:
    g, w = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    if g.shape != w.shape:
        return False
    return bool(np.all(np.abs(g - w) <= rtol * np.maximum(np.abs(g), np.abs(w))))


def _jsonable(v):
    return json.loads(json.dumps(v))


def compare(got: dict, want: dict, *, sections=("exact", "close", "counts")) -> list:
    """The differences of summary ``got`` from the reference's ``want``
    (empty when they agree): exact fields equal (after a JSON round trip,
    so tuples read as lists; a per-query field but for ``got``'s unsettled
    queries), close fields within ``RTOL``, counts within ``got``'s margins
    (0 where a count has none)."""
    bad = []
    for section in sections:
        for key, w in want.get(section, {}).items():
            if key not in got.get(section, {}):
                bad.append(f"{section}.{key}: missing")
                continue
            g = got[section][key]
            if section == "exact":
                g, w = _jsonable(g), _jsonable(w)
                unsettled = got.get("margins", {}).get(key, ())
                if unsettled and len(g) == len(w):
                    g, w = ([v for i, v in enumerate(x) if i not in unsettled] for x in (g, w))
                ok = g == w
            elif section == "close":
                ok = _close(g, w, RTOL.get(key, F32_RTOL if key.endswith("_f32") else DEFAULT_RTOL))
            else:
                gi, wi = np.asarray(g, dtype=np.int64), np.asarray(w, dtype=np.int64)
                m = np.asarray(got.get("margins", {}).get(key, 0), dtype=np.int64)
                ok = gi.shape == wi.shape and bool(np.all(np.abs(gi - wi) <= m))
            if not ok:
                bad.append(f"{section}.{key}: got {g!r}, reference {w!r}"
                           + (f" (margin {got['margins'].get(key, 0)!r})" if section == "counts" else ""))
    return bad


# -- margins -----------------------------------------------------------------------
def f32_band(table: torch.Tensor, apexes: torch.Tensor, t) -> np.ndarray:
    """(Q,) half-widths of the band around a distance ``t`` (scalar or
    (Q,)) inside which an f32 bound of the table against each query apex
    may fall on either side of ``t``: the f32 scan's squared-domain error
    ``4 (n + 8) eps32 (|x|² + |q|²)`` (the bound ``NSimplexIndex`` widens
    its kernel bounds by) mapped through d ≈ err / (2 t), plus the f32 cast
    of the coordinates.  ``table`` (N, n) and ``apexes`` (Q, n) are f64."""
    row_sq = float((table * table).sum(dim=1).max()) if table.shape[0] else 0.0
    q_sq = (apexes * apexes).sum(dim=1).cpu().numpy()
    n = table.shape[1]
    err_sq = 4.0 * (n + 8) * _EPS32 * (row_sq + q_sq)
    t = np.broadcast_to(np.asarray(t, dtype=np.float64), q_sq.shape)
    cast = 4.0 * _EPS32 * (np.sqrt(row_sq) + np.sqrt(q_sq))
    return err_sq / (2.0 * np.maximum(t, 1e-12)) + cast


def host_bounds(inner, queries, dims=None):
    """(table, apexes, lwb, upb) of an ``NSimplexIndex`` segment on the
    host in f64: its apex table (truncated to ``dims``), the queries'
    apexes and their exact bounds (the plain version, for margins only)."""
    from repro_torch.kernels.ref import apex_bounds_batch_ref

    table = (inner.table if dims is None else inner.truncated_table(dims)).double().cpu()
    apexes = inner.query_apex_batch(queries, dims=dims).double().cpu()
    lwb, upb = apex_bounds_batch_ref(table, apexes, table.shape[1])
    return table, apexes, lwb, upb


def range_margin(inner, queries, t) -> int:
    """Range decisions near ``t``: entries whose f64 lower or upper bound
    lies within the f32 band of ``t``."""
    table, apexes, lwb, upb = host_bounds(inner, queries)
    band = f32_band(table, apexes, t)
    return near(lwb, t, band) + near(upb, t, band)


def knn_margin(inner, queries, kth_distance, k: int) -> int:
    """Exact k-NN decisions near their radius: entries whose f64 lower bound
    lies within the f32 band of the query's k-th distance (where the
    refinement stops) or of its k-th upper bound (the first radius)."""
    table, apexes, lwb, upb = host_bounds(inner, queries)
    kth_upb = torch.kthvalue(upb, min(k, upb.shape[1]), dim=1).values.numpy()
    d_k = np.asarray(kth_distance, dtype=np.float64)
    return near(lwb, d_k, f32_band(table, apexes, d_k)) + near(lwb, kth_upb, f32_band(table, apexes, kth_upb))


def approx_knn_margin(inner, queries, dims: int, refine: int) -> int:
    """Approximate k-NN candidates near the cut: entries whose f64 mean
    estimate lies within the f32 band of the query's ``refine``-th smallest
    estimate (which rows are re-ranked)."""
    table, apexes, lwb, upb = host_bounds(inner, queries, dims)
    mid = 0.5 * (lwb + upb)
    cut = torch.kthvalue(mid, min(refine, mid.shape[1]), dim=1).values.numpy()
    return near(mid, cut, f32_band(table, apexes, cut))


def approx_range_margin(inner, queries, t, dims: int) -> int:
    """Approximate range decisions near ``t``: entries whose f64 lower
    bound, upper bound or mean estimate lies within the f32 band of ``t``."""
    table, apexes, lwb, upb = host_bounds(inner, queries, dims)
    band = f32_band(table, apexes, t)
    return near(lwb, t, band) + near(upb, t, band) + near(0.5 * (lwb + upb), t, band)


def near(values: torch.Tensor, t, band: np.ndarray) -> int:
    """How many entries of the (Q, N) f64 ``values`` lie within ``band[q]``
    of ``t`` (scalar or (Q,))."""
    v = values.double().cpu()
    tq = torch.as_tensor(np.broadcast_to(np.asarray(t, dtype=np.float64), band.shape).copy())[:, None]
    return int(((v - tq).abs() <= torch.as_tensor(band)[:, None]).sum())
