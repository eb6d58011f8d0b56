"""Approximate search from two-sided surrogate bounds (truncated surrogates).

Both table mechanisms reduce approximate search to the dual of the exact
skeleton in ``repro_torch.index.knn``: every row has a cheap lower bound
``lwb[i] <= d(q, x_i) <= upb[i]`` measured in a TRUNCATED surrogate space
(k of n apex dimensions or pivot columns), and the ``(lwb + upb) / 2``
mean-point estimate (the estimator the paper recommends, with about half
the distortion of either bound alone) ranks rows without touching the
original space.

* ``approx_knn_from_pairs`` : the device top-k kernel has already ranked
  the rows by the mean estimate and delivered the ``refine`` best (the
  n-simplex path); spend the budget of true-metric evaluations on them and
  return the exact top-k of that candidate set.
* ``approx_knn_from_est`` / ``approx_knn_from_bounds`` : the same from an
  (N,) estimate or (N,) bound pair on the index's device (the LAESA path):
  the ``refine`` rows of smallest estimate are selected there.  ``dims``
  and ``refine`` are two independent quality dials.
* ``approx_search_decide`` / ``approx_search_from_bounds`` : threshold
  search that stays SOUND on both bound sides (``upb <= t`` admits and
  ``lwb > t`` excludes exactly as in the exact filter) and is approximate
  only for the straddlers: the ``refine`` least-confident of them (mean
  estimate closest to the threshold) are verified in the original space,
  the rest are decided by the estimate alone.  ``refine >= #straddlers``
  is exact.

All report the achieved bound width (mean ``upb - lwb`` over the rows the
decision actually hinged on), which the index surfaces in
``QueryStats.bound_width``: the observable quality signal that shrinks as
``dims`` grows.

The JAX package's ``repro.index.approx``: the decisions are host numpy
control flow as there; the ``*_from_est`` / ``*_from_bounds`` forms take
tensors and select on their device, and hand the host only the selected
rows.  The distance oracle ``dist_fn`` may run on any device and returns
host float64 distances.  Rows tied at the m-th smallest estimate are taken
by ascending id; the JAX package's ``np.argpartition`` takes an arbitrary
subset of them.  LAESA's estimates tie often: where one pivot column sets
both bounds of a row, its estimate is ``max(qd_j, T[x, j])``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.index.knn import knn_select

__all__ = [
    "approx_knn_from_bounds",
    "approx_knn_from_est",
    "approx_knn_from_pairs",
    "approx_search_decide",
    "approx_search_from_bounds",
]


def approx_knn_from_pairs(
    dist_fn: Callable[[np.ndarray], np.ndarray],
    cand_ids: np.ndarray,
    cand_lwb: np.ndarray,
    cand_upb: np.ndarray,
    k: int,
) -> Tuple[np.ndarray, np.ndarray, int, float]:
    """Approximate k-NN from an ALREADY-SELECTED candidate set.

    The fused-epilogue entry point: a device top-k kernel (or host fused
    scan) has already ranked the table by the mean-point estimate and
    delivered the ``refine`` best rows as (id, lwb, upb) triples — no (N,)
    estimate array exists.  This just spends the true-metric budget on them
    and returns the exact top-k of the candidate set.

    Returns (ids, distances, n_evaluated, band_width): the approximate k
    nearest ids sorted by (true distance, id), their true distances, the
    evaluation count spent, and the mean bound width over the candidates.
    """
    cand_ids = np.asarray(cand_ids, dtype=np.int64)
    k = min(int(k), cand_ids.shape[0])
    if k <= 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64), 0, 0.0
    d = np.asarray(dist_fn(cand_ids), dtype=np.float64)
    ids, dists = knn_select(d, cand_ids, k)
    width = float(np.mean(np.asarray(cand_upb) - np.asarray(cand_lwb)))
    return ids, dists, int(cand_ids.shape[0]), width


def approx_knn_from_est(
    dist_fn: Callable[[np.ndarray], np.ndarray],
    est: torch.Tensor,
    k: int,
    refine: int,
    width_fn: Callable[[torch.Tensor], float] = None,
) -> Tuple[np.ndarray, np.ndarray, int, float]:
    """Approximate k-NN from an (N,) mean-point estimate tensor: the
    ``m = min(max(refine, k), N)`` rows of smallest estimate are selected on
    its device (ties by ascending id), measured with ``dist_fn`` and ranked
    exactly.  ``width_fn``
    maps the candidate rows (a tensor on ``est``'s device) to the achieved
    band width.

    Returns (ids, distances, n_evaluated, band_width) as
    ``approx_knn_from_pairs``.
    """
    N = est.shape[0]
    k = min(int(k), N)
    if k <= 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64), 0, 0.0
    m = min(max(int(refine), k), N)
    cand_t = torch.sort(est, stable=True).indices[:m]
    cand = cand_t.cpu().numpy().astype(np.int64)
    d = np.asarray(dist_fn(cand), dtype=np.float64)
    ids, dists = knn_select(d, cand, k)
    width = float(width_fn(cand_t)) if width_fn is not None else 0.0
    return ids, dists, int(m), width


def approx_knn_from_bounds(
    dist_fn: Callable[[np.ndarray], np.ndarray],
    lwb: torch.Tensor,
    upb: torch.Tensor,
    k: int,
    refine: int,
) -> Tuple[np.ndarray, np.ndarray, int, float]:
    """Approximate k-NN: mean-estimate ranking of (N,) truncated-surrogate
    bound tensors plus an exact re-rank of the top ``refine`` (clamped to
    [k, N]).  Returns (ids, distances, n_evaluated, band_width), the width
    the mean ``upb - lwb`` over the refined candidates."""
    return approx_knn_from_est(
        dist_fn,
        0.5 * (lwb + upb),
        k,
        refine,
        width_fn=lambda cand: float(torch.mean(upb[cand] - lwb[cand])),
    )


def approx_search_decide(
    dist_fn: Callable[[np.ndarray], np.ndarray],
    accepted: np.ndarray,
    straddle: np.ndarray,
    lwb_s: np.ndarray,
    upb_s: np.ndarray,
    threshold: float,
    refine: int,
) -> Tuple[np.ndarray, int, int, int, float]:
    """Decide an approximate threshold query given its straddle band.

    ``accepted`` rows were admitted by the upper bound (sound); ``straddle``
    rows carry their bounds in ``lwb_s`` / ``upb_s``.  The ``refine``
    least-confident straddlers (mean estimate closest to t) are verified in
    the original space; the rest are decided by the estimate alone.

    Returns (ids, n_evaluated, n_bound_only, n_candidates, band_width).
    """
    t = float(threshold)
    n_candidates = int(len(accepted) + len(straddle))
    width = float(np.mean(upb_s - lwb_s)) if len(straddle) else 0.0
    est = 0.5 * (lwb_s + upb_s)
    # least confident first: the estimate says the least about rows whose
    # mean bound sits closest to the threshold
    order = np.argsort(np.abs(est - t), kind="stable")
    r = min(max(int(refine), 0), len(straddle))
    checked, guessed = straddle[order[:r]], straddle[order[r:]]
    if len(checked):
        d = np.asarray(dist_fn(checked), dtype=np.float64)
        confirmed = checked[d <= t]
    else:
        confirmed = np.empty(0, dtype=np.int64)
    kept_guess = guessed[est[order[r:]] <= t]
    ids = np.sort(np.concatenate([accepted, confirmed, kept_guess]))
    n_bound_only = int(len(accepted) + len(kept_guess))
    return ids.astype(np.int64), int(r), n_bound_only, n_candidates, width



def approx_search_from_bounds(
    dist_fn: Callable[[np.ndarray], np.ndarray],
    lwb: torch.Tensor,
    upb: torch.Tensor,
    threshold: float,
    refine: int,
) -> Tuple[np.ndarray, int, int, int, float]:
    """Approximate threshold search over (N,) truncated-surrogate bound
    tensors, sound outside the straddle band: the admitted rows
    (``upb <= t``) and the straddlers (``lwb <= t < upb``) are found on the
    bounds' device, ascending, and ``approx_search_decide`` decides them.

    Returns (ids, n_evaluated, n_bound_only, n_candidates, band_width).
    """
    t = float(threshold)
    accepted = torch.nonzero(upb <= t).flatten()
    straddle = torch.nonzero((lwb <= t) & (upb > t)).flatten()
    lwb_s, upb_s = lwb[straddle], upb[straddle]
    return approx_search_decide(
        dist_fn,
        accepted.cpu().numpy().astype(np.int64),
        straddle.cpu().numpy().astype(np.int64),
        lwb_s.cpu().numpy(),
        upb_s.cpu().numpy(),
        t,
        refine,
    )
