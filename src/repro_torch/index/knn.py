"""Exact k-NN refinement over per-row distance bounds (host control flow).

  1. every row has a lower bound ``lwb[i] <= d(q, x_i)`` and an upper bound
     ``d(q, x_i) <= upb[i]``;
  2. the k-th smallest upper bound is a sound initial radius;
  3. candidates are scanned in ascending-``lwb`` order and the true metric
     is evaluated in chunks; each chunk can only shrink the running k-th
     distance, and the scan stops at the first chunk whose smallest ``lwb``
     exceeds it.

Ties are broken by id everywhere (selection by ``(distance, id)``), so
results equal the brute-force oracle ``np.lexsort((ids, distances))[:k]``.
The distance oracle ``dist_fn`` may run on any device; it returns host
float64 distances.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

__all__ = ["knn_refine", "knn_refine_candidates", "knn_select"]

#: rows evaluated per refinement chunk; ``QueryStats.original_calls``
#: depends on it, so it matches the JAX package's value
_REFINE_CHUNK = 256


def knn_select(distances: np.ndarray, ids: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k by (distance, id) lexicographic order — the tie-stable oracle."""
    order = np.lexsort((ids, distances))[:k]
    return ids[order], distances[order]


def knn_refine(
    dist_fn: Callable[[np.ndarray], np.ndarray],
    lwb: np.ndarray,
    upb: np.ndarray,
    k: int,
    *,
    slack: float = 0.0,
    rel_slack: float = 0.0,
    radius_cap: float | None = None,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Exact k nearest rows given (N,) bounds and a true-distance oracle.

    ``slack`` widens every pruning comparison absolutely, ``rel_slack``
    relative to the initial radius; ``radius_cap`` is an external sound cap
    on any result distance (the result is then the exact top-k restricted
    to ``d <= radius_cap``).

    Returns (ids, distances, n_evaluated, n_candidates).
    """
    N = lwb.shape[0]
    k = min(int(k), N)
    if k <= 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, np.empty(0, dtype=np.float64), 0, 0
    r0 = float(np.partition(upb, k - 1)[k - 1])
    if radius_cap is not None:
        r0 = min(r0, float(radius_cap))
    slack = slack + rel_slack * r0
    radius = r0 + slack
    cand = np.where(lwb <= radius)[0]
    n_candidates = int(cand.shape[0])
    cand = cand[np.argsort(lwb[cand], kind="stable")]
    ids, dists, n_eval = knn_refine_candidates(dist_fn, cand, lwb[cand], k, radius, slack)
    return ids, dists, n_eval, n_candidates


def knn_refine_candidates(
    dist_fn: Callable[[np.ndarray], np.ndarray],
    cand_ids: np.ndarray,
    cand_lwb: np.ndarray,
    k: int,
    radius: float,
    slack: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """The shrinking-radius loop over candidates already sorted ascending
    by ``(lwb, id)``.  Returns (ids, distances, n_evaluated)."""
    cand_ids = np.asarray(cand_ids, dtype=np.int64)
    best_ids = np.empty(0, dtype=np.int64)
    best_d = np.empty(0, dtype=np.float64)
    n_eval = 0
    for lo in range(0, cand_ids.shape[0], _REFINE_CHUNK):
        chunk = slice(lo, lo + _REFINE_CHUNK)
        lwb_c = cand_lwb[chunk]
        if lwb_c[0] > radius:
            break                                   # ascending lwb: all done
        live = cand_ids[chunk][lwb_c <= radius]     # radius may have shrunk
        d = np.asarray(dist_fn(live), dtype=np.float64)
        n_eval += int(live.shape[0])
        best_ids = np.concatenate([best_ids, live])
        best_d = np.concatenate([best_d, d])
        if best_d.shape[0] >= k:
            # select even at exactly k: the shrink needs the k-th distance
            best_ids, best_d = knn_select(best_d, best_ids, k)
            radius = min(radius, float(best_d[-1]) + slack)
    ids, dists = knn_select(best_d, best_ids, k)
    return ids, dists, n_eval
