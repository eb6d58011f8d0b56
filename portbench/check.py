"""How ``correct`` is decided: the served answers against the plain reference.

Once the window has closed, the answers of the timed path (every one, or a
sample drawn from the seed when there are more than the mix's
``check_sample``) are held to the reference worked out from the same corpus
and queries.  Each compared number has its limit in ``limits/<cell>.json``;
the run is correct when no number passes its limit.

Numbers (a gap is relative to the reference's float64 distance):

* ``failed``       requests that raised or never came (limit 0);
* ``short``        k-NN answers with other than k ids (limit 0);
* ``order``        answers not by (distance, id) or with a repeated id
                   (limit 0);
* ``dist_gap``     widest gap between a served distance and the reference's
                   distance of the same id;
* ``set_gap``      widest gap between the i-th served and the i-th true
                   neighbour's distance.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["compare", "sample_positions"]

_TINY = 1e-12


def sample_positions(n: int, limit: int, seed: int) -> np.ndarray:
    """All of ``range(n)``, or ``limit`` of them drawn from the seed."""
    if n <= limit:
        return np.arange(n)
    return np.sort(np.random.default_rng([int(seed), 7]).choice(n, size=limit, replace=False))


def _order_faults_knn(ids: np.ndarray, d: np.ndarray) -> bool:
    if len(np.unique(ids)) != len(ids):
        return True
    for i in range(len(ids) - 1):
        if d[i] > d[i + 1] or (d[i] == d[i + 1] and ids[i] > ids[i + 1]):
            return True
    return False


def _gap(a: np.ndarray, b: np.ndarray) -> float:
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), _TINY)))


def compare(mix: dict, queries: np.ndarray, answers: Dict[int, tuple], n_failed: int, ref) -> Dict[str, float]:
    """The compared numbers of one run of an exact k-NN mix.  ``answers``:
    pool position -> (ids, distances) of the answers to compare; ``ref`` the
    float64 ``Reference`` over the corpus."""
    pos = sorted(answers)
    qs = queries[pos]
    k = int(mix["k"])
    short = order = 0
    served_ids, served_d = [], []
    for ids, d in (answers[p] for p in pos):
        ids, d = np.asarray(ids, dtype=np.int64), np.asarray(d, dtype=np.float64)
        short += int(ids.size != k)
        order += int(_order_faults_knn(ids, d))
        served_ids.append(ids)
        served_d.append(d)
    d64 = ref.distances(qs, served_ids)
    _, want_d = ref.knn(qs, k)
    gaps = [_gap(np.sort(r)[:k], w[: r.size]) if r.size == k else np.inf for r, w in zip(d64, want_d)]
    return {"failed": float(n_failed), "short": float(short), "order": float(order),
            "dist_gap": max((_gap(s, r) for s, r in zip(served_d, d64)), default=0.0),
            "set_gap": max(gaps, default=0.0)}
