"""Distortion measurement (paper §5) on the device.

The distortion of an approximation (U', d') of (U, d) under f is the
smallest D such that, for some scaling r,
``r·d'(f(ui), f(uj)) <= d(ui, uj) <= D·r·d'(f(ui), f(uj))``.  Over sampled
pairs with ratios ``q_ij = d(ui, uj) / d'(f(ui), f(uj))`` the best r is
``min(q)`` and ``D = max(q) / min(q)``.

The pairs are drawn on the host with the same ``np.random.default_rng(seed)``
calls as the JAX package, so both packages measure the same pairs; the
distances are float64 on the rows' device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["distortion_from_ratios", "pair_distances", "measure_distortion"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64).ravel()


def distortion_from_ratios(true_d, approx_d) -> float:
    """``max(q) / min(q)`` of the ratios ``true / approx`` over the pairs
    where both distances exceed 1e-12 (inf when there is none).  Takes
    arrays or tensors; computed in float64 numpy."""
    true_d, approx_d = _host(true_d), _host(approx_d)
    mask = (true_d > 1e-12) & (approx_d > 1e-12)
    if not np.any(mask):
        return np.inf
    q = true_d[mask] / approx_d[mask]
    return float(q.max() / q.min())


def pair_distances(metric, A: torch.Tensor, B: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """(P,) float64 row-wise distances ``d(A[p], B[p])`` on ``A``'s device,
    ``chunk`` rows at a time (``metric.dist`` on row blocks: no cross)."""
    A = torch.as_tensor(A).to(torch.float64)
    B = torch.as_tensor(B, device=A.device).to(torch.float64)
    out = torch.empty(A.shape[0], dtype=torch.float64, device=A.device)
    for lo in range(0, A.shape[0], chunk):
        hi = min(lo + chunk, A.shape[0])
        out[lo:hi] = metric.dist(A[lo:hi], B[lo:hi])
    return out


def sample_pairs(n_rows: int, n_pairs: int, seed: int):
    """The (i, j) row pairs ``measure_distortion`` uses: ``n_pairs`` draws
    of each index, the pairs with ``i == j`` dropped."""
    rng = np.random.default_rng(seed)
    i = rng.integers(0, n_rows, size=n_pairs)
    j = rng.integers(0, n_rows, size=n_pairs)
    keep = i != j
    return i[keep], j[keep]


def measure_distortion(metric, X, f, n_pairs: int = 20000, seed: int = 0, *, device="cuda"):
    """Distortion of the batched map ``f`` (tensor -> tensor, compared with
    l2) with respect to ``metric`` on sampled pairs of the rows of ``X``,
    on ``device`` (X's own device when X is a tensor).

    Returns (D, true distances, approximate distances), the last two as
    float64 tensors on that device.
    """
    if isinstance(X, torch.Tensor):
        Xt = X
    else:
        Xt = torch.as_tensor(np.asarray(X), device=resolve_device(device))
    i, j = sample_pairs(Xt.shape[0], n_pairs, seed)
    it = torch.as_tensor(i, device=Xt.device)
    jt = torch.as_tensor(j, device=Xt.device)
    Xp = torch.as_tensor(f(Xt), device=Xt.device).to(torch.float64)
    true_d = pair_distances(metric, Xt[it], Xt[jt])
    diff = Xp[it] - Xp[jt]
    approx_d = torch.sqrt(torch.clamp_min((diff * diff).sum(dim=1), 0.0))
    return distortion_from_ratios(true_d, approx_d), true_d, approx_d
