"""Dimensionality-reduction baselines the paper compares against (Fig. 2),
in float64 on the device.

* PCA  — coordinate space only (Euclidean); the paper's upper baseline.
* JL   — a Gaussian random projection (Johnson-Lindenstrauss).
* LMDS — Landmark MDS (de Silva & Tenenbaum 2004): classical MDS on k
         landmarks, then distance-based triangulation of every other row;
         the only other mechanism for general metric spaces.

Each returns a batched map, tensor -> (B, k) float64 tensor on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["pca_project", "jl_project", "LandmarkMDS"]


def _f64(A, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(A) if not isinstance(A, torch.Tensor) else A,
                           device=device).to(torch.float64)


def pca_project(X, k: int, *, fit_on=None, device="cuda"):
    """f: batch -> (B, k), the projection onto the top-k principal
    components of ``fit_on`` (default ``X``), fitted by one thin SVD."""
    device = resolve_device(device)
    F = _f64(fit_on if fit_on is not None else X, device)
    mu = F.mean(dim=0)
    _, _, Vt = torch.linalg.svd(F - mu, full_matrices=False)
    comps = Vt[:k]

    def f(A):
        return (_f64(A, device) - mu) @ comps.T

    return f


def jl_project(dim: int, k: int, seed: int = 0, *, device="cuda"):
    """f: batch -> (B, k), ``A @ R`` with ``R ~ N(0, 1/k)`` of shape
    (dim, k), drawn on the host with the JAX package's generator calls
    (bit-equal) and moved to ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    R = torch.as_tensor(rng.normal(size=(dim, k)) / np.sqrt(k), device=device)

    def f(A):
        return _f64(A, device) @ R

    return f


class LandmarkMDS:
    """Classical MDS on k landmarks plus triangulation (distance-only
    access): ``out_dim`` coordinates per row from its distances to the
    landmarks, measured with one ``metric.cross`` per block."""

    def __init__(self, landmarks, metric, out_dim: int, *, device="cuda"):
        device = resolve_device(device)
        self.metric = metric
        self.landmarks = _f64(landmarks, device)
        k = self.landmarks.shape[0]
        D2 = metric.cross(self.landmarks, self.landmarks) ** 2
        J = torch.eye(k, dtype=torch.float64, device=device) - 1.0 / k
        B = -0.5 * J @ D2 @ J
        w, V = torch.linalg.eigh(B)
        order = torch.argsort(w, descending=True)[:out_dim]
        sqrt_w = torch.sqrt(torch.clamp_min(w[order], 1e-12))
        self._sqrt_w = sqrt_w                  # (m,)
        self._pinv = V[:, order] / sqrt_w      # (k, m): L^# transposed
        self._mean_d2 = D2.mean(dim=0)         # (k,)

    def __call__(self, A) -> torch.Tensor:
        d2 = self.metric.cross(_f64(A, self.landmarks.device), self.landmarks) ** 2
        return -0.5 * (d2 - self._mean_d2) @ self._pinv
