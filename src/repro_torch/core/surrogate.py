"""NSimplexProjector — the paper's φ_n as a fitted map on one device.

Fit once on ``n`` pivots (the n(n-1)/2 inter-pivot distances measured with
the original metric in float64, the simplex built on the host), then
project any batch of pivot distances into the apex space ``(R^n, l2)`` in
float64 on the projector's device.  Three projection modes, equal up to
rounding (the tests hold them to each other):

  * ``mode="gemm"``  — one product against ``L⁻¹``, the kernel K4
    (``repro_torch.kernels.apex_project``; its plain version on the CPU).
    The default, and the only mode the indexes use.
  * ``mode="paper"`` — Algorithm 2 row by row (``simplex.apex_addition``).
  * ``mode="solve"`` — one batched triangular solve (``simplex.apex_solve``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import simplex as _sx
from repro_torch.device import resolve_device
from repro_torch.kernels import apex_project
from repro_torch.kernels.ops import _apex_project_vector
from repro_torch.metrics import Metric

__all__ = ["NSimplexProjector", "select_pivots", "truncate_apexes_np"]

_MODES = ("gemm", "paper", "solve")


class NSimplexProjector:
    """φ_n : (U, d) → (R^n, l2) with two-sided bound guarantees.

    Host state (float64 numpy): ``pivots`` (n, dim) in the corpus dtype,
    ``sigma`` (n, n-1), ``L``/``Linv`` (n-1, n-1), ``sq_norms`` (n-1,).
    Device twins of ``pivots``, ``Linv`` and ``sq_norms`` (and of ``sigma``
    or ``L`` in the ``paper`` and ``solve`` modes) feed the batch
    projection.
    """

    def __init__(self, pivots, metric: Metric, *, mode: str = "gemm", device="cuda"):
        pivots = np.asarray(pivots)
        if pivots.shape[0] < 2:
            raise ValueError("need at least 2 pivots")
        device = resolve_device(device)
        pivots_t = torch.tensor(pivots, device=device)
        D = metric.cross(pivots_t, pivots_t).cpu().numpy().copy()
        np.fill_diagonal(D, 0.0)
        sigma = _sx.simplex_build_np(D)
        L = _sx.base_lower_triangular(sigma)
        alts = np.diag(L)
        if np.any(alts <= 1e-9):
            bad = np.where(alts <= 1e-9)[0]
            raise ValueError(
                f"degenerate pivot set: vertices {bad + 2} have ~zero altitude; "
                "re-sample pivots"
            )
        self._set(pivots, metric, sigma, np.linalg.inv(L), np.sum(L**2, axis=1), device, mode)

    @classmethod
    def from_fitted(cls, pivots, metric: Metric, sigma, Linv, sq_norms, *, mode: str = "gemm", device="cuda"):
        """Restore a fitted projector without measuring any distance."""
        proj = object.__new__(cls)
        proj._set(
            np.asarray(pivots),
            metric,
            np.asarray(sigma, dtype=np.float64),
            np.asarray(Linv, dtype=np.float64),
            np.asarray(sq_norms, dtype=np.float64),
            resolve_device(device),
            mode,
        )
        return proj

    def _set(self, pivots, metric, sigma, Linv, sq_norms, device, mode):
        if mode not in _MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {_MODES}")
        self.mode = mode
        self.pivots = pivots
        self.metric = metric
        self.sigma = sigma
        self.L = sigma[1:, :]
        self.Linv = Linv
        self.sq_norms = sq_norms
        self.device = device
        self.pivots_t = torch.tensor(pivots, device=device)
        self._Linv_t = torch.as_tensor(Linv, dtype=torch.float64, device=device)
        self._sq_norms_t = torch.as_tensor(sq_norms, dtype=torch.float64, device=device)
        self._device_index = self._Linv_t.get_device()   # -1 on the CPU
        # the paper mode walks sigma, the solve mode solves against L
        self._base_t = None if mode == "gemm" else torch.as_tensor(
            sigma if mode == "paper" else self.L, dtype=torch.float64, device=device)

    @property
    def n_pivots(self) -> int:
        return self.pivots.shape[0]

    @property
    def out_dim(self) -> int:
        return self.n_pivots

    def pivot_distances(self, X: torch.Tensor) -> torch.Tensor:
        """(B, n) float64 original-space distances from each row to each pivot."""
        return self.metric.cross(X, self.pivots_t)

    def project_distances(self, distances: torch.Tensor) -> torch.Tensor:
        """Float64 apexes from (B, n) or (n,) pivot distances.  Distances that
        already are float64 on the projector's device go to K4 as they are
        (this runs once per query)."""
        if not (isinstance(distances, torch.Tensor) and distances.dtype is torch.float64
                and distances.get_device() == self._device_index):
            distances = torch.as_tensor(distances, dtype=torch.float64, device=self.device)
        if self.mode == "paper":
            return _sx.apex_addition(self._base_t, distances)
        if self.mode == "solve":
            out = _sx.apex_solve(self._base_t, self._sq_norms_t, distances)
            return out[0] if distances.ndim == 1 else out
        if distances.ndim == 1:
            return _apex_project_vector(distances, self._Linv_t, self._sq_norms_t)
        return apex_project(distances, self._Linv_t, self._sq_norms_t)

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        return self.project_distances(self.pivot_distances(X))

    def truncate(self, k: int) -> "NSimplexProjector":
        """Projector onto the first ``k`` pivots, by slicing alone: ``L`` is
        lower triangular, so the leading block of ``L⁻¹`` is the inverse of
        the leading block of ``L``."""
        if not (2 <= k <= self.n_pivots):
            raise ValueError(f"k must be in [2, {self.n_pivots}]; got {k}")
        return NSimplexProjector.from_fitted(
            self.pivots[:k],
            self.metric,
            self.sigma[:k, : k - 1],
            self.Linv[: k - 1, : k - 1],
            self.sq_norms[: k - 1],
            mode=self.mode,
            device=self.device,
        )

    def truncated(self, m: int) -> "NSimplexProjector":
        """The JAX package's older spelling of :meth:`truncate`."""
        return self.truncate(m)


def truncate_apexes_np(apexes: np.ndarray, dims: int) -> np.ndarray:
    """Host apex truncation (..., n) → (..., dims): the first ``dims - 1``
    head coordinates, then the tail folded into ``sqrt(Σ_{i >= dims} x_i²)``."""
    apexes = np.asarray(apexes)
    n = apexes.shape[-1]
    if not (2 <= dims <= n):
        raise ValueError(f"dims must be in [2, {n}]; got {dims}")
    if dims == n:
        return apexes
    tail_sq = np.sum(apexes[..., dims - 1:] ** 2, axis=-1, keepdims=True)
    return np.concatenate(
        [apexes[..., : dims - 1], np.sqrt(np.maximum(tail_sq, 0.0))], axis=-1
    )


def select_pivots(
    X: np.ndarray,
    n: int,
    *,
    strategy: str = "random",
    seed: int = 0,
    metric: Optional[Metric] = None,
) -> np.ndarray:
    """Pivot selection on the host: ``random`` (the paper's default; the
    same ``np.random.default_rng(seed)`` draw as the JAX package, so both
    fit the same simplex), ``pca`` or ``maxmin``."""
    X = np.asarray(X)
    rng = np.random.default_rng(seed)
    if strategy == "random":
        idx = rng.choice(X.shape[0], size=n, replace=False)
        return X[idx]
    if strategy == "pca":
        mu = X.mean(axis=0)
        Xc = X - mu
        sub = Xc[rng.choice(Xc.shape[0], size=min(4096, Xc.shape[0]), replace=False)]
        _, s, Vt = np.linalg.svd(sub, full_matrices=False)
        scale = s[:n] / np.sqrt(sub.shape[0])
        return mu + Vt[:n] * scale[:, None]
    if strategy == "maxmin":
        if metric is None:
            raise ValueError("maxmin pivot selection needs the metric")
        Xt = torch.as_tensor(X)
        idx = [int(rng.integers(X.shape[0]))]
        d = metric.one_to_many(Xt[idx[0]], Xt).numpy()
        for _ in range(n - 1):
            cand = int(np.argmax(d))
            idx.append(cand)
            d = np.minimum(d, metric.one_to_many(Xt[cand], Xt).numpy())
        return X[idx]
    raise ValueError(f"unknown pivot strategy {strategy!r}")
