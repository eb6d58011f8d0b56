"""n-simplex construction (the paper's Algorithms 1 and 2) and the GEMM form.

The fit is float64 numpy on the host: it touches n <= 64 pivots once.  With
pivot 1 at the origin and ``g_i = (δ_1² + ||v_i||² - δ_i²)/2`` the apex is
``w = g · L⁻ᵀ`` and its altitude ``sqrt(δ_1² - ||w||²)``, one
(B, n-1) x (n-1, n-1) product for a whole batch: ``apex_gemm_np`` here on
the host, and on the index's device the kernel K4
(``repro_torch.kernels.apex_project``).  ``apex_addition`` is Algorithm 2
on the device, batched over rows: the serving step's ``projection="paper"``
baseline and the projector's ``mode="paper"``.  ``apex_solve`` is the same
apex by one batched triangular solve against ``L`` (the projector's
``mode="solve"``).

Conventions: ``n`` pivots give a base simplex ``Sigma`` of shape (n, n-1)
(row ``i`` = vertex i, zero upper triangle); apexes live in ``R^n``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "apex_addition",
    "apex_addition_np",
    "apex_addition_jax",
    "apex_gemm",
    "apex_gemm_np",
    "apex_solve",
    "base_lower_triangular",
    "simplex_build_np",
]


def apex_addition_np(sigma_base: np.ndarray, distances: np.ndarray) -> np.ndarray:
    """Paper Algorithm 2: the apex over an (n, n-1) base simplex at the
    given (n,) distances to its vertices; the last coordinate is >= 0."""
    sigma_base = np.asarray(sigma_base, dtype=np.float64)
    distances = np.asarray(distances, dtype=np.float64)
    n = sigma_base.shape[0]
    if sigma_base.shape != (n, n - 1):
        raise ValueError(f"base simplex must be (n, n-1); got {sigma_base.shape}")
    if distances.shape != (n,):
        raise ValueError(f"need {n} distances; got {distances.shape}")

    out = np.zeros(n, dtype=np.float64)
    out[0] = distances[0]
    for i in range(1, n):  # paper's i = 2..n (1-based)
        l = float(np.sqrt(np.sum((sigma_base[i] - out[: n - 1]) ** 2) + out[n - 1] ** 2))
        delta = float(distances[i])
        x = float(sigma_base[i][i - 1])
        if x <= 0.0:
            raise ValueError(
                f"degenerate base simplex: altitude of vertex {i + 1} is {x}"
            )
        y = float(out[i - 1])
        out[i - 1] = y - (delta**2 - l**2) / (2.0 * x)
        rad = y**2 - out[i - 1] ** 2
        out[i] = np.sqrt(max(rad, 0.0))
    return out


def apex_addition(sigma_base: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 on ``sigma_base``'s device, one row per query: the (..., n)
    apexes of (n,) or (B, n) distances over an (n, n-1) base simplex, in the
    promoted dtype of the two.  The same sequential dataflow as
    ``apex_addition_np`` (the JAX package's ``apex_addition_jax``), run for
    every row of the block at once."""
    sigma = torch.as_tensor(sigma_base)
    d = torch.as_tensor(distances, device=sigma.device)
    dt = torch.promote_types(sigma.dtype, d.dtype)
    sigma, d = sigma.to(dt), d.to(dt)
    n = sigma.shape[0]
    if tuple(sigma.shape) != (n, n - 1):
        raise ValueError(f"base simplex must be (n, n-1); got {tuple(sigma.shape)}")
    if d.shape[-1] != n or d.ndim not in (1, 2):
        raise ValueError(f"need (n,) or (B, n) distances with n = {n}; got {tuple(d.shape)}")
    rows = d.reshape(-1, n)
    out = torch.zeros_like(rows)
    out[:, 0] = rows[:, 0]
    for i in range(1, n):
        # only the first n-1 coordinates can be nonzero before the last step
        l2sq = ((sigma[i] - out[:, : n - 1]) ** 2).sum(dim=-1) + out[:, n - 1] ** 2
        y = out[:, i - 1].clone()
        new = y - (rows[:, i] ** 2 - l2sq) / (2.0 * sigma[i, i - 1])
        out[:, i - 1] = new
        out[:, i] = torch.sqrt(torch.clamp(y**2 - new**2, min=0.0))
    return out.reshape(d.shape)


#: the JAX package's name for the same on-device Algorithm 2
apex_addition_jax = apex_addition


def simplex_build_np(distance_matrix: np.ndarray) -> np.ndarray:
    """Paper Algorithm 1: the (m, m-1) vertex matrix of the simplex over m
    points from their (m, m) distance matrix (lower triangle read)."""
    D = np.asarray(distance_matrix, dtype=np.float64)
    m = D.shape[0]
    if D.shape != (m, m):
        raise ValueError("distance matrix must be square")
    if m < 2:
        raise ValueError("need at least two points")
    sigma = np.zeros((2, 1), dtype=np.float64)
    sigma[1, 0] = D[1, 0]
    for k in range(2, m):
        apex = apex_addition_np(sigma, D[k, :k])
        new = np.zeros((k + 1, k), dtype=np.float64)
        new[:k, : k - 1] = sigma
        new[k, :] = apex
        sigma = new
    return sigma


def base_lower_triangular(sigma_base) -> np.ndarray:
    """Rows 2..n of the base simplex as an (n-1)x(n-1) lower-triangular L."""
    return np.asarray(sigma_base)[1:, :]


def apex_solve(L, sq_norms, distances) -> torch.Tensor:
    """Float64 apexes (B, n) of (B, n) or (n,) pivot distances by one
    triangular solve ``L w = g`` with the B right-hand sides
    ``g_i = (δ_1² + ||v_i||² - δ_i²)/2``, on the distances' device; the
    altitude is ``sqrt(max(δ_1² - ||w||², 0))``."""
    d = torch.atleast_2d(torch.as_tensor(distances)).to(torch.float64)
    L = torch.as_tensor(L, dtype=torch.float64, device=d.device)
    sq = torch.as_tensor(sq_norms, dtype=torch.float64, device=d.device)
    d1sq = d[:, :1] ** 2
    g = 0.5 * (d1sq + sq[None, :] - d[:, 1:] ** 2)
    w = torch.linalg.solve_triangular(L, g.T, upper=False, left=True).T
    alt2 = torch.clamp_min(d1sq[:, 0] - (w * w).sum(dim=-1), 0.0)
    return torch.cat([w, torch.sqrt(alt2)[:, None]], dim=-1)


def apex_gemm(Linv, sq_norms, distances) -> torch.Tensor:
    """Apexes (B, n) of (B, n) or (n,) pivot distances by one product
    against ``L⁻¹``, in the distances' dtype on their device: the kernel K4
    on a CUDA device, its plain version on the CPU."""
    from repro_torch.kernels import apex_project

    d = torch.atleast_2d(torch.as_tensor(distances))
    Linv = torch.as_tensor(Linv, dtype=d.dtype, device=d.device)
    sq = torch.as_tensor(sq_norms, dtype=d.dtype, device=d.device)
    return apex_project(d.contiguous(), Linv.contiguous(), sq.contiguous())


def apex_gemm_np(Linv: np.ndarray, sq_norms: np.ndarray, distances: np.ndarray) -> np.ndarray:
    """Float64 host apexes from (B, n) pivot distances against ``L⁻¹``."""
    Linv = np.asarray(Linv, dtype=np.float64)
    sq_norms = np.asarray(sq_norms, dtype=np.float64)
    distances = np.atleast_2d(np.asarray(distances, dtype=np.float64))
    d1sq = distances[:, :1] ** 2
    g = 0.5 * (d1sq + sq_norms[None, :] - distances[:, 1:] ** 2)
    w = g @ Linv.T
    alt2 = np.maximum(d1sq[:, 0] - np.einsum("bi,bi->b", w, w), 0.0)
    return np.concatenate([w, np.sqrt(alt2)[:, None]], axis=-1)

