"""Deterministic synthetic corpora.

``colors_like`` stands in for the SISAP *colors* benchmark (112-dim colour
histograms, positive entries, rows summing to 1, strongly clustered, so the
intrinsic dimensionality is far below 112).  It is the JAX package's
generator, copied so the same seed gives the same rows in both packages.
``load_or_generate_colors`` reads the real SISAP colors file
(``data/colors.ascii`` in the repository) when present, else generates.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = ["colors_like", "load_or_generate_colors"]

#: where the real SISAP colors file is looked for (not in the repository)
_COLORS_FILE = os.path.join(os.path.dirname(__file__), "..", "..", "..", "data", "colors.ascii")


def colors_like(
    n: int = 112_682,
    dim: int = 112,
    n_clusters: int = 24,
    latent: int = 10,
    noise: float = 0.002,
    seed: int = 1234,
    dtype=np.float32,
) -> np.ndarray:
    """(n, dim) positive histogram rows with low intrinsic dimensionality: a
    ``latent``-dim simplex mixture pushed through a fixed nonnegative
    dictionary of basis histograms, plus a small full-rank noise floor."""
    rng = np.random.default_rng(seed)
    M = rng.dirichlet(np.full(dim, 0.15), size=latent)        # (latent, dim)
    centers = rng.dirichlet(np.full(latent, 0.8), size=n_clusters)
    asn = rng.integers(0, n_clusters, size=n)
    Z = np.abs(centers[asn] + rng.normal(size=(n, latent)) * 0.08)
    Z /= np.maximum(Z.sum(axis=1, keepdims=True), 1e-12)
    X = Z @ M + np.abs(rng.normal(size=(n, dim))) * noise
    X /= np.maximum(X.sum(axis=1, keepdims=True), 1e-12)
    return X.astype(dtype)


def load_or_generate_colors(path: Optional[str] = None, **kwargs) -> np.ndarray:
    """The real SISAP colors rows (``path``, else ``data/colors.ascii``)
    when the file exists, else ``colors_like(**kwargs)``."""
    for p in ([path] if path else []) + [_COLORS_FILE]:
        if p and os.path.exists(p):
            raw = np.loadtxt(p, dtype=np.float32)
            return raw if raw.ndim == 2 else raw.reshape(-1, 112)
    return colors_like(**kwargs)
