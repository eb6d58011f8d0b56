"""Frozen data: a colour-histogram deployment and its traffic.

A copy of the port's ``colors_like`` generator (SISAP *colors* stand-in:
112-dim positive histograms summing to 1, a ``latent``-dim simplex mixture
pushed through a fixed dictionary of basis histograms, plus a noise floor),
frozen here so that a change to the program cannot change the benchmark's
data, with the draw split in two:

* the deployment, from the configuration's ``mixture_seed``: the
  dictionary, the cluster centres and the corpus rows, so every run serves
  the same corpus, as a deployment does;
* the traffic, from the run's ``--seed``: the query rows, held out of the
  same mixture, drawn from a stream of their own.

The noise floor is drawn in float32 (the bulk of the draw).
"""

from __future__ import annotations

import numpy as np

__all__ = ["corpus_rows", "query_rows"]


def _mixture(mixture_seed: int, dim: int, n_clusters: int, latent: int):
    mix = np.random.default_rng(np.random.SeedSequence([int(mixture_seed), 0]))
    return mix.dirichlet(np.full(dim, 0.15), size=latent), mix.dirichlet(np.full(latent, 0.8), size=n_clusters)


def _rows(rng, n: int, M: np.ndarray, centers: np.ndarray, noise: float) -> np.ndarray:
    latent, dim = M.shape
    asn = rng.integers(0, centers.shape[0], size=n)
    Z = np.abs(centers[asn] + rng.normal(size=(n, latent)) * 0.08)
    Z /= np.maximum(Z.sum(axis=1, keepdims=True), 1e-12)
    X = rng.standard_normal((n, dim), dtype=np.float32)
    np.abs(X, out=X)
    X *= np.float32(noise)
    X += (Z @ M).astype(np.float32)
    X /= np.maximum(X.sum(axis=1, keepdims=True), np.float32(1e-12))
    return X


def corpus_rows(n_rows: int, *, mixture_seed: int, dim: int = 112, n_clusters: int = 24, latent: int = 10,
                noise: float = 0.002) -> np.ndarray:
    """(n_rows, dim) float32 corpus rows of the deployment of
    ``mixture_seed``, from a stream of their own."""
    M, centers = _mixture(mixture_seed, dim, n_clusters, latent)
    return _rows(np.random.default_rng(np.random.SeedSequence([int(mixture_seed), 1])), n_rows, M, centers, noise)


def query_rows(seed: int, n_queries: int, *, mixture_seed: int, dim: int = 112, n_clusters: int = 24,
               latent: int = 10, noise: float = 0.002) -> np.ndarray:
    """(n_queries, dim) float32 query rows of the run's seed (any
    non-negative int), held out of the deployment's mixture."""
    M, centers = _mixture(mixture_seed, dim, n_clusters, latent)
    return _rows(np.random.default_rng(np.random.SeedSequence([int(seed), 3])), n_queries, M, centers, noise)
