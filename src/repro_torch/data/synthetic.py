"""Deterministic synthetic datasets for every substrate.

``colors_like`` stands in for the SISAP *colors* benchmark (112-dim colour
histograms, positive entries, rows summing to 1, strongly clustered, so the
intrinsic dimensionality is far below 112).  It is the JAX package's
generator, copied so the same seed gives the same rows in both packages.
``load_or_generate_colors`` reads the real SISAP colors file
(``data/colors.ascii`` in the repository) when present, else generates.
The model workloads' generators (tokens, CTR batches, user histories,
graphs, molecules) are the JAX package's too: numpy ``default_rng`` code,
so the same seed gives the same arrays bit for bit in both packages.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = [
    "colors_like",
    "uniform_cube",
    "load_or_generate_colors",
    "token_stream",
    "criteo_like_batch",
    "default_vocab_sizes",
    "user_history_batch",
    "random_graph",
    "cora_like",
    "molecule_batch",
]

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


def uniform_cube(n: int = 10_000, dim: int = 30, seed: int = 7, dtype=np.float32):
    """Evenly distributed points in [0,1]^dim (paper Table 2 right block)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, size=(n, dim)).astype(dtype)


def load_or_generate_colors(path: Optional[str] = None, **kwargs) -> np.ndarray:
    """The real SISAP colors rows (``path``, else ``data/colors.ascii``)
    when the file exists, else ``colors_like(**kwargs)``."""
    for p in ([path] if path else []) + [_COLORS_FILE]:
        if p and os.path.exists(p):
            raw = np.loadtxt(p, dtype=np.float32)
            return raw if raw.ndim == 2 else raw.reshape(-1, 112)
    return colors_like(**kwargs)


# ---------------------------------------------------------------------------
# LM data
# ---------------------------------------------------------------------------

def token_stream(batch: int, seq_len: int, vocab: int, seed: int = 0):
    """Deterministic pseudo-text: Zipfian tokens with local repetition.

    Returns (tokens, labels) int32 arrays of shape (batch, seq_len).
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(batch, seq_len + 1), p=probs).astype(np.int32)
    # local repetition: with p=0.2 copy the previous token (gives learnable bigram mass)
    rep = rng.random((batch, seq_len + 1)) < 0.2
    for t in range(1, seq_len + 1):
        toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
    return toks[:, :-1], toks[:, 1:]


# ---------------------------------------------------------------------------
# RecSys data (Criteo-like: 13 dense + 26..39 sparse categorical fields)
# ---------------------------------------------------------------------------

def criteo_like_batch(
    batch: int,
    n_sparse: int = 39,
    vocab_sizes: Optional[np.ndarray] = None,
    n_dense: int = 13,
    seed: int = 0,
):
    """Synthetic CTR batch: (dense (B, n_dense), sparse ids (B, n_sparse), labels)."""
    rng = np.random.default_rng(seed)
    if vocab_sizes is None:
        vocab_sizes = default_vocab_sizes(n_sparse)
    dense = rng.lognormal(0.0, 1.0, size=(batch, n_dense)).astype(np.float32)
    sparse = np.stack(
        [
            rng.integers(0, v, size=batch, dtype=np.int64) % v
            for v in vocab_sizes
        ],
        axis=1,
    ).astype(np.int32)
    logits = dense[:, 0] * 0.1 + (sparse[:, 0] % 7 == 0) * 0.8 - 0.5
    labels = (rng.random(batch) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    return dense, sparse, labels


def default_vocab_sizes(n_sparse: int = 39) -> np.ndarray:
    """Criteo-style long-tailed vocabulary sizes: a few huge, most small."""
    base = [10_000_000, 4_000_000, 1_500_000, 600_000, 200_000, 60_000]
    rest = [10_000, 4_000, 2_000, 1_000, 500, 200, 100, 50, 20, 10]
    sizes = (base + rest * 4)[:n_sparse]
    while len(sizes) < n_sparse:
        sizes.append(100)
    return np.asarray(sizes, dtype=np.int64)


def user_history_batch(batch: int, seq_len: int, n_items: int, seed: int = 0):
    """SASRec/MIND-style user behaviour sequences (ids, 0 = padding)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(max(1, seq_len // 4), seq_len + 1, size=batch)
    seqs = np.zeros((batch, seq_len), dtype=np.int32)
    for b in range(batch):
        seqs[b, seq_len - lengths[b]:] = rng.integers(1, n_items, size=lengths[b])
    targets = rng.integers(1, n_items, size=batch).astype(np.int32)
    return seqs, targets


# ---------------------------------------------------------------------------
# Graph data
# ---------------------------------------------------------------------------

def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 7, seed: int = 0):
    """Random graph: (features, edge_index (2, E) src->dst, labels).

    Power-law-ish degree distribution; includes self-loops (GCN Ã convention
    is applied model-side).
    """
    rng = np.random.default_rng(seed)
    # preferential-attachment-flavoured endpoints
    w = 1.0 / np.arange(1, n_nodes + 1) ** 0.5
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    X = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    return X, np.stack([src, dst]), y


def cora_like(seed: int = 0):
    """Cora-shaped citation graph: 2708 nodes, 10556 edges, 1433 feats, 7 classes."""
    X, ei, y = random_graph(2708, 10556, 1433, 7, seed)
    X = (np.abs(X) > 1.2).astype(np.float32)  # sparse bag-of-words-like features
    return X, ei, y


def molecule_batch(batch: int = 128, n_nodes: int = 30, n_edges: int = 64, d_feat: int = 16, seed: int = 0):
    """Batched small graphs, padded to fixed size; returns a dict of arrays."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, n_nodes, d_feat)).astype(np.float32)
    src = rng.integers(0, n_nodes, size=(batch, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=(batch, n_edges)).astype(np.int32)
    labels = rng.integers(0, 2, size=batch).astype(np.int32)
    return {"feats": feats, "src": src, "dst": dst, "labels": labels}
