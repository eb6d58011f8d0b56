"""Distribution-drift detection for online ingest.

The fitted state of a table index is only as good as the pivot set, and the
pivot set is only as good as the data it was chosen from.  When the incoming
stream drifts away from the distribution the base was fitted on, bounds
widen, candidate ratios climb, and refine cost grows — silently.

``DriftDetector`` watches for that cheaply: it keeps a reference histogram
of pivot distances (rows pooled against a small witness subset of the fitted
pivots, measured at fit time) and folds every ingested batch into a matching
streaming histogram.  The drift statistic is the Jensen-Shannon divergence
between the two: 0 when the stream looks like the base, approaching 1 as it
concentrates somewhere the pivots never saw.  Past ``threshold`` (with at
least ``min_rows`` observed so the statistic is meaningful), the owner
stages a pivot re-selection + refit on a shadow index and swaps it in
(``DurableIndex.refit``).

The JAX package's ``repro.store.drift`` with the witness distances on the
index's device: one ``metric.cross(witness, rows)`` call per batch (K5 for
Jensen-Shannon on the card, torch ops for the other metrics, f64), where the
JAX package makes one host call per witness.  The bin edges, the histograms
and the divergence stay host numpy in f64, and the reference rows are thinned
without randomness, so recovery rebuilds the same histogram.  The distances
agree with the JAX package's to rounding, not bit for bit: a distance on a
bin edge may land in the neighbouring bin.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DriftDetector"]

DEFAULT_BINS = 24
DEFAULT_THRESHOLD = 0.25
DEFAULT_MIN_ROWS = 64
DEFAULT_WITNESS_PIVOTS = 8
DEFAULT_MAX_REF_ROWS = 2048
_ALPHA = 1e-9  # additive smoothing so JSD is defined on empty bins


def _jsd(p: np.ndarray, q: np.ndarray) -> float:
    """Jensen-Shannon divergence (base 2, in [0, 1]) between two histograms."""
    p = p.astype(np.float64) + _ALPHA
    q = q.astype(np.float64) + _ALPHA
    p /= p.sum()
    q /= q.sum()
    m = 0.5 * (p + q)
    kl_pm = float(np.sum(p * np.log2(p / m)))
    kl_qm = float(np.sum(q * np.log2(q / m)))
    return max(0.0, 0.5 * kl_pm + 0.5 * kl_qm)


class DriftDetector:
    """Pivot-distance histogram divergence between fitted base and stream."""

    def __init__(self, pivots: np.ndarray, metric, base_rows, *,
                 bins: int = DEFAULT_BINS,
                 threshold: float = DEFAULT_THRESHOLD,
                 min_rows: int = DEFAULT_MIN_ROWS,
                 witness_pivots: int = DEFAULT_WITNESS_PIVOTS,
                 max_ref_rows: int = DEFAULT_MAX_REF_ROWS,
                 device="cuda"):
        """``base_rows`` and every ``update`` batch: host arrays or tensors;
        their witness distances are measured on ``device``."""
        if not (0.0 < threshold <= 1.0):
            raise ValueError(f"threshold must be in (0, 1]; got {threshold}")
        self.bins = int(bins)
        self.threshold = float(threshold)
        self.min_rows = int(min_rows)
        self.witness_pivots = int(witness_pivots)
        self.max_ref_rows = int(max_ref_rows)
        self.device = resolve_device(device)
        self._metric = metric
        self.rebase(pivots, base_rows)

    def _rows(self, rows) -> torch.Tensor:
        rows = torch.as_tensor(rows, device=self.device)
        return rows[None, :] if rows.ndim == 1 else rows

    # -- reference side --------------------------------------------------------
    def rebase(self, pivots: np.ndarray, base_rows) -> None:
        """Re-anchor on a fresh fit: new witness pivots, new reference
        histogram, streaming counts zeroed.  Called after every refit."""
        witness = np.ascontiguousarray(np.asarray(pivots)[: self.witness_pivots])
        self._witness = torch.as_tensor(witness, device=self.device)
        base_rows = self._rows(base_rows)
        if base_rows.shape[0] > self.max_ref_rows:
            # deterministic thinning — no RNG so recovery rebuilds identically
            step = base_rows.shape[0] / self.max_ref_rows
            idx = (np.arange(self.max_ref_rows) * step).astype(np.int64)
            base_rows = base_rows[torch.as_tensor(idx, device=self.device)]
        ref = self._pooled_distances(base_rows)
        lo = float(ref.min()) if ref.size else 0.0
        hi = float(ref.max()) if ref.size else 1.0
        if hi <= lo:
            hi = lo + 1.0
        pad = 0.05 * (hi - lo)
        self._edges = np.linspace(lo - pad, hi + pad, self.bins + 1)
        self._ref_counts, _ = np.histogram(ref, bins=self._edges)
        self._delta_counts = np.zeros(self.bins, dtype=np.int64)
        self._n_seen = 0

    def _pooled_distances(self, rows: torch.Tensor) -> np.ndarray:
        """Every (witness, row) distance in f64 on the host, from one cross
        call on the device."""
        if rows.numel() == 0 or self._witness.numel() == 0:
            return np.empty(0)
        return self._metric.cross(self._witness, rows).cpu().numpy().reshape(-1)

    # -- streaming side --------------------------------------------------------
    def update(self, rows) -> float:
        """Fold one ingested batch into the streaming histogram; returns the
        current drift statistic."""
        rows = self._rows(rows)
        d = self._pooled_distances(rows)
        if d.size:
            # clip into range so out-of-support mass lands in the edge bins
            # (out-of-support is exactly the drift we want to see)
            d = np.clip(d, self._edges[0], self._edges[-1])
            counts, _ = np.histogram(d, bins=self._edges)
            self._delta_counts += counts
            self._n_seen += int(rows.shape[0])
        return self.statistic()

    def statistic(self) -> float:
        """JSD between reference and streaming histograms; 0.0 until
        ``min_rows`` stream rows have been observed."""
        if self._n_seen < self.min_rows:
            return 0.0
        return _jsd(self._ref_counts, self._delta_counts)

    @property
    def n_seen(self) -> int:
        return self._n_seen

    @property
    def drifted(self) -> bool:
        return self.statistic() > self.threshold

    def stats(self) -> dict:
        return {
            "statistic": self.statistic(),
            "threshold": self.threshold,
            "n_seen": self._n_seen,
            "bins": self.bins,
            "witness_pivots": int(self._witness.shape[0]),
        }
