"""The plain reference: brute-force answers in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
starts from the corpus and the queries that the benchmark generated, and
works out again whatever the program derived from them.

``dtype`` is the precision the reference computes in: float64 for the
reference itself, a lower one for the control (``control.py``), which must
come out as not correct.  Distances:

* ``euclidean``: ``sqrt(sum((x - q)^2))``;
* ``jensen_shannon``: sqrt of the base-2 Jensen-Shannon divergence of the
  L1-normalised rows, clamped to [0, 1].

Whole-corpus scans run in blocks of queries on the corpus's device; a
float64 Euclidean scan uses the GEMM identity to rank and then recomputes
every row it keeps in difference form, so its distances are exact to
float64 rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Reference"]

_LN2 = math.log(2.0)
#: rows past the k-th kept by a GEMM-ranked float64 scan and recomputed
_MARGIN = 16


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x * torch.log(torch.clamp_min(x, 1e-300 if x.dtype == torch.float64 else 1e-30)),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _l1(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(x.sum(dim=-1, keepdim=True), 1e-12)


def _order(d: torch.Tensor, ids: torch.Tensor):
    """Sort each row of (d, ids) by distance, ties by ascending id."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    d, ids = torch.gather(d, 1, by_id), torch.gather(ids, 1, by_id)
    by_d = torch.argsort(d, dim=1, stable=True)
    return torch.gather(d, 1, by_d), torch.gather(ids, 1, by_d)


class Reference:
    """Exact k-NN and single distances over one corpus."""

    def __init__(self, corpus: np.ndarray, metric: str, *, device="cuda", dtype=torch.float64,
                 block_elems: int = 1 << 27):
        if metric not in ("euclidean", "jensen_shannon"):
            raise ValueError(f"no reference for metric {metric!r}")
        self.metric = metric
        self.dtype = dtype
        self.device = torch.device(device)
        X = torch.as_tensor(corpus, device=self.device).to(dtype)
        if metric == "jensen_shannon":
            X = _l1(X)
            self.hx = _xlogx(X).sum(dim=1)
        else:
            self.sq = (X * X).sum(dim=1) if dtype == torch.float64 else None
        self.X = X
        self.N, self.dim = X.shape
        # query rows per block of an elementwise scan: (block, N, dim) temporaries
        self.block = max(1, block_elems // (self.N * self.dim))

    def _q(self, qs) -> torch.Tensor:
        q = torch.as_tensor(np.asarray(qs), device=self.device).to(self.dtype)
        return _l1(q) if self.metric == "jensen_shannon" else q

    def _scan(self, q: torch.Tensor) -> torch.Tensor:
        """(B, N) distances of a block of prepared queries to every row."""
        if self.metric == "jensen_shannon":
            out = []
            hq = _xlogx(q).sum(dim=1)
            for lo in range(0, q.shape[0], self.block):
                qb = q[lo:lo + self.block]
                m = 0.5 * (qb[:, None, :] + self.X[None, :, :])
                hm = _xlogx(m).sum(dim=2)
                js = 0.5 * hq[lo:lo + self.block, None] + 0.5 * self.hx[None, :] - hm
                out.append(torch.sqrt(torch.clamp(js / _LN2, 0.0, 1.0)))
            return torch.cat(out)
        if self.dtype == torch.float64:
            d2 = (q * q).sum(dim=1)[:, None] + self.sq[None, :] - 2.0 * (q @ self.X.T)
            return torch.sqrt(torch.clamp_min(d2, 0.0))
        out = []
        for lo in range(0, q.shape[0], self.block):
            diff = self.X[None, :, :] - q[lo:lo + self.block, None, :]
            out.append(torch.sqrt(torch.clamp_min((diff * diff).sum(dim=2), 0.0)))
        return torch.cat(out)

    def _exact(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """(B, m) distances of each prepared query to its own rows ``ids``."""
        rows = self.X[ids]                              # (B, m, dim)
        if self.metric == "jensen_shannon":
            m = 0.5 * (q[:, None, :] + rows)
            js = 0.5 * _xlogx(q).sum(dim=1)[:, None] + 0.5 * self.hx[ids] - _xlogx(m).sum(dim=2)
            return torch.sqrt(torch.clamp(js / _LN2, 0.0, 1.0))
        diff = rows - q[:, None, :]
        return torch.sqrt(torch.clamp_min((diff * diff).sum(dim=2), 0.0))

    def knn(self, qs, k: int, *, chunk: int = 256):
        """(ids (B, k) int64, distances (B, k) float64): the k nearest rows
        of each query, by (distance, id)."""
        ids_out, d_out = [], []
        for lo in range(0, len(qs), chunk):
            q = self._q(qs[lo:lo + chunk])
            d = self._scan(q)
            width = min(self.N, k + _MARGIN)
            _, cand = torch.topk(d, width, dim=1, largest=False, sorted=False)
            dc = self._exact(q, cand) if self.metric == "euclidean" else torch.gather(d, 1, cand)
            dc, cand = _order(dc, cand)
            ids_out.append(cand[:, :k].cpu())
            d_out.append(dc[:, :k].to(torch.float64).cpu())
        return torch.cat(ids_out).numpy(), torch.cat(d_out).numpy()

    def distances(self, qs, ids: list, *, chunk: int = 256) -> list:
        """float64 distances of each query to its own id list (ragged)."""
        out = [None] * len(ids)
        by_len = {}
        for i, row_ids in enumerate(ids):
            by_len.setdefault(len(row_ids), []).append(i)
        for width, rows in by_len.items():
            if width == 0:
                for i in rows:
                    out[i] = np.empty(0)
                continue
            for lo in range(0, len(rows), chunk):
                part = rows[lo:lo + chunk]
                q = self._q(np.stack([np.asarray(qs[i]) for i in part]))
                idx = torch.as_tensor(np.stack([np.asarray(ids[i], dtype=np.int64) for i in part]),
                                      device=self.device)
                d = self._exact(q, idx).to(torch.float64).cpu().numpy()
                for j, i in enumerate(part):
                    out[i] = d[j]
        return out
