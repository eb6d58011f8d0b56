"""LAESA (Micó, Oncina & Vidal 1994): the paper's baseline filter (§2, §6).

n reference objects; each data row stores its n original-space distances to
them.  A query computes its n pivot distances, then any row whose Chebyshev
distance to the query's distance vector exceeds t is excluded by triangle
inequality.  Survivors are re-checked in the original space.

The index holds on its device the corpus in its input dtype and the float64
(N, n) pivot-distance table.  The Chebyshev/triangle scan runs there as
torch ops in float64, in row tiles of ``_SCAN_CHUNK_ELEMS`` (Q, rows, n)
elements, so no (Q, N, n) temporary exists.  It uses only subtraction,
``abs``, ``max``, addition and ``min``, each correctly rounded in IEEE
float64, so the bounds are bit-equal to the JAX package's numpy scan for
the same query-pivot distances.  Query-pivot distances go through the
metric's ``cross`` (K5 for Jensen-Shannon on the card), refinement through
``one_to_many``.

Per query the host runs the reference's small control flow (the
shrinking-radius refinement, the cost ledger), so ids, tie order and
``QueryStats`` follow the JAX package's ``repro.index.laesa``.  Its
``index.select`` scans (``TopKScan`` / ``CandidateScan``) are not a module
here: exact k-NN (one query or a block) keeps a running k smallest upper
bounds per query with ``torch.topk`` and collects the candidates under the
running cutoff in the same tile loop, then one stable sort orders each
query's survivors by (lwb, id); the LAESA parity tests hold that contract.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.approx import approx_knn_from_bounds, approx_search_from_bounds
from repro_torch.index.knn import knn_refine_candidates
from repro_torch.index.rows import DeviceRows, device_rows
from repro_torch.index.stats import QueryStats
from repro_torch.metrics import Metric

__all__ = ["LaesaIndex", "QueryStats"]

#: float64 elements of one (Q, rows, n) scan tile (128 MiB): a 64-query
#: block over a million rows takes 77 tiles
_SCAN_CHUNK_ELEMS = 1 << 24


class LaesaIndex(DeviceRows):
    """Pivot-distance table + Chebyshev exclusion filter on one device."""

    def __init__(self, data, pivots, metric: Metric, *, device="cuda"):
        self.device = resolve_device(device)
        self.data = device_rows(data, self.device)
        self.pivots = np.asarray(pivots)
        self.pivots_t = torch.tensor(self.pivots, device=self.device)
        self.metric = metric
        # build: n original-space distances per object, one vectorised call
        if self.data.shape[0]:
            self.table = metric.cross(self.data, self.pivots_t)
        else:
            self.table = torch.zeros((0, self.n_pivots), dtype=torch.float64, device=self.device)

    @property
    def n_pivots(self) -> int:
        return self.pivots.shape[0]

    # -- persistence ----------------------------------------------------------
    def state_arrays(self) -> dict:
        """Host numpy copies, the keys of the JAX package's ``state_arrays``."""
        return {"data": self.data.cpu().numpy(), "pivots": self.pivots, "table": self.table.cpu().numpy()}

    @classmethod
    def from_state(cls, arrays: dict, metric: Metric, *, device="cuda") -> "LaesaIndex":
        """Rebuild from a ``state_arrays`` dict (this package's or the JAX
        package's) without re-measuring the pivot-distance table."""
        index = object.__new__(cls)
        index.device = resolve_device(device)
        index.data = torch.tensor(np.asarray(arrays["data"]), device=index.device)
        index.pivots = np.asarray(arrays["pivots"])
        index.pivots_t = torch.tensor(index.pivots, device=index.device)
        index.metric = metric
        index.table = torch.tensor(np.asarray(arrays["table"], dtype=np.float64), device=index.device)
        return index

    def extended(self, rows) -> "LaesaIndex":
        """Functional append: a NEW index over this index's rows plus
        ``rows``, sharing the pivot set.  Only the new rows' n pivot
        distances are measured (``Metric.cross``, K5 for Jensen-Shannon);
        existing table rows carry over bit for bit and ``self`` is never
        mutated, so point-in-time readers holding it stay consistent."""
        rows = torch.atleast_2d(device_rows(rows, self.device))
        if not rows.shape[0]:
            return self
        out = object.__new__(type(self))
        out.device = self.device
        out.data = torch.cat([self.data, rows]) if self.n_rows else rows
        out.pivots = self.pivots
        out.pivots_t = self.pivots_t
        out.metric = self.metric
        tab = self.metric.cross(rows, self.pivots_t)
        out.table = torch.cat([self.table, tab]) if self.n_rows else tab
        return out

    # -- operands -------------------------------------------------------------
    def _qd(self, qpd) -> torch.Tensor:
        return torch.atleast_2d(self._tensor(qpd).to(torch.float64))

    def pivot_rows(self, dims: int = None) -> np.ndarray:
        """The pivot objects a query measures against: all of them, or the
        ``dims`` prefix (the contract behind precomputed ``qpd`` blocks)."""
        return self.pivots if dims is None else self.pivots[: int(dims)]

    def query_distances(self, q, qpd=None) -> torch.Tensor:
        """(n,) float64 query-pivot distances on the index's device."""
        if qpd is not None:
            return self._tensor(qpd).to(torch.float64)
        return self.metric.cross(self._tensor(q)[None, :], self.pivots_t)[0]

    def query_distances_batch(self, queries, qpd=None, dims: int = None) -> torch.Tensor:
        """(Q, n) float64 query-pivot distances in one ``cross`` call (the
        ``dims`` prefix only with ``dims``), or the precomputed ``qpd``."""
        if qpd is not None:
            return self._qd(qpd)
        pivots = self.pivots_t if dims is None else self.pivots_t[: int(dims)]
        return self.metric.cross(torch.atleast_2d(self._tensor(queries)), pivots)

    # -- the scan -------------------------------------------------------------
    @staticmethod
    def _tiles(table: torch.Tensor, Q: int, n_use: int):
        """(lo, hi) row ranges of one scan tile each."""
        N = table.shape[0]
        rows = max(1, _SCAN_CHUNK_ELEMS // max(1, Q * n_use))
        return [(lo, min(lo + rows, N)) for lo in range(0, N, rows)]

    @staticmethod
    def _tile_lwb(qd: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """(Q, w) Chebyshev lower bounds ``max_i |qd_i - T[x, i]|``."""
        return (qd[:, None, :] - cols[None, :, :]).abs_().amax(dim=2)

    @staticmethod
    def _tile_upb(qd: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """(Q, w) pivot-triangle upper bounds ``min_i qd_i + T[x, i]``."""
        return (qd[:, None, :] + cols[None, :, :]).amin(dim=2)

    def filter_candidates(self, qdists: torch.Tensor, threshold: float) -> np.ndarray:
        """Row ids whose Chebyshev distance to ``qdists`` is <= t, ascending."""
        cheb = (self.table - qdists[None, :]).abs().amax(dim=1)
        return torch.nonzero(cheb <= threshold).flatten().cpu().numpy()

    def bounds(self, qdists):
        """(lwb, upb), each (N,), of one query's pivot distances against
        every row: the triangle inequality both ways, ``max_i |qd_i -
        T[x,i]|`` from below and ``min_i qd_i + T[x,i]`` from above.
        LAESA's upper bound is not tight enough to admit threshold results,
        but it seeds an exact k-NN radius.  Float64 tensors on the device."""
        qd = self._tensor(qdists).to(torch.float64)
        return (self.table - qd[None, :]).abs().amax(dim=1), (self.table + qd[None, :]).amin(dim=1)

    def bounds_batch(self, qdists, dims: int = None):
        """(lwb, upb), each (Q, N), of a (Q, >= dims) pivot-distance block.

        ``dims=k`` evaluates the truncated bounds over the first k pivot
        columns only; both sides stay sound and tighten as k grows.
        """
        qd = self._qd(qdists)
        n_use = self.n_pivots if dims is None else int(dims)
        if not (1 <= n_use <= self.n_pivots) or qd.shape[1] < n_use:
            raise ValueError(
                f"dims must be in [1, {self.n_pivots}] with >= dims query "
                f"distances; got dims={dims}, qdists {tuple(qd.shape)}"
            )
        qd = qd[:, :n_use]
        Q, N = qd.shape[0], self.n_rows
        lwb = torch.empty((Q, N), dtype=torch.float64, device=self.device)
        upb = torch.empty_like(lwb)
        for lo, hi in self._tiles(self.table, Q, n_use):
            cols = self.table[lo:hi, :n_use]
            lwb[:, lo:hi] = self._tile_lwb(qd, cols)
            upb[:, lo:hi] = self._tile_upb(qd, cols)
        return lwb, upb

    # -- approximate paths (prefix-pivot surrogate) ----------------------------
    def _qpd_row(self, qpd):
        return None if qpd is None else self._tensor(qpd).reshape(1, -1)

    def _approx_bounds(self, q_t, dims: int, qpd, rowmask):
        """Dense truncated bounds of a query block, compacted to the
        allowed rows: (lwb, upb, pivot_calls, row translation)."""
        qds = self.query_distances_batch(q_t, qpd=qpd, dims=dims)
        pivot_calls = int(dims) if qpd is None else 0
        lwb, upb = self.bounds_batch(qds, dims=dims)
        mask = self._mask_of(rowmask)
        if mask is None:
            return lwb, upb, pivot_calls, (lambda rows: rows)
        # rank the compacted allowed columns only (sel ascending keeps the
        # (est, id) tie order); ids translate back per query
        sel = np.flatnonzero(mask)
        sel_t = torch.as_tensor(sel, device=self.device)
        return lwb[:, sel_t], upb[:, sel_t], pivot_calls, (lambda rows: sel[rows])

    def knn_approx(self, q, k: int, *, dims: int, refine: int, qpd=None, rowmask=None):
        """Approximate k-NN over the first ``dims`` pivot columns.
        Returns (ids, distances, QueryStats)."""
        return self.knn_approx_batch(
            self._tensor(q)[None, :], k, dims=dims, refine=refine, qpd=self._qpd_row(qpd), rowmask=rowmask
        )[0]

    def knn_approx_batch(self, queries, k: int, *, dims: int, refine: int, qpd=None, rowmask=None):
        """Batched approximate k-NN: ``dims`` pivot distances per query, the
        truncated Chebyshev/triangle band, mean-estimate ranking, exact
        re-rank of the top ``refine``.  Returns Q (ids, d, QueryStats)."""
        q_t = torch.atleast_2d(self._tensor(queries))
        lwb, upb, pivot_calls, tr = self._approx_bounds(q_t, dims, qpd, rowmask)
        out = []
        for qi in range(q_t.shape[0]):
            dist = self._dist_fn(q_t[qi])
            ids, d, n_eval, width = approx_knn_from_bounds(
                lambda rows, dist=dist: dist(tr(rows)), lwb[qi], upb[qi], k, refine
            )
            stats = QueryStats(
                original_calls=pivot_calls + n_eval,
                surrogate_calls=self.n_rows,
                candidates=n_eval,
                bound_width=width,
            )
            out.append((tr(ids), d, stats))
        return out

    def search_approx(self, q, threshold: float, *, dims: int, refine: int, qpd=None, rowmask=None):
        """Approximate threshold search (sound outside the straddle band)."""
        return self.search_approx_batch(
            self._tensor(q)[None, :], threshold, dims=dims, refine=refine, qpd=self._qpd_row(qpd), rowmask=rowmask
        )[0]

    def search_approx_batch(self, queries, thresholds, *, dims: int, refine: int, qpd=None, rowmask=None):
        """Batched approximate threshold search over the prefix-pivot band.
        Returns a list of Q (result_indices, QueryStats) pairs."""
        q_t = torch.atleast_2d(self._tensor(queries))
        Q = q_t.shape[0]
        thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (Q,))
        lwb, upb, pivot_calls, tr = self._approx_bounds(q_t, dims, qpd, rowmask)
        out = []
        for qi in range(Q):
            dist = self._dist_fn(q_t[qi])
            ids, n_eval, n_bound_only, n_cand, width = approx_search_from_bounds(
                lambda rows, dist=dist: dist(tr(rows)), lwb[qi], upb[qi], thresholds[qi], refine
            )
            stats = QueryStats(
                original_calls=pivot_calls + n_eval,
                surrogate_calls=self.n_rows,
                accepted_no_check=n_bound_only,
                candidates=n_cand,
                bound_width=width,
            )
            out.append((tr(ids), stats))
        return out

    # -- exact k-NN -------------------------------------------------------------
    def knn(self, q, k: int, qpd=None, radius_hint: float = None, rowmask=None):
        """Exact k nearest neighbours of one query.  Returns (ids, distances,
        QueryStats); ids sorted by (distance, id).

        ``qpd``: precomputed (n,) query-pivot distances (charges 0 pivot
        calls here); ``radius_hint``: external sound cap on any useful
        result distance (the result is then the exact top-k restricted to
        ``d <= radius_hint``); ``rowmask``: the top-k over the allowed rows.

        A block of one through ``knn_batch``, so the selection runs on the
        device: the same radius (k-th smallest upb, capped, plus the slack
        of ``max(upb)``) and the same (lwb, id)-ordered candidates as the
        JAX package's ``knn``, whose ``surrogate_calls`` counts every row
        even under a ``rowmask``.
        """
        ids, d, stats = self.knn_batch(
            self._tensor(q)[None, :], k, qpd=self._qpd_row(qpd), radius_hint=radius_hint, rowmask=rowmask
        )[0]
        stats.surrogate_calls = self.n_rows
        return ids, d, stats

    def knn_batch(self, queries, k: int, qpd=None, radius_hint=None, rowmask=None):
        """Exact k-NN for a query block in one tiled scan on the device.

        Each tile's bounds update a running k smallest upper bounds per
        query (the radius seed) and collect the rows whose lower bound is
        under the running cutoff (a superset, since the cutoff only
        shrinks); after the scan the final radius ``kth + slack`` filters
        them and one stable sort orders each query's survivors by
        (lwb, id).  No (Q, N) bound matrix exists.  The refinement runs the
        reference's shrinking-radius loop on the host.

        With a ``rowmask`` the scan runs over the compacted allowed rows and
        ids translate back at the end.  Returns Q (ids, distances,
        QueryStats) triples.
        """
        q_t = torch.atleast_2d(self._tensor(queries))
        qds = self.query_distances_batch(q_t, qpd=qpd)
        pivot_calls = self.n_pivots if qpd is None else 0
        Q = qds.shape[0]
        if radius_hint is None:
            hint = torch.full((Q,), np.inf, dtype=torch.float64, device=self.device)
        else:
            hint = self._tensor(np.broadcast_to(np.asarray(radius_hint, dtype=np.float64), (Q,)).copy())
        mask = self._mask_of(rowmask)
        table, sel = self.table, None
        if mask is not None:
            sel = np.flatnonzero(mask)
            table = table[torch.as_tensor(sel, device=self.device)]
        N = table.shape[0]
        k_eff = min(int(k), N)
        if k_eff <= 0:
            return [
                (
                    np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float64),
                    QueryStats(original_calls=pivot_calls, surrogate_calls=N),
                )
                for _ in range(Q)
            ]
        # the radius slack depends on max(upb) over ALL rows, known only at
        # scan end; pivot column 0 alone gives a sound per-query overestimate
        # (upb = min_i qd_i + T[x,i] <= qd_0 + max T[:,0]), so collecting
        # under kth + slack_ub keeps a superset of the final candidates
        ub0 = qds[:, 0] + torch.clamp_min(table[:, 0].max(), 0.0)
        slack_ub = 1e-9 * torch.clamp_min(ub0, 1.0) + 1e-12
        kbest = torch.full((Q, k_eff), np.inf, dtype=torch.float64, device=self.device)
        max_upb = torch.zeros(Q, dtype=torch.float64, device=self.device)
        parts = []
        for lo, hi in self._tiles(table, Q, self.n_pivots):
            cols = table[lo:hi]
            l_, u_ = self._tile_lwb(qds, cols), self._tile_upb(qds, cols)
            kbest = torch.topk(torch.cat([kbest, u_], dim=1), k_eff, dim=1, largest=False).values
            max_upb = torch.maximum(max_upb, u_.amax(dim=1))
            # an external radius hint (a fan-out's running global k-th)
            # caps the collection cutoff from the start
            cutoff = torch.minimum(kbest[:, -1], hint) + slack_ub
            qi, col = torch.nonzero(l_ <= cutoff[:, None], as_tuple=True)
            parts.append((qi, col + lo, l_[qi, col]))
        r0 = torch.minimum(kbest[:, -1], hint)
        slack = 1e-9 * torch.clamp_min(max_upb, 1.0) + 1e-12
        radius = r0 + slack
        qi, ids, lw = (torch.cat(p) for p in zip(*parts))
        keep = lw <= radius[qi]
        qi, ids, lw = qi[keep], ids[keep], lw[keep]
        # each query's entries arrive in ascending id order (tiles ascend),
        # so a stable sort by lwb, then a stable sort by query, leaves every
        # query's survivors in (lwb, id) order
        order = torch.sort(lw, stable=True).indices
        qi, ids, lw = qi[order], ids[order], lw[order]
        order = torch.sort(qi, stable=True).indices
        ids, lw = ids[order].cpu().numpy(), lw[order].cpu().numpy()
        ends = np.cumsum(torch.bincount(qi, minlength=Q).cpu().numpy())
        radius, slack = radius.cpu().numpy(), slack.cpu().numpy()
        if sel is not None:
            # compacted positions -> row ids; sel ascending keeps the order
            ids = sel[ids]

        out = []
        for q in range(Q):
            start = ends[q - 1] if q else 0
            idq, lwb_q = ids[start:ends[q]], lw[start:ends[q]]
            stats = QueryStats(original_calls=pivot_calls, surrogate_calls=N, candidates=int(idq.shape[0]))
            got, d, n_eval = knn_refine_candidates(
                self._dist_fn(q_t[q]), idq, lwb_q, k_eff, float(radius[q]), float(slack[q])
            )
            stats.original_calls += n_eval
            out.append((got, d, stats))
        return out

    # -- exact range search ---------------------------------------------------
    def search(self, q, threshold: float, qpd=None, rowmask=None):
        """Exact threshold search. Returns (result_indices, QueryStats)."""
        stats = QueryStats()
        q_t = self._tensor(q)
        qd = self.query_distances(q_t, qpd=qpd)
        stats.original_calls += self.n_pivots if qpd is None else 0
        stats.surrogate_calls += self.n_rows
        cand = self.filter_candidates(qd, threshold)
        mask = self._mask_of(rowmask)
        if mask is not None:
            cand = cand[mask[cand]]
        stats.candidates = len(cand)
        if len(cand) == 0:
            return np.empty(0, dtype=np.int64), stats
        d = self._dist_fn(q_t)(cand)
        stats.original_calls += len(cand)
        return cand[d <= threshold], stats

    def search_batch(self, queries, thresholds, qpd=None, rowmask=None):
        """Exact threshold search for a query block: the Chebyshev filter of
        all Q queries in one tiled scan on the device; only the per-query
        survivor sets touch the original metric.

        Returns a list of Q (result_indices, QueryStats) pairs, matching
        ``search``.
        """
        q_t = torch.atleast_2d(self._tensor(queries))
        Q = q_t.shape[0]
        rmask = self._mask_of(rowmask)
        thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (Q,))
        qd = self.query_distances_batch(q_t, qpd=qpd)
        pivot_calls = self.n_pivots if qpd is None else 0
        t_col = self._tensor(thresholds.copy())[:, None]
        qi, ids = [], []
        for lo, hi in self._tiles(self.table, Q, self.n_pivots):
            q_, col = torch.nonzero(self._tile_lwb(qd, self.table[lo:hi]) <= t_col, as_tuple=True)
            qi.append(q_)
            ids.append(col + lo)
        qi, ids = torch.cat(qi), torch.cat(ids)
        # stable by query: each query's ids stay ascending (tiles ascend)
        order = torch.sort(qi, stable=True).indices
        ids = ids[order].cpu().numpy()
        ends = np.cumsum(torch.bincount(qi, minlength=Q).cpu().numpy())

        out = []
        for q in range(Q):
            stats = QueryStats(original_calls=pivot_calls, surrogate_calls=self.n_rows)
            cand = ids[(ends[q - 1] if q else 0):ends[q]]
            if rmask is not None:
                cand = cand[rmask[cand]]
            stats.candidates = len(cand)
            if len(cand) == 0:
                out.append((np.empty(0, dtype=np.int64), stats))
                continue
            d = self._dist_fn(q_t[q])(cand)
            stats.original_calls += len(cand)
            out.append((cand[d <= thresholds[q]], stats))
        return out
