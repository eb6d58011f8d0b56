"""n-simplex apex-table index (the paper's N_seq mechanism), exact and
approximate (truncated-surrogate) paths.

Same table discipline as LAESA — n numbers per object — but each row holds
the apex coordinates φ_n(s), and the filter is l2 in apex space with two
sides: the lower bound excludes, the upper bound admits without touching
the original space.

The index holds on its device the corpus in its input dtype, the float64
apex table, and the float32 twin the bound-scan kernels read.  There is one
scan path, the JAX package's ``use_kernel=True`` algorithm: the f32 bounds
come from the kernels (``repro_torch.kernels``) — CUDA on a card, their
plain versions on the CPU — and every decision is widened by the f32 error
bound ``_kernel_err_sq`` and re-taken exactly in float64 on the host, so
the answers are exact.  ``use_kernel`` is accepted and persisted for
manifest compatibility only.

Per query the host runs the same small control flow as the reference (the
shrinking-radius refinement, threshold re-filters, cost ledger), so ids,
tie order and ``QueryStats`` follow it; original-space distances are
evaluated on the device.

The approximate paths measure only ``dims`` pivot distances per query,
project them through the ``dims``-prefix projector (K4), and scan the table
truncated to ``dims`` coordinates: k-NN ranks rows by the f32 mid-point key
in K2 and re-ranks the best ``refine`` with the true metric; range search
keeps both sound bound sides through K3 and decides the straddlers as
``index.approx`` does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import NSimplexProjector
from repro_torch.device import resolve_device
from repro_torch.index.approx import approx_knn_from_pairs, approx_search_decide
from repro_torch.index.knn import knn_refine, knn_refine_candidates
from repro_torch.index.rows import DeviceRows, device_rows
from repro_torch.index.stats import QueryStats
from repro_torch.kernels import (
    SENTINEL_ID,
    apex_bounds,
    apex_bounds_batch,
    apex_bounds_threshold,
    apex_bounds_topk,
)
from repro_torch.kernels.ops import threshold_chunk
from repro_torch.kernels.ref import split_trunc
from repro_torch.metrics import Metric

__all__ = ["NSimplexIndex"]

#: candidate capacity of the range-search threshold epilogue
_RANGE_CAP = 4096


class NSimplexIndex(DeviceRows):
    """Apex table + fused two-sided bound filter on one device."""

    def __init__(
        self,
        data,
        pivots,
        metric: Metric,
        *,
        eps: float = 1e-6,
        use_kernel: bool = True,
        projector: NSimplexProjector = None,
        device="cuda",
    ):
        """``projector`` (optional) reuses an already-fitted simplex: no
        inter-pivot distance is re-measured."""
        self.device = resolve_device(device)
        self.data = device_rows(data, self.device)
        self.metric = metric
        self.eps = float(eps)
        self.use_kernel = bool(use_kernel)
        if projector is None:
            projector = NSimplexProjector(pivots, metric, device=self.device)
        elif projector.device != self.device:
            raise ValueError(f"projector lives on {projector.device}, index on {self.device}")
        self.projector = projector
        if self.data.shape[0]:
            self.table = projector(self.data)
        else:
            self.table = torch.zeros((0, projector.n_pivots), dtype=torch.float64, device=self.device)
        self._reset_caches()

    def _reset_caches(self):
        self._table_f32 = None      # float32 twin of the table (kernel operand)
        self._row_sq_max = None     # max squared row norm (slack bound)
        self._trunc = {}            # dims -> prefix projector
        #: queries whose K3 count exceeds its capacity: k-NN pass B's (then
        #: K3 again at a width that holds them), range's (then K1 per query)
        self.overflow_queries = 0

    @property
    def n_pivots(self) -> int:
        return self.projector.n_pivots

    # -- persistence ----------------------------------------------------------
    def state_arrays(self) -> dict:
        """Host numpy copies of everything needed to restore without
        re-measuring: the same keys as the JAX package's ``state_arrays``."""
        return {
            "data": self.data.cpu().numpy(),
            "pivots": self.projector.pivots,
            "table": self.table.cpu().numpy(),
            "sigma": self.projector.sigma,
            "Linv": self.projector.Linv,
            "sq_norms": self.projector.sq_norms,
        }

    @classmethod
    def from_state(
        cls, arrays: dict, metric: Metric, *, eps: float = 1e-6, use_kernel: bool = True, device="cuda"
    ) -> "NSimplexIndex":
        """Rebuild from a ``state_arrays`` dict (this package's or the JAX
        package's): no distance is re-measured, so the table is bit-identical."""
        index = object.__new__(cls)
        index.device = resolve_device(device)
        index.data = torch.tensor(np.asarray(arrays["data"]), device=index.device)
        index.metric = metric
        index.eps = float(eps)
        index.use_kernel = bool(use_kernel)
        index.projector = NSimplexProjector.from_fitted(
            arrays["pivots"], metric, arrays["sigma"], arrays["Linv"], arrays["sq_norms"],
            device=index.device,
        )
        index.table = torch.tensor(np.asarray(arrays["table"], dtype=np.float64), device=index.device)
        index._reset_caches()
        return index

    def extended(self, rows) -> "NSimplexIndex":
        """Functional append: a NEW index over this index's rows plus
        ``rows``, sharing the fitted projector.  Per new row: n pivot
        distances through ``Metric.cross`` (K5 for Jensen-Shannon) and its
        apex through the projector (K4), exactly as a fresh build computes
        them; the simplex is never refit and existing table rows carry over
        bit for bit.  ``self`` is never mutated and the new index builds its
        own f32 twin and truncation caches, so readers holding ``self``
        (point-in-time views) keep a consistent segment."""
        rows = torch.atleast_2d(device_rows(rows, self.device))
        if not rows.shape[0]:
            return self
        out = object.__new__(type(self))
        out.device = self.device
        out.data = torch.cat([self.data, rows]) if self.n_rows else rows
        out.metric = self.metric
        out.eps = self.eps
        out.use_kernel = self.use_kernel
        out.projector = self.projector
        tab = self.projector(rows)
        out.table = torch.cat([self.table, tab]) if self.n_rows else tab
        out._reset_caches()
        return out

    # -- operands -------------------------------------------------------------
    def _kernel_table(self) -> torch.Tensor:
        # lazy fills build their value, bind it once and return the local:
        # read views share segments across threads (a racing fill binds an
        # equal value twice, never a partial one)
        table = self._table_f32
        if table is None:
            table = self._table_f32 = self.table.to(torch.float32).contiguous()
        return table

    def _kernel_err_sq(self, apexes: np.ndarray) -> float:
        """Absolute error bound on the kernels' SQUARED f32 bounds.

        The kernels evaluate |x-y|² as |x|² + |y|² - 2<x,y> in float32; a
        length-m dot product accumulates O(m · eps32 · (|x|² + |y|²)) error.
        """
        row_sq_max = self._row_sq_max
        if row_sq_max is None:
            row_sq_max = self._row_sq_max = (
                float((self.table * self.table).sum(dim=1).max()) if self.n_rows else 0.0
            )
        a = np.atleast_2d(apexes)
        q_sq_max = float(np.max(np.einsum("qd,qd->q", a, a)))
        c = 4.0 * (self.n_pivots + 8)
        return c * np.finfo(np.float32).eps * (row_sq_max + q_sq_max)

    def _kernel_slack(self, apexes: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
        """Per-query distance slack covering the f32 bound error near each
        threshold t (~err_sq / 2t): decisions inside it are rechecked."""
        err_sq = self._kernel_err_sq(apexes)
        return err_sq / (2.0 * np.maximum(thresholds, 1e-12)) + 1e-12

    def _prefix_projector(self, dims: int) -> NSimplexProjector:
        dims = int(dims)
        if not (2 <= dims <= self.n_pivots):
            raise ValueError(f"dims must be in [2, {self.n_pivots}]; got {dims}")
        proj = self._trunc.get(dims)
        if proj is None:
            proj = self._trunc[dims] = self.projector.truncate(dims)
        return proj

    def pivot_rows(self, dims: int = None) -> np.ndarray:
        """The pivot objects a query measures against: all of them, or the
        ``dims``-prefix (the contract behind precomputed ``qpd`` blocks)."""
        return self.projector.pivots if dims is None else self._prefix_projector(dims).pivots

    def query_apex(self, q, qpd=None) -> torch.Tensor:
        """(n,) float64 apex of one query on the index's device."""
        if qpd is None:
            qpd = self.metric.cross(self._tensor(q)[None, :], self.projector.pivots_t)[0]
        return self.projector.project_distances(qpd)

    def query_apex_batch(self, queries, dims: int = None, qpd=None) -> torch.Tensor:
        """(Q, n) float64 apexes of a query block (``dims=k``: (Q, k) from the
        k-pivot prefix); ``qpd`` supplies measured query-pivot distances."""
        proj = self.projector if dims is None else self._prefix_projector(dims)
        if qpd is None:
            qpd = self.metric.cross(torch.atleast_2d(self._tensor(queries)), proj.pivots_t)
        return torch.atleast_2d(proj.project_distances(qpd))

    def bounds(self, query_apex: torch.Tensor):
        """(lwb, upb) of one query apex against every row, through K6 on the
        f32 twin; float64 tensors on the index's device."""
        lwb, upb = apex_bounds(self._kernel_table(), self._tensor(query_apex).to(torch.float32))
        return lwb.to(torch.float64), upb.to(torch.float64)

    def bounds_batch(self, query_apexes: torch.Tensor, dims: int = None):
        """(lwb, upb), each (Q, N), of a query-apex block through K1 on the
        f32 twin (``dims=k``: truncated k-prefix bounds; the apexes may be
        n or k wide); float64 tensors on the index's device."""
        qa = torch.atleast_2d(self._tensor(query_apexes)).to(torch.float32)
        lwb, upb = apex_bounds_batch(self._kernel_table(), qa, dims=dims)
        return lwb.to(torch.float64), upb.to(torch.float64)

    @staticmethod
    def _host(*tensors):
        return tuple(t.cpu().numpy() for t in tensors)

    # -- range search ---------------------------------------------------------
    def search(self, q, threshold: float, qpd=None, rowmask=None):
        """Exact threshold search of one query: (sorted ids, QueryStats).

        ``qpd``: precomputed (n,) query-pivot distances (charges 0 pivot
        calls here); ``rowmask``: allowed-row restriction.
        """
        stats = QueryStats()
        q_t = self._tensor(q)
        apex = self.query_apex(q_t, qpd=qpd)
        stats.original_calls += self.n_pivots if qpd is None else 0
        stats.surrogate_calls += self.n_rows
        lwb, upb = self._host(*self.bounds(apex))
        t_hi = threshold * (1.0 + self.eps) + 1e-12
        t_lo = threshold * (1.0 - self.eps) - 1e-12
        # f32 slack guard: borderline rows are rechecked exactly
        slack = float(self._kernel_slack(apex.cpu().numpy()[None, :], np.asarray([threshold]))[0])
        t_hi = t_hi + slack
        t_lo = t_lo - slack
        accepted = np.where(upb <= t_lo)[0]
        recheck = np.where((lwb <= t_hi) & (upb > t_lo))[0]
        mask = self._mask_of(rowmask)
        if mask is not None:
            accepted = accepted[mask[accepted]]
            recheck = recheck[mask[recheck]]
        stats.accepted_no_check = len(accepted)
        stats.candidates = len(accepted) + len(recheck)
        if len(recheck):
            d = self._dist_fn(q_t)(recheck)
            stats.original_calls += len(recheck)
            confirmed = recheck[d <= threshold]
        else:
            confirmed = np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate([accepted, confirmed])), stats

    def _threshold_pairs_kernel(self, apexes: torch.Tensor, t_cand: np.ndarray, dims: int = None, mask=None):
        """Per-query candidate (ids, lwb, upb) with ``lwb <= t_cand[q]``
        through K3 — ids ascending, bounds float64.

        The f32 threshold is raised one ulp (a superset), then the exact f64
        comparison re-filters.  A query whose count overflows the capacity
        takes per-query K1 instead.
        """
        N = self.n_rows
        Q = apexes.shape[0]
        t_cand = np.asarray(t_cand, dtype=np.float64)
        t32 = np.nextafter(t_cand.astype(np.float32), np.float32(np.inf))
        cap = int(min(N, _RANGE_CAP))
        ids_k, lwb_k, upb_k, counts = self._host(
            *apex_bounds_threshold(
                self._kernel_table(), apexes.to(torch.float32), self._tensor(t32), cap,
                dims=dims, rowmask=self._device_mask(mask),
            )
        )
        lwb_k = lwb_k.astype(np.float64)
        upb_k = upb_k.astype(np.float64)
        out = []
        for qi in range(Q):
            if counts[qi] > cap:
                self.overflow_queries += 1
                lwb, upb = self._host(*self.bounds_batch(apexes[qi][None, :], dims=dims))
                cond = lwb[0] <= t_cand[qi]
                if mask is not None:
                    cond &= mask
                cand = np.where(cond)[0]
                out.append((cand.astype(np.int64), lwb[0][cand], upb[0][cand]))
                continue
            m = int(counts[qi])
            idq, l, u = ids_k[qi, :m], lwb_k[qi, :m], upb_k[qi, :m]
            live = idq != SENTINEL_ID
            idq, l, u = idq[live], l[live], u[live]
            keep = l <= t_cand[qi]
            idq, l, u = idq[keep], l[keep], u[keep]
            order = np.argsort(idq, kind="stable")   # ascending id, like np.where
            out.append((idq[order].astype(np.int64), l[order], u[order]))
        return out

    def _threshold_candidates_kernel(self, apexes, t_admit: np.ndarray, t_cand: np.ndarray, dims: int = None, mask=None):
        """Per-query (accepted, recheck) id sets: accepted by the upper bound,
        recheck for the straddlers."""
        out = []
        for qi, (idq, _l, u) in enumerate(
            self._threshold_pairs_kernel(apexes, t_cand, dims=dims, mask=mask)
        ):
            admit = u <= t_admit[qi]
            out.append((idq[admit], idq[~admit]))
        return out

    def search_batch(self, queries, thresholds, qpd=None, rowmask=None):
        """Exact threshold search for a query block: one pivot-distance call,
        one projection and one fused K3 scan for the whole block; only the
        per-query recheck sets touch the original metric.

        Returns a list of Q (result_indices, QueryStats) pairs.
        """
        q_t = torch.atleast_2d(self._tensor(queries))
        Q = q_t.shape[0]
        thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (Q,))
        apexes = self.query_apex_batch(q_t, qpd=qpd)
        pivot_calls = self.n_pivots if qpd is None else 0
        mask = self._mask_of(rowmask)
        t_hi = thresholds * (1.0 + self.eps) + 1e-12
        t_lo = thresholds * (1.0 - self.eps) - 1e-12
        slack = self._kernel_slack(apexes.cpu().numpy(), thresholds)
        per_query = self._threshold_candidates_kernel(apexes, t_lo - slack, t_hi + slack, mask=mask)
        out = []
        for qi in range(Q):
            stats = QueryStats()
            stats.original_calls += pivot_calls
            stats.surrogate_calls += self.n_rows
            accepted, recheck = per_query[qi]
            stats.accepted_no_check = len(accepted)
            stats.candidates = len(accepted) + len(recheck)
            if len(recheck):
                d = self._dist_fn(q_t[qi])(recheck)
                stats.original_calls += len(recheck)
                confirmed = recheck[d <= thresholds[qi]]
            else:
                confirmed = np.empty(0, dtype=np.int64)
            out.append((np.sort(np.concatenate([accepted, confirmed])), stats))
        return out

    # -- k-NN -----------------------------------------------------------------
    def _knn_one(self, q: torch.Tensor, apex: np.ndarray, lwb: np.ndarray, upb: np.ndarray, k: int,
                 stats: QueryStats, radius_cap: float = None, sel: np.ndarray = None):
        """Shrinking-radius refinement of one query given its (N,) f32-derived
        bounds.  ``sel``: ascending allowed row positions (bounds are
        compacted to them, so a masked row never seeds the radius)."""
        if sel is not None:
            if sel.size == 0:
                return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.float64), stats
            lwb, upb = lwb[sel], upb[sel]
        # widen in the SQUARED domain by the f32 error bound: sound bounds
        err_sq = self._kernel_err_sq(apex[None, :])
        lwb = np.sqrt(np.maximum(lwb**2 - err_sq, 0.0))
        upb = np.sqrt(upb**2 + err_sq)
        dist = self._dist_fn(q)
        rows_of = (lambda rows: rows) if sel is None else (lambda rows: sel[rows])
        ids, d, n_eval, n_cand = knn_refine(
            lambda rows: dist(rows_of(rows)),
            lwb,
            upb,
            k,
            slack=1e-12,
            rel_slack=self.eps,
            radius_cap=radius_cap,
        )
        if sel is not None:
            ids = sel[ids]
        stats.original_calls += n_eval
        stats.candidates = n_cand
        return ids, d, stats

    def knn(self, q, k: int, qpd=None, radius_hint: float = None, rowmask=None):
        """Exact k nearest neighbours of one query through K6: (ids,
        distances, QueryStats), ids sorted by (distance, id).

        ``radius_hint``: external sound cap on any useful result distance;
        ``rowmask``: the top-k over the allowed rows only.
        """
        stats = QueryStats()
        q_t = self._tensor(q)
        apex = self.query_apex(q_t, qpd=qpd)
        stats.original_calls += self.n_pivots if qpd is None else 0
        stats.surrogate_calls += self.n_rows
        lwb, upb = self._host(*self.bounds(apex))
        mask = self._mask_of(rowmask)
        sel = None if mask is None else np.flatnonzero(mask)
        return self._knn_one(q_t, apex.cpu().numpy(), lwb, upb, k, stats, radius_cap=radius_hint, sel=sel)

    def knn_batch(self, queries, k: int, qpd=None, radius_hint=None, rowmask=None):
        """Exact k-NN for a query block through the fused selection
        epilogues: K2 seeds each query's radius from its k-th upper bound,
        K3 compacts its candidate prefix, and the refinement touches the
        original metric only inside it.  No (Q, N) bound matrix exists.

        Returns a list of Q (ids, distances, QueryStats) triples.
        """
        q_t = torch.atleast_2d(self._tensor(queries))
        with tracing.span("nsimplex.project", Q=q_t.shape[0]):
            apexes = self.query_apex_batch(q_t, qpd=qpd)
            apexes_np = apexes.cpu().numpy()
        pivot_calls = self.n_pivots if qpd is None else 0
        N = self.n_rows
        mask = self._mask_of(rowmask)
        n_live = N if mask is None else int(mask.sum())
        if min(int(k), n_live) <= 0:
            return [
                (
                    np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float64),
                    QueryStats(original_calls=pivot_calls, surrogate_calls=N),
                )
                for _ in range(q_t.shape[0])
            ]
        return self._knn_batch_kernel(q_t, apexes, apexes_np, k, pivot_calls, radius_hint, mask=mask)

    def _knn_batch_kernel(self, q_t, apexes: torch.Tensor, apexes_np: np.ndarray, k: int, pivot_calls: int,
                          radius_hint=None, mask=None):
        N = self.n_rows
        Q = q_t.shape[0]
        n_live = N if mask is None else int(mask.sum())
        k_eff = min(int(k), n_live)
        hint = np.full(Q, np.inf) if radius_hint is None else np.asarray(radius_hint, dtype=np.float64)
        cap = int(min(N, max(512, 16 * k_eff)))
        tab = self._kernel_table()
        ap32 = apexes.to(torch.float32)
        mask_t = self._device_mask(mask)
        err_sq = self._kernel_err_sq(apexes_np)
        # pass A: the k-th smallest upper bound seeds each query's radius; the
        # widening sqrt(x² + err) is monotone, so the k-th widened upb is the
        # widened k-th raw upb.  Masked rows never enter the selection.
        with tracing.span("nsimplex.pass_a", Q=Q, k=k_eff):
            _, _, upb_k = apex_bounds_topk(tab, ap32, k_eff, key="upb", rowmask=mask_t)
            kth = upb_k[:, -1].cpu().numpy().astype(np.float64)
        # an external radius hint may only shrink the radius; the slack keeps
        # the hint boundary (d == hint) inclusive
        r0 = np.minimum(np.sqrt(kth**2 + err_sq), hint)
        slack = 1e-12 + self.eps * r0
        radius = r0 + slack
        # candidate condition in the kernel's raw-f32 domain:
        #   sqrt(max(lwb² - err, 0)) <= radius  <=>  lwb <= sqrt(radius² + err)
        # rounded UP one ulp (a superset), re-filtered exactly below
        t_cand = np.sqrt(radius**2 + err_sq)
        t32 = np.nextafter(t_cand.astype(np.float32), np.float32(np.inf))
        t32_t = self._tensor(t32)
        with tracing.span("nsimplex.pass_b", Q=Q, cap=cap):
            ids_k, lwb_k, _, counts = self._host(*apex_bounds_threshold(tab, ap32, t32_t, cap, rowmask=mask_t))

        def refine(qi, idq, lwb_q, err, radius_q, slack_q, dense=False):
            stats = QueryStats(original_calls=pivot_calls, surrogate_calls=N)
            # exact widened-f64 re-filter: K3's output ascends by (lwb, id)
            # with its empty slots (SENTINEL_ID, +inf) last, and widening is
            # monotone, so the rows kept are the prefix up to a finite radius
            lwb_w = np.sqrt(np.maximum(lwb_q.astype(np.float64) ** 2 - err, 0.0))
            n = int(np.searchsorted(lwb_w, radius_q, side="right"))
            idq, lwb_w = idq[:n], lwb_w[:n]
            if dense:
                # widening clamps every lwb under sqrt(err) to 0; the dense
                # route orders that prefix by id, K3 by raw lwb
                idq[:int(np.searchsorted(lwb_w, 0.0, side="right"))].sort()
            stats.candidates = int(idq.shape[0])
            ids, d, n_eval = knn_refine_candidates(
                self._dist_fn(q_t[qi]), idq, lwb_w, k_eff, float(radius_q), float(slack_q)
            )
            stats.original_calls += n_eval
            return ids, d, stats

        out = [None] * Q
        for qi in np.flatnonzero(counts <= cap):
            m = int(counts[qi])
            out[qi] = refine(qi, ids_k[qi, :m], lwb_k[qi, :m], err_sq, radius[qi], slack[qi])
        over = np.flatnonzero(counts > cap)
        if over.size:
            self.overflow_queries += int(over.size)
            prefixes = self._overflow_prefixes(tab, ap32, t32_t, counts[over], over, mask_t)
            spans = []
            with tracing.span("nsimplex.overflow.select", Q=int(over.size)):
                for qi, (idq, lwb_q) in zip(over, prefixes):
                    t0 = time.perf_counter()
                    # the dense route's widening, radius and slack: this query's
                    # own error bound, not the batch's (smaller, so the prefix
                    # holds every candidate)
                    err = self._kernel_err_sq(apexes_np[qi][None, :])
                    r0 = min(float(np.sqrt(kth[qi] ** 2 + err)), hint[qi])
                    slack_q = 1e-12 + self.eps * r0
                    out[qi] = refine(qi, idq, lwb_q, err, r0 + slack_q, slack_q, dense=True)
                    spans.append((t0, time.perf_counter()))
            # one record a query, beside the select span: its self time stays whole
            for qi, (t0, t1) in zip(over, spans):
                tracing.record("nsimplex.overflow", t0, t1, count=int(counts[qi]), cap=cap)
        return out

    def _overflow_prefixes(self, tab, ap32, t32_t, want: np.ndarray, over: np.ndarray, mask_t):
        """The k-NN overflow route's bounds: K3 once more over just the
        queries ``over``, whose pass-B counts ``want`` exceed its capacity,
        with pass B's thresholds and mask, at ``W = min(N, next power of two
        >= max(want))``, which holds every count.  The queries go
        ``threshold_chunk`` at a time, so a chunk's outputs and scratch stay
        within the selection budget, and each chunk's counts and its queries'
        (id, f32 lwb) prefixes come to the host in one packed int32 copy.
        Returns per query its (ids int32, lwb float32) prefix, sorted by
        (lwb, id): pass B's candidates, uncut."""
        N = self.n_rows
        want = want.astype(np.int64)
        width = int(min(N, 1 << (int(want.max()) - 1).bit_length()))
        chunk = threshold_chunk(width, len(over), N, tab.dtype)
        rows = torch.as_tensor(over, device=self.device)
        cols = torch.arange(width, device=self.device)
        out = []
        with tracing.span("nsimplex.overflow.bounds", Q=int(over.size), width=width):
            for lo in range(0, len(over), chunk):
                part = rows[lo:lo + chunk]
                ids, lwb, _, got = apex_bounds_threshold(tab, ap32[part], t32_t[part], width, rowmask=mask_t)
                pairs = torch.stack((ids, lwb.view(torch.int32)), dim=-1)[cols < got[:, None]]
                packed = torch.cat((got, pairs.reshape(-1))).cpu().numpy()
                n_q, c = len(part), want[lo:lo + len(part)]
                if not np.array_equal(packed[:n_q], c):
                    raise RuntimeError(f"K3 re-run counts {packed[:n_q]} differ from pass B's {c}")
                pairs = packed[n_q:].reshape(-1, 2)
                bits = pairs.view(np.float32)
                ends = np.cumsum(c)
                out.extend((pairs[a:b, 0], bits[a:b, 1]) for a, b in zip(ends - c, ends))
        return out

    # -- approximate paths (truncated-apex surrogate) --------------------------
    def truncated_table(self, dims: int) -> torch.Tensor:
        """The (N, dims) float64 truncated apex table (the approximate
        surrogate): the first ``dims - 1`` coordinates, then the tail folded
        into ``sqrt(Σ x_i²)``; the table itself at ``dims = n``."""
        dims = self._prefix_projector(dims).n_pivots
        if dims == self.n_pivots:
            return self.table
        head, alt = split_trunc(self.table, dims)
        return torch.cat([head, alt[:, None]], dim=1)

    def _qpd_row(self, qpd):
        """One query's (dims,) pivot distances as the (1, dims) block."""
        return None if qpd is None else self._tensor(qpd).reshape(1, -1)

    def knn_approx(self, q, k: int, *, dims: int, refine: int, qpd=None, rowmask=None):
        """Approximate k-NN of one query: (ids, true distances, QueryStats)
        with ``stats.bound_width`` the achieved surrogate band width."""
        return self.knn_approx_batch(
            self._tensor(q)[None, :], k, dims=dims, refine=refine, qpd=self._qpd_row(qpd), rowmask=rowmask
        )[0]

    def knn_approx_batch(self, queries, k: int, *, dims: int, refine: int, qpd=None, rowmask=None):
        """Batched approximate k-NN: ``dims`` pivot distances per query, the
        ``m = min(max(refine, k), n_live)`` rows with the smallest truncated
        mid-point key, then the exact top-k of those ``m`` by the true metric.
        Masked rows never enter the candidates.

        Returns a list of Q (ids, distances, QueryStats) triples.
        """
        q_t = torch.atleast_2d(self._tensor(queries))
        dims = int(dims)
        apexes = self.query_apex_batch(q_t, dims=dims, qpd=qpd)
        pivot_calls = dims if qpd is None else 0
        N = self.n_rows
        mask = self._mask_of(rowmask)
        n_live = N if mask is None else int(mask.sum())
        k_eff = min(int(k), n_live)
        if k_eff <= 0:
            return [
                (
                    np.empty(0, dtype=np.int64),
                    np.empty(0, dtype=np.float64),
                    QueryStats(original_calls=pivot_calls, surrogate_calls=N),
                )
                for _ in range(q_t.shape[0])
            ]
        m = min(max(int(refine), k_eff), n_live)
        out = []
        for qi, (idq, lwb_q, upb_q) in enumerate(self._mid_candidates(apexes, m, dims, mask)):
            ids, d, n_eval, width = approx_knn_from_pairs(self._dist_fn(q_t[qi]), idq, lwb_q, upb_q, k)
            stats = QueryStats(
                original_calls=pivot_calls + n_eval, surrogate_calls=N, candidates=n_eval, bound_width=width
            )
            out.append((ids, d, stats))
        return out

    def _mid_candidates(self, apexes: torch.Tensor, m: int, dims: int, mask):
        """Per query the ``m`` rows with the smallest f32 ``(mid, id)`` key on
        the ``dims``-truncated table, as (ids, lwb, upb) host arrays (bounds
        float64), through K2 at any ``m``."""
        tab = self._kernel_table()
        ap32 = apexes.to(torch.float32)
        ids_k, lwb_k, upb_k = self._host(*apex_bounds_topk(tab, ap32, m, key="mid", dims=dims,
                                                               rowmask=self._device_mask(mask)))
        out = []
        for ids, lwb, upb in zip(ids_k, lwb_k, upb_k):
            live = ids != SENTINEL_ID
            out.append((ids[live].astype(np.int64), lwb[live].astype(np.float64), upb[live].astype(np.float64)))
        return out

    def search_approx(self, q, threshold: float, *, dims: int, refine: int, qpd=None, rowmask=None):
        """Approximate threshold search of one query: (ids, QueryStats)."""
        return self.search_approx_batch(
            self._tensor(q)[None, :], threshold, dims=dims, refine=refine, qpd=self._qpd_row(qpd), rowmask=rowmask
        )[0]

    def search_approx_batch(self, queries, thresholds, *, dims: int, refine: int, qpd=None, rowmask=None):
        """Batched approximate threshold search: the truncated upper bound
        still admits and the truncated lower bound still excludes, each
        behind the exact path's guard bands (relative ``eps`` and the f32
        slack), through K3; only the straddlers past the ``refine`` budget
        are decided by the mean estimate.

        Returns a list of Q (result_indices, QueryStats) pairs.
        """
        q_t = torch.atleast_2d(self._tensor(queries))
        Q = q_t.shape[0]
        dims = int(dims)
        thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (Q,))
        apexes = self.query_apex_batch(q_t, dims=dims, qpd=qpd)
        pivot_calls = dims if qpd is None else 0
        mask = self._mask_of(rowmask)
        t_hi = thresholds * (1.0 + self.eps) + 1e-12
        t_lo = thresholds * (1.0 - self.eps) - 1e-12
        slack = self._kernel_slack(apexes.cpu().numpy(), thresholds)
        pairs = self._threshold_pairs_kernel(apexes, t_hi + slack, dims=dims, mask=mask)
        out = []
        for qi, (idq, lwb_q, upb_q) in enumerate(pairs):
            admit = upb_q <= t_lo[qi] - slack[qi]
            ids, n_eval, n_bound_only, n_cand, width = approx_search_decide(
                self._dist_fn(q_t[qi]), idq[admit], idq[~admit], lwb_q[~admit], upb_q[~admit],
                thresholds[qi], refine,
            )
            stats = QueryStats(
                original_calls=pivot_calls + n_eval,
                surrogate_calls=self.n_rows,
                accepted_no_check=n_bound_only,
                candidates=n_cand,
                bound_width=width,
            )
            out.append((ids, stats))
        return out
