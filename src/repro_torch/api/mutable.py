"""MutableIndex — LSM-style online mutations over an immutable base segment.

The paper's table mechanisms make this cheap: per-object state is n numbers
(apex coordinates / pivot distances), and a new row's entry is computed
against the *existing* fitted state (its n pivot distances, then the fitted
projector: K5 and K4 on the card) — no refit, no touching existing rows.

Layout:

  * **base segment**   — any plain index of ``repro_torch.api.indexes``,
    treated as immutable.  Slot ``i`` carries logical id ``base_ids[i]`` and
    a live flag (tombstones are per-physical-slot ``live`` masks).
  * **delta segment**  — a same-kind segment over the rows added since the
    last compaction, grown by functional ``extend`` and materialised lazily
    on the first query after a burst of adds.
  * **compaction**     — when (delta rows + tombstones) / live crosses
    ``compact_threshold`` the index only *marks* ``pending_compaction``; the
    fold (live rows into one fresh base segment, fitted config reused,
    ascending logical-id order) runs when ``compact()`` is called, so no
    ``add()`` carries a rebuild.

Segments, their rows and their tables live on the index's device; logical
ids, live flags and tombstones are host numpy arrays, as in the JAX
package's ``repro.api.mutable``.  Every write rebinds the arrays, tensors
and segments it changes (concatenation, copy-on-write masks, functional
``extend``) instead of writing into them, so ``read_view()`` hands readers a
point-in-time view that shares state with the live index at no copy cost.

Exactness contract: every query returns the ids — in (distance, id) tie
order — of a fresh ``build_index`` over the current live rows.  k-NN asks
each segment for ``k + its tombstone count`` neighbours, drops dead rows,
and re-queries an unordered segment with a doubled k whenever its last
returned distance does not strictly exceed the merged k-th distance (so a
boundary tie cannot hide a row).  Ids are stable logical ids that survive
compaction.  A predicate's row mask reaches each segment as its allowed
physical slots; the segment hands it to the bound-scan kernels (K2, K3) as
one uint8 mask on the device per batch.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.execute import QuerySurface
from repro_torch.api.indexes import _restore_options
from repro_torch.api.persistence import write_index_dir
from repro_torch.api.types import BatchQueryResult, QueryResult, QueryStats
from repro_torch.index.knn import knn_select

__all__ = ["MutableIndex"]


class _Side:
    """One physical segment (base or delta) with its logical-id mapping.

    ``ordered`` records whether physical slot order is ascending logical-id
    order.  An ordered side's exact top-k by (distance, slot) IS its top-k by
    (distance, logical id), so every unreturned row lexicographically exceeds
    the side's last returned pair — and therefore the merged k-th — and the
    merge never re-queries it.  An unordered side (a delta that saw an
    ``upsert``) is re-queried deeper whenever its last returned distance does
    not strictly exceed the merged k-th distance.
    """

    __slots__ = ("seg", "lids", "live", "n", "dead", "ordered")

    def __init__(self, seg, lids: np.ndarray, live: np.ndarray):
        self.seg = seg
        self.lids = lids
        self.live = live
        self.n = int(lids.shape[0])
        self.dead = int(self.n - int(live.sum()))
        self.ordered = bool(np.all(np.diff(lids) > 0)) if self.n else True


class MutableIndex(QuerySurface):
    """``Index`` + ``SupportsMutation`` over a base segment and an LSM delta."""

    kind = "mutable"

    def __init__(self, base, *, ids: Optional[np.ndarray] = None, compact_threshold: Optional[float] = 0.5):
        n = base.stats()["n_objects"]
        self._base = base
        self._base_ids = np.arange(n, dtype=np.int64) if ids is None else np.asarray(ids, dtype=np.int64)
        if self._base_ids.shape != (n,):
            raise ValueError(f"ids must be ({n},); got {self._base_ids.shape}")
        self._base_live = np.ones(n, dtype=bool)
        self._delta_data: Optional[torch.Tensor] = None   # (D, dim) all delta rows, on the device
        self._delta_ids = np.empty(0, dtype=np.int64)
        self._delta_live = np.empty(0, dtype=bool)
        self._delta_seg = None                            # segment over rows [:built]
        self._built = 0
        self._next_id = int(self._base_ids.max()) + 1 if n else 0
        self.compact_threshold = compact_threshold
        self.version = 0                                  # bumped on every mutation
        self.generation = 0                               # bumped on every compaction / fit
        self.compactions = 0                              # completed compactions
        self.pending_compaction = False                   # threshold crossed, fold deferred

    # -- introspection ---------------------------------------------------------
    @property
    def metric(self):
        return self._base.metric

    @property
    def device(self) -> torch.device:
        return self._base.device

    @property
    def data(self) -> torch.Tensor:
        """The live logical rows in ascending logical-id order (the corpus a
        fresh rebuild would be fitted on), gathered on the device."""
        rows = [self._base.data[torch.as_tensor(self._base_live, device=self.device)]]
        lids = [self._base_ids[self._base_live]]
        if self._delta_data is not None:
            rows.append(self._delta_data[torch.as_tensor(self._delta_live, device=self.device)])
            lids.append(self._delta_ids[self._delta_live])
        order = np.argsort(np.concatenate(lids), kind="stable")
        return torch.cat(rows)[torch.as_tensor(order, device=self.device)]

    def _n_live(self) -> int:
        return int(self._base_live.sum()) + int(self._delta_live.sum())

    def _check_rows(self, rows: np.ndarray) -> None:
        """Reject rows whose shape cannot join the corpus, before any state
        records the mutation."""
        dim = self._base.data.shape[1]
        if rows.ndim != 2 or (len(rows) and rows.shape[1] != dim):
            raise ValueError(f"rows must be (R, {dim}); got {rows.shape}")
        if len(rows) and not np.isfinite(rows).all():
            raise ValueError("rows must be finite (no NaN/Inf)")

    def ids(self) -> np.ndarray:
        """Live logical ids, ascending."""
        return np.sort(np.concatenate([self._base_ids[self._base_live], self._delta_ids[self._delta_live]]))

    def has_id(self, logical_id: int) -> bool:
        return self._locate(int(logical_id)) is not None

    def _locate(self, logical_id: int) -> Optional[Tuple[str, int]]:
        """("base"|"delta", physical slot) of the live copy, or None."""
        slot = int(np.searchsorted(self._base_ids, logical_id))
        if slot < self._base_ids.shape[0] and self._base_ids[slot] == logical_id and self._base_live[slot]:
            return ("base", slot)
        hits = np.nonzero((self._delta_ids == logical_id) & self._delta_live)[0]
        if len(hits):
            return ("delta", int(hits[0]))
        return None

    # -- mutations -------------------------------------------------------------
    def add(self, rows: np.ndarray, ids=None, attrs=None) -> np.ndarray:
        """Append rows to the delta; returns their logical ids.

        New rows are not refit: their table entries are computed against the
        base's fitted state when the delta segment materialises.  ``attrs``
        (a ``{column: values}`` dict) lands in the attached attribute store
        only after the add is accepted.
        """
        rows = np.atleast_2d(np.asarray(rows))
        self._check_rows(rows)
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + len(rows), dtype=np.int64)
            self._next_id += len(rows)
        else:
            ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
            if ids.shape != (len(rows),):
                raise ValueError(f"need {len(rows)} ids; got {ids.shape}")
            if len(np.unique(ids)) != len(ids):
                raise ValueError(f"duplicate ids in one add batch: {ids.tolist()}")
            for i in ids:
                if self._locate(int(i)) is not None:
                    raise KeyError(f"id {int(i)} is already live; use upsert")
            self._next_id = max(self._next_id, int(ids.max()) + 1)
        if not len(rows):
            return ids
        if attrs is not None:
            self._attrs_put(ids, attrs)
        rows_t = torch.as_tensor(rows, device=self.device)
        self._delta_data = rows_t if self._delta_data is None else torch.cat([self._delta_data, rows_t])
        self._delta_ids = np.concatenate([self._delta_ids, ids])
        self._delta_live = np.concatenate([self._delta_live, np.ones(len(rows), dtype=bool)])
        self.version += 1
        self._maybe_compact()
        return ids

    def remove(self, ids) -> None:
        """Tombstone live rows; KeyError/ValueError if any id is not live or
        repeated.  The whole batch is validated before any slot is touched,
        so a rejected remove leaves the index as it was."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if len(np.unique(ids)) != len(ids):
            raise ValueError(f"duplicate ids in one remove batch: {ids.tolist()}")
        locs = []
        for i in ids:
            loc = self._locate(int(i))
            if loc is None:
                raise KeyError(f"id {int(i)} not in index")
            locs.append(loc)
        self._tombstone(locs)
        self._attrs_drop(ids)
        self.version += 1
        self._maybe_compact()

    def _tombstone(self, locs) -> None:
        """Clear live flags of ("base"|"delta", slot) pairs, copy-on-write:
        the masks are replaced, never written in place, so read views and
        frozen copies sharing the old arrays keep their point-in-time state."""
        if any(side == "base" for side, _ in locs):
            self._base_live = self._base_live.copy()
        if any(side == "delta" for side, _ in locs):
            self._delta_live = self._delta_live.copy()
        for side, slot in locs:
            (self._base_live if side == "base" else self._delta_live)[slot] = False

    def upsert(self, ids, rows: np.ndarray, attrs=None) -> np.ndarray:
        """Replace (or insert) rows under the given logical ids.  With
        ``attrs=None`` existing attribute rows are kept (ids are stable);
        passing ``attrs`` overwrites them."""
        rows = np.atleast_2d(np.asarray(rows))
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        # validate before tombstoning: an error must not destroy the rows it
        # was about to replace
        self._check_rows(rows)
        if ids.shape != (len(rows),):
            raise ValueError(f"need {len(rows)} ids; got {ids.shape}")
        if len(np.unique(ids)) != len(ids):
            raise ValueError(f"duplicate ids in one upsert batch: {ids.tolist()}")
        self._tombstone([loc for loc in (self._locate(int(i)) for i in ids) if loc is not None])
        return self.add(rows, ids=ids, attrs=attrs)

    def _maybe_compact(self) -> None:
        """Threshold check only: crossing it sets ``pending_compaction``;
        the fold runs when ``compact()`` is called."""
        if self.compact_threshold is None:
            return
        n_live = self._n_live()
        n_pending = len(self._delta_ids) + int((~self._base_live).sum())
        if n_live and n_pending / n_live > self.compact_threshold:
            self.pending_compaction = True

    def compact(self) -> "MutableIndex":
        """Fold the live rows into one fresh base segment (fitted config
        reused) in ascending logical-id order; clears the delta and every
        tombstone."""
        self.pending_compaction = False
        if not len(self._delta_ids) and bool(self._base_live.all()):
            return self
        lids = [self._base_ids[self._base_live]]
        if self._delta_data is not None:
            lids.append(self._delta_ids[self._delta_live])
        lids = np.concatenate(lids)
        if len(lids):
            order = np.argsort(lids, kind="stable")
            self._base = self._base.spawn(self.data)
            self._base_ids = lids[order]
            self._base_live = np.ones(len(self._base_ids), dtype=bool)
        else:
            # everything deleted: keep the fitted base rows (some mechanisms
            # cannot fit an empty corpus); every slot stays dead
            self._base_live = np.zeros(len(self._base_ids), dtype=bool)
        self._delta_data = None
        self._delta_ids = np.empty(0, dtype=np.int64)
        self._delta_live = np.empty(0, dtype=bool)
        self._delta_seg = None
        self._built = 0
        self.version += 1
        self.generation += 1
        self.compactions += 1
        return self

    def frozen_copy(self) -> "MutableIndex":
        """A point-in-time copy sharing the immutable segments and device
        rows but owning private copies of every host array (ids, live
        masks), safe to fold or persist off-thread while the original keeps
        mutating: segments and device tensors are never written in place
        (``compact``/``fit`` rebind the base, ``extend`` is functional,
        ``add`` concatenates)."""
        out = self.read_view()
        out._base_ids = self._base_ids.copy()
        out._base_live = self._base_live.copy()
        out._delta_ids = self._delta_ids.copy()
        out._delta_live = self._delta_live.copy()
        return out

    def read_view(self) -> "MutableIndex":
        """A point-in-time view for readers outside the writer's lock.

        Call with mutations excluded; the view is then safe to query from
        any number of threads while the original keeps mutating.  Nothing is
        copied: the view shares the current arrays, tensors and the eagerly
        materialised delta segment, which is sound because every mutation
        rebinds instead of writing in place.  It carries a ``view()`` of the
        attribute store, frozen with it, so it answers filtered queries as
        the index did when the view was taken."""
        self._materialize()
        out = object.__new__(MutableIndex)
        out._base = self._base
        out._base_ids = self._base_ids
        out._base_live = self._base_live
        out._delta_data = self._delta_data
        out._delta_ids = self._delta_ids
        out._delta_live = self._delta_live
        out._delta_seg = self._delta_seg
        out._built = self._built
        out._next_id = self._next_id
        out.compact_threshold = self.compact_threshold
        out.version = self.version
        out.generation = self.generation
        out.compactions = self.compactions
        out.pending_compaction = self.pending_compaction
        out.query_options = self.query_options
        out.attributes = None if self.attributes is None else self.attributes.view()
        return out

    # -- delta materialisation -------------------------------------------------
    def _materialize(self):
        """Bring the delta segment up to date with every delta row (table
        kinds measure only the new rows' entries; the tree rebuilds its small
        delta).  ``extend`` is functional, so read views holding the previous
        segment stay consistent.  Returns the segment or None."""
        if self._delta_data is None:
            return None
        d = len(self._delta_ids)
        if self._delta_seg is None:
            self._delta_seg = self._base.spawn(self._delta_data)
            self._built = d
        elif self._built < d:
            self._delta_seg = self._delta_seg.extend(self._delta_data[self._built:])
            self._built = d
        return self._delta_seg

    def physical_parts(self) -> List[Tuple[object, np.ndarray]]:
        """(segment, logical ids with -1 marking tombstoned slots) for every
        physical segment: the flat-table feed of the sharded device filter."""
        parts = [(self._base, np.where(self._base_live, self._base_ids, -1))]
        delta = self._materialize()
        if delta is not None:
            parts.append((delta, np.where(self._delta_live, self._delta_ids, -1)))
        return parts

    def _sides(self) -> List[_Side]:
        sides = [_Side(self._base, self._base_ids, self._base_live)]
        delta = self._materialize()
        if delta is not None and len(self._delta_ids):
            sides.append(_Side(delta, self._delta_ids, self._delta_live))
        return [s for s in sides if s.n]

    def _side_masks(self, sides: List[_Side], rowmask):
        """Translate a LOGICAL-id rowmask into per-side physical-slot masks.

        ``rowmask`` is a sorted int64 array of allowed logical ids or a bool
        mask over the live corpus in ascending logical-id order (the rows
        ``self.data`` holds).  Returns ``(masks, n_allowed)``: per side a
        sorted int64 array of the physical slots whose logical id is allowed
        (``None`` when unfiltered), and the count of allowed LIVE rows.  On
        an ordered side (ascending ids: always the base) the slots come from
        a binary search; slot order is logical-id order there, which keeps
        the (distance, logical id) tie order.
        """
        if rowmask is None:
            return [None] * len(sides), sum(s.n - s.dead for s in sides)
        rid = np.asarray(rowmask)
        if rid.dtype == np.bool_:
            live_ids = self.ids()
            if rid.shape != live_ids.shape:
                raise ValueError(f"boolean rowmask must be ({live_ids.shape[0]},); got {rid.shape}")
            rid = live_ids[rid]
        else:
            rid = rid.astype(np.int64, copy=False)
        masks, n_allowed = [], 0
        for s in sides:
            if s.ordered and s.n:
                want = np.unique(rid)
                pos = np.searchsorted(s.lids, want)
                hit = pos < s.n
                hit[hit] = s.lids[pos[hit]] == want[hit]
                pos = pos[hit].astype(np.int64)
            else:
                pos = np.nonzero(np.isin(s.lids, rid))[0]
            masks.append(pos)
            n_allowed += int(s.live[pos].sum())
        return masks, n_allowed

    # -- protocol: fit ---------------------------------------------------------
    def fit(self, data, ids: Optional[np.ndarray] = None) -> "MutableIndex":
        """Rebuild over new data, reusing the fitted configuration; resets
        logical ids to ``ids`` (strictly ascending; default 0..N-1) and
        clears the delta and the tombstones.  Bumps ``version`` and
        ``generation`` like a compaction."""
        n = int(data.shape[0]) if isinstance(data, torch.Tensor) else len(np.asarray(data))
        if ids is None:
            ids = np.arange(n, dtype=np.int64)
        else:
            ids = np.asarray(ids, dtype=np.int64)
            if ids.shape != (n,):
                raise ValueError(f"ids must be ({n},); got {ids.shape}")
            if len(ids) and not bool(np.all(np.diff(ids) > 0)):
                raise ValueError("ids must be strictly ascending")
        self._base = self._base.spawn(data)
        self._base_ids = ids
        self._base_live = np.ones(n, dtype=bool)
        self._delta_data = None
        self._delta_ids = np.empty(0, dtype=np.int64)
        self._delta_live = np.empty(0, dtype=bool)
        self._delta_seg = None
        self._built = 0
        self._next_id = int(ids.max()) + 1 if len(ids) else 0
        self.version += 1
        self.generation += 1
        self.pending_compaction = False
        return self

    # -- shared pivot-distance protocol ----------------------------------------
    def query_pivot_distances(self, queries, cfg=None) -> torch.Tensor:
        """The base segment's pivot-distance block: base and delta share one
        fitted pivot set, so it serves every side."""
        return self._base.query_pivot_distances(queries, cfg)

    def _shared_qpd(self, queries, cfg):
        """(qpd block, per-query pivot-call count) measured once for every
        side, or (None, 0) when the base kind has no pivot table."""
        fn = getattr(self._base, "query_pivot_distances", None)
        if fn is None:
            return None, 0
        qpd = fn(queries, cfg)
        return qpd, int(qpd.shape[-1])

    # -- execution primitives (dispatched by repro_torch.api.execute) ---------
    def _knn_merged(self, q, k: int, sides: List[_Side], cfg=None, first=None, qpd=None, radius_hint=None,
                    side_masks=None) -> QueryResult:
        """Exact k-NN across segments with a verified merge radius.

        ``first`` optionally supplies round-one per-side results (from the
        batched path), requested at ``k_eff + side.dead``.  ``qpd`` is the
        query's shared pivot-distance row, forwarded to every side and every
        re-query; ``radius_hint`` an externally sound distance cap.
        ``side_masks`` restricts each side to a sorted array of physical
        slots (predicate pushdown); a masked side returning fewer rows than
        requested — empty selection slots are dropped by the segment — reads
        as exhausted, which stays sound because the mask only removes
        candidates.
        """
        stats = QueryStats()
        if side_masks is None:
            side_masks = [None] * len(sides)
            n_live = sum(s.n - s.dead for s in sides)
        else:
            n_live = sum((s.n - s.dead) if m is None else int(s.live[m].sum()) for s, m in zip(sides, side_masks))
        k_eff = min(int(k), n_live)
        if k_eff <= 0:
            return QueryResult(ids=np.empty(0, dtype=np.int64), distances=np.empty(0, dtype=np.float64), stats=stats)
        raw, kreq = {}, {}
        for i, s in enumerate(sides):
            kreq[i] = min(k_eff + s.dead, s.n)
            if first is not None and i in first:
                raw[i] = first[i]
                stats.merge(first[i].stats)
        while True:
            for i, s in enumerate(sides):
                if i not in raw:
                    r = s.seg._exec_knn(q, kreq[i], cfg, qpd=qpd, radius_hint=radius_hint, rowmask=side_masks[i])
                    stats.merge(r.stats)
                    raw[i] = r
            cand_ids, cand_d = [], []
            for i, s in enumerate(sides):
                r = raw[i]
                if not len(r.ids):
                    continue
                live = s.live[r.ids]
                cand_ids.append(s.lids[r.ids[live]])
                cand_d.append(r.distances[live])
            all_ids = np.concatenate(cand_ids) if cand_ids else np.empty(0, np.int64)
            all_d = np.concatenate(cand_d) if cand_d else np.empty(0, np.float64)
            m_ids, m_d = knn_select(all_d, all_ids, k_eff)
            r_k = float(m_d[-1]) if len(m_ids) == k_eff else np.inf
            again = False
            for i, s in enumerate(sides):
                r = raw[i]
                # a truncated UNORDERED side whose last distance does not
                # strictly beat the merged k-th could hide a smaller-id tie:
                # fetch deeper.  A side that returned fewer rows than
                # requested is exhausted within its radius cap or mask.
                if (not s.ordered and kreq[i] < s.n and len(r.distances) == kreq[i]
                        and float(r.distances[-1]) <= r_k):
                    kreq[i] = min(max(2 * kreq[i], k_eff + s.dead), s.n)
                    raw.pop(i)
                    again = True
            if not again:
                approx = next((raw[i].approx for i in sorted(raw) if raw[i].approx), None)
                return QueryResult(ids=m_ids, distances=m_d, stats=stats, approx=approx)

    def _exec_knn(self, q, k: int, cfg=None, qpd=None, radius_hint=None, rowmask=None) -> QueryResult:
        q = np.asarray(q)
        pc = 0
        if qpd is None:
            block, pc = self._shared_qpd(q[None, :], cfg)
            qpd = None if block is None else block[0]
        sides = self._sides()
        masks, _ = self._side_masks(sides, rowmask)
        r = self._knn_merged(q, k, sides, cfg, qpd=qpd, radius_hint=radius_hint,
                             side_masks=None if rowmask is None else masks)
        r.stats.original_calls += pc
        return r

    def _exec_knn_batch(self, queries, k: int, cfg=None, qpd=None, radius_hint=None,
                        rowmask=None) -> BatchQueryResult:
        queries = np.atleast_2d(np.asarray(queries))
        t0 = time.perf_counter()
        pc = 0
        if qpd is None:
            qpd, pc = self._shared_qpd(queries, cfg)
        sides = self._sides()
        masks, n_live = self._side_masks(sides, rowmask)
        k_eff = min(int(k), n_live)
        # round one batched per side (one fused scan per segment); the
        # per-query merges re-query a side alone only on boundary ties
        first_by_side = {}
        if k_eff > 0:
            for i, s in enumerate(sides):
                first_by_side[i] = s.seg._exec_knn_batch(
                    queries, min(k_eff + s.dead, s.n), cfg, qpd=qpd, radius_hint=radius_hint, rowmask=masks[i]
                )
        results = []
        for qi in range(queries.shape[0]):
            r = self._knn_merged(
                queries[qi], k, sides, cfg,
                first={i: b.results[qi] for i, b in first_by_side.items()},
                qpd=None if qpd is None else qpd[qi],
                radius_hint=None if radius_hint is None else float(radius_hint[qi]),
                side_masks=None if rowmask is None else masks,
            )
            r.stats.original_calls += pc
            results.append(r)
        return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)

    @staticmethod
    def _merge_threshold(per_side) -> QueryResult:
        """``per_side``: (side, QueryResult) pairs.  Drops tombstones, maps
        to logical ids, returns ids ascending (the segment contract)."""
        stats = QueryStats()
        ids_parts, d_parts, have_d = [], [], True
        approx = None
        for s, r in per_side:
            stats.merge(r.stats)
            approx = approx or r.approx
            if not len(r.ids):
                continue
            live = s.live[r.ids]
            ids_parts.append(s.lids[r.ids[live]])
            if r.distances is None:
                have_d = False
            else:
                d_parts.append(r.distances[live])
        ids = np.concatenate(ids_parts) if ids_parts else np.empty(0, np.int64)
        order = np.argsort(ids, kind="stable")
        distances = None
        if have_d and d_parts:
            distances = np.concatenate(d_parts)[order]
        elif have_d:
            distances = np.empty(0, np.float64)
        return QueryResult(ids=ids[order], distances=distances, stats=stats, approx=approx)

    def _exec_search(self, q, threshold: float, cfg=None, qpd=None, rowmask=None) -> QueryResult:
        q = np.asarray(q)
        pc = 0
        if qpd is None:
            block, pc = self._shared_qpd(q[None, :], cfg)
            qpd = None if block is None else block[0]
        sides = self._sides()
        masks, _ = self._side_masks(sides, rowmask)
        r = self._merge_threshold(
            [(s, s.seg._exec_search(q, threshold, cfg, qpd=qpd, rowmask=m)) for s, m in zip(sides, masks)]
        )
        r.stats.original_calls += pc
        return r

    def _exec_search_batch(self, queries, thresholds, cfg=None, qpd=None, rowmask=None) -> BatchQueryResult:
        queries = np.atleast_2d(np.asarray(queries))
        t0 = time.perf_counter()
        pc = 0
        if qpd is None:
            qpd, pc = self._shared_qpd(queries, cfg)
        sides = self._sides()
        masks, _ = self._side_masks(sides, rowmask)
        batches = [s.seg._exec_search_batch(queries, thresholds, cfg, qpd=qpd, rowmask=m)
                   for s, m in zip(sides, masks)]
        results = []
        for qi in range(queries.shape[0]):
            r = self._merge_threshold([(s, b.results[qi]) for s, b in zip(sides, batches)])
            r.stats.original_calls += pc
            results.append(r)
        return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)

    # -- protocol: stats / persistence -----------------------------------------
    def stats(self) -> dict:
        base = self._base.stats()
        return {
            **base,
            "kind": self.kind,
            "base_kind": base["kind"],
            "n_objects": self._n_live(),
            "base_rows": int(self._base_ids.shape[0]),
            "delta_rows": int(self._delta_ids.shape[0]),
            "tombstones": int((~self._base_live).sum()) + int((~self._delta_live).sum()),
            "compact_threshold": self.compact_threshold,
            "pending_compaction": bool(self.pending_compaction),
            "compactions": int(self.compactions),
            "generation": int(self.generation),
        }

    def save(self, path) -> None:
        """Nested directory in the JAX package's layout: own manifest + id /
        tombstone arrays, the base segment under ``base/`` and the
        (materialised) delta under ``delta/``; every table is persisted, so
        loading re-measures no distance."""
        path = os.fspath(path)
        delta = self._materialize()
        write_index_dir(
            path,
            kind=self.kind,
            params={
                "base_kind": self._base.kind,
                "compact_threshold": self.compact_threshold,
                "next_id": self._next_id,
                "generation": int(self.generation),
                "compactions": int(self.compactions),
                "pending_compaction": bool(self.pending_compaction),
                "has_delta": delta is not None,
                "query_options": self.query_options.to_dict() if self.query_options else None,
            },
            arrays={
                "base_ids": self._base_ids,
                "base_live": self._base_live,
                "delta_ids": self._delta_ids,
                "delta_live": self._delta_live,
            },
        )
        self._base.save(os.path.join(path, "base"))
        if delta is not None:
            delta.save(os.path.join(path, "delta"))
        self._save_attributes(path)

    @classmethod
    def _load(cls, path, manifest: dict, arrays: dict, *, device="cuda") -> "MutableIndex":
        from repro_torch.api.factory import load_index

        params = manifest["params"]
        path = os.fspath(path)
        out = object.__new__(cls)
        out._base = load_index(os.path.join(path, "base"), device=device)
        out._base_ids = np.asarray(arrays["base_ids"], dtype=np.int64)
        out._base_live = np.asarray(arrays["base_live"], dtype=bool)
        out._delta_ids = np.asarray(arrays["delta_ids"], dtype=np.int64)
        out._delta_live = np.asarray(arrays["delta_live"], dtype=bool)
        if params["has_delta"]:
            out._delta_seg = load_index(os.path.join(path, "delta"), device=device)
            out._delta_data = out._delta_seg.data
            out._built = len(out._delta_ids)
        else:
            out._delta_seg = None
            out._delta_data = None
            out._built = 0
        out._next_id = int(params["next_id"])
        out.compact_threshold = params["compact_threshold"]
        out.version = 0
        out.generation = int(params.get("generation", 0))
        out.compactions = int(params.get("compactions", 0))
        out.pending_compaction = bool(params.get("pending_compaction", False))
        return _restore_options(out, params)
