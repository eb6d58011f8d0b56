"""ShardedIndex — rows partitioned across segments, one ``Index`` surface.

The composite partitions the corpus row-wise across same-kind segments
(optionally each a ``MutableIndex`` for online traffic) and serves the full
protocol, as the JAX package's ``repro.api.sharded``:

  * ``knn`` / ``knn_batch``     — per-shard exact k-NN, merged into a global
    top-k by (distance, logical id); bit-identical to a single-segment index.
  * ``search_batch``            — for the simplex kind, routed through the
    distributed two-sided filter of ``repro_torch.search.distributed``:
    every shard's apex table rows are flattened into one table split over
    the device grid, K3 filters each device's rows, and only candidate slots
    come back for the exact recheck.  fp32 guard bands keep the result set
    exact (a borderline decision falls back to recheck; a slot overflow
    sends that query to the host fan-out).  Other kinds fan out per shard.
  * mutations                   — routed to the least-loaded shard (adds) or
    the owning shard (remove/upsert); ids are global and stable.

Table-kind shards share ONE pivot set (selected over the full corpus), so all
apex tables live in the same surrogate space — the precondition for the
flattened device scan.

Scale-out execution:

  * the shared pivot set is measured once per query on every path:
    ``_block_qpd`` computes the (Q, n) query-pivot distance block on the
    device (K5 for JSD) and threads it to every shard and base/delta side as
    ``qpd``, so no segment re-measures it;
  * host paths fan the shards out on a worker pool (``repro_torch.api.
    fanout``) with an overlapped top-k merge: a finished shard's running
    global k-th distance is handed to still-running shards as a
    ``radius_hint``.  ``fanout_workers=0`` forces the sequential scan (no
    hint).  Each pool thread enters the index's device, so its kernel
    launches go to the shards' card;
  * device placement is a ``ShardLayout`` (``repro_torch.sharding.rules``):
    rows partitioned over the grid's ``data`` axis (default), or replica
    groups over a leading ``replica`` axis that split the query stream.

On the card the segments, their tables and rows, the flattened table and the
slot decoding live on the device; logical ids and the merges are host numpy.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.api.execute import QuerySurface
from repro_torch.api.fanout import TopKMerge, default_fanout_workers, run_fanout, shared_pool
from repro_torch.api.indexes import _restore_options
from repro_torch.api.persistence import write_index_dir

# the near-zero-threshold gate below which the device filter flips to the
# host fan-out lives in the planner, so the plan's shard_fanout stage and
# _use_device_filter apply the identical rule
from repro_torch.api.planner import MIN_DEVICE_THRESHOLD as _MIN_DEVICE_THRESHOLD
from repro_torch.api.types import BatchQueryResult, QueryResult, QueryStats
from repro_torch.core.bounds import ACCEPT, RECHECK
from repro_torch.device import on_device

__all__ = ["DEFAULT_LAYOUT", "ShardedIndex"]

DEFAULT_LAYOUT = {"rows": "partitioned", "pivot_tables": "replicated", "replicas": 1}


def _shard_table_parts(shard):
    """[(segment, lids-with--1-dead)] physical parts of one shard."""
    if hasattr(shard, "physical_parts"):
        return shard.physical_parts()
    return None  # plain segment: caller supplies the id map


class ShardedIndex(QuerySurface):
    """Row-partitioned composite over same-kind segments."""

    kind = "sharded"

    def __init__(
        self,
        shards: List[object],
        shard_ids: List[Optional[np.ndarray]],
        *,
        inner_kind: str,
        mutable: bool,
        next_id: int,
        projector=None,
        eps: float = 1e-6,
        device_filter: Optional[bool] = None,
        max_candidates: int = 256,
        approx: Optional[dict] = None,
        fanout_workers: Optional[int] = None,
        layout: Optional[dict] = None,
    ):
        self._shards = list(shards)
        #: per-shard logical ids for PLAIN segments; None for mutable shards
        #: (a MutableIndex owns its own id map)
        self._shard_ids = list(shard_ids)
        self.inner_kind = inner_kind
        self.mutable = mutable
        self._next_id = int(next_id)
        self._projector = projector
        self._eps = float(eps)
        self.device_filter = device_filter
        self.max_candidates = int(max_candidates)
        #: truncation config carried by the segments (``apex_dims`` builds);
        #: approx threshold queries fan out on host — the device filter
        #: implements the EXACT two-sided decision
        self.approx = dict(approx) if approx else None
        #: host fan-out policy: None = shared process pool (overlapped merge
        #: + radius hints), 0 = sequential scan, int>0 = private pool
        self.fanout_workers = fanout_workers
        #: device placement (plain dict, see ``ShardLayout``)
        self.layout = dict(layout) if layout else dict(DEFAULT_LAYOUT)
        self.version = 0
        self._flat = None            # (table_f32, lids, rows, max row_sq) cache
        self._flat_version = -1
        self._placed = None          # (version, table slices on the grid)
        self._filter_fn = None       # distributed filter (lazy)
        self._pool_cache = None      # (workers, ThreadPoolExecutor) private pool
        #: the filter's devices (``configure_grid``)
        self._grid_devices = None
        self._mesh_replicas = 1      # set when the device filter is built
        self._mesh_data = 1
        #: device-filter queries whose slots overflowed on some device (each
        #: answered by the host fan-out instead)
        self.filter_overflow_queries = 0

    # -- device grid -------------------------------------------------------------
    def configure_grid(self, devices: Optional[List[torch.device]]) -> None:
        """Name the distributed filter's devices, one per grid position:
        ``None`` (the default) takes every visible card for an index on the
        card and the index's own device on the CPU.  A list may name one
        device more than once, such as ``[torch.device("cuda")] * 4`` (four
        positions on one card) or ``[torch.device("cpu")] * 4``: the
        counterpart of the JAX package's forced host device count
        (``--xla_force_host_platform_device_count``).  The filter is rebuilt
        on its next query."""
        self._grid_devices = None if devices is None else [torch.device(d) for d in devices]
        self._filter_fn = None
        self._placed = None

    # -- fan-out plumbing ------------------------------------------------------
    def configure_fanout(self, workers: Optional[int]) -> None:
        """Set the host fan-out policy (None = shared pool, 0 = sequential,
        int>0 = private pool of that size)."""
        self.fanout_workers = workers

    def _fanout_pool(self):
        """The executor for host fan-out, or None for the sequential scan."""
        if self.n_shards <= 1:
            return None
        w = self.fanout_workers
        if w is None:
            return shared_pool()
        w = int(w)
        if w <= 0:
            return None
        if self._pool_cache is None or self._pool_cache[0] != w:
            from concurrent.futures import ThreadPoolExecutor

            self._pool_cache = (w, ThreadPoolExecutor(max_workers=w, thread_name_prefix="repro-fanout"))
        return self._pool_cache[1]

    def _block_qpd(self, queries, cfg=None, qpd=None):
        """(query-pivot distance block on the device, pivot-call charge) for a
        (Q, dim) query block.  The shared pivot set is measured here, ONCE per
        query; every shard (and each shard's base/delta sides) receives the
        block via the segment protocol's ``qpd`` and charges 0 pivot calls."""
        if qpd is not None:
            return torch.as_tensor(qpd, dtype=torch.float64, device=self.device), 0
        probe = getattr(self._shards[0], "query_pivot_distances", None)
        if probe is None or self.inner_kind not in ("nsimplex", "laesa"):
            return None, 0
        block = probe(np.atleast_2d(np.asarray(queries)), cfg)
        return block, int(block.shape[-1])

    # -- id plumbing -----------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def metric(self):
        return self._shards[0].metric

    @property
    def device(self) -> torch.device:
        return self._shards[0].device

    @property
    def data(self) -> torch.Tensor:
        """The live logical rows across every shard, ascending logical-id
        order (the corpus a fresh single-segment rebuild would see),
        gathered on the device."""
        rows = torch.cat([s.data for s in self._shards])
        lids = np.concatenate([self._lids(s) for s in range(self.n_shards)])
        return rows[torch.as_tensor(np.argsort(lids, kind="stable"), device=rows.device)]

    def _lids(self, s: int) -> np.ndarray:
        """Live logical ids of shard s."""
        if self._shard_ids[s] is not None:
            return self._shard_ids[s]
        return self._shards[s].ids()

    def ids(self) -> np.ndarray:
        return np.sort(np.concatenate([self._lids(s) for s in range(self.n_shards)]))

    def _map(self, s: int, local_ids: np.ndarray) -> np.ndarray:
        ids = self._shard_ids[s]
        return local_ids if ids is None else ids[local_ids]

    def _n_live(self) -> int:
        return sum(int(self._shards[s].stats()["n_objects"]) for s in range(self.n_shards))

    def _find_shard(self, logical_id: int) -> int:
        for s, shard in enumerate(self._shards):
            if self._shard_ids[s] is not None:
                lo = int(np.searchsorted(self._shard_ids[s], logical_id))
                if lo < len(self._shard_ids[s]) and self._shard_ids[s][lo] == logical_id:
                    return s
            elif shard.has_id(logical_id):
                return s
        raise KeyError(f"id {int(logical_id)} not in index")

    # -- mutations (mutable shards only) ---------------------------------------
    def _require_mutable(self):
        if not self.mutable:
            raise TypeError(
                "this ShardedIndex is immutable; build with "
                "build_index(..., shards=S, mutable=True) for online updates"
            )

    @staticmethod
    def _check_unique(ids: np.ndarray, what: str) -> None:
        if len(np.unique(ids)) != len(ids):
            raise ValueError(f"duplicate ids in one {what} batch")

    def _owner_of(self, logical_id: int) -> int:
        """Owning shard index, or -1 when the id is not live anywhere."""
        try:
            return self._find_shard(int(logical_id))
        except KeyError:
            return -1

    def add(self, rows: np.ndarray, ids=None, attrs=None) -> np.ndarray:
        """Append rows to the least-loaded shard; returns global logical ids.

        All-or-nothing: ids (explicit or assigned) and rows are validated
        before any shard mutates, and ``_next_id`` only advances after the
        target shard accepts the batch — a rejected add leaks no id range."""
        self._require_mutable()
        rows = np.atleast_2d(np.asarray(rows))
        if ids is None:
            ids = np.arange(self._next_id, self._next_id + len(rows), dtype=np.int64)
        else:
            ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
            if ids.shape != (len(rows),):
                raise ValueError(f"need {len(rows)} ids; got {ids.shape}")
            self._check_unique(ids, "add")
            # the target shard only knows its own ids; liveness must be
            # checked globally or a duplicate logical id lands in a sibling
            for i in ids:
                if self._owner_of(int(i)) >= 0:
                    raise KeyError(f"id {int(i)} is already live; use upsert")
        target = int(np.argmin([s.stats()["n_objects"] for s in self._shards]))
        # the shard validates the rows themselves (dim / finiteness) before
        # mutating; only a fully accepted batch may consume the id range
        out = self._shards[target].add(rows, ids=ids)
        if attrs is not None:
            # attributes live at the top level (the shard's own store is
            # never attached), keyed by the global logical ids
            self._attrs_put(ids, attrs)
        self._next_id = max(self._next_id, int(ids.max()) + 1 if len(ids) else 0)
        self.version += 1
        return out

    def remove(self, ids) -> None:
        """Remove a batch of logical ids, atomically across shards: ownership
        and in-batch duplicates are resolved for EVERY id before any shard
        mutates, so a bad id leaves the whole index untouched."""
        self._require_mutable()
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        self._check_unique(ids, "remove")
        owners = np.asarray([self._find_shard(int(i)) for i in ids])
        for s in np.unique(owners):
            self._shards[int(s)].remove(ids[owners == s])
        self._attrs_drop(ids)
        self.version += 1

    def upsert(self, ids, rows: np.ndarray, attrs=None) -> np.ndarray:
        """Replace rows in their owning shard; new ids go to the emptiest.

        Validated up front like ``add``/``remove``: shapes, in-batch
        duplicates, and ownership resolve before any shard mutates."""
        self._require_mutable()
        rows = np.atleast_2d(np.asarray(rows))
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if ids.shape != (len(rows),):
            raise ValueError(f"need {len(rows)} ids; got {ids.shape}")
        self._check_unique(ids, "upsert")
        # a mixed batch touches several shards; validate every row before the
        # first group applies so a bad row cannot leave a partial upsert
        check = getattr(self._shards[0], "_check_rows", None)
        if check is not None:
            check(rows)
        owners = np.asarray([self._owner_of(int(i)) for i in ids])
        for s in np.unique(owners[owners >= 0]):
            m = owners == s
            self._shards[int(s)].upsert(ids[m], rows[m])
        new = owners < 0
        if np.any(new):
            self.add(rows[new], ids=ids[new])
        if attrs is not None:
            self._attrs_put(ids, attrs)
        self.version += 1
        return ids

    def compact(self) -> "ShardedIndex":
        self._require_mutable()
        for shard in self._shards:
            shard.compact()
        self.version += 1
        return self

    # -- protocol: fit ---------------------------------------------------------
    def fit(self, data) -> "ShardedIndex":
        """Re-partition new data over the same shard count, reusing each
        shard's fitted configuration (shared pivots included)."""
        n = int(data.shape[0]) if isinstance(data, torch.Tensor) else len(np.asarray(data))
        data = data if isinstance(data, torch.Tensor) else np.asarray(data)
        bounds = np.linspace(0, n, self.n_shards + 1).astype(int)
        for s, shard in enumerate(self._shards):
            block = data[bounds[s]: bounds[s + 1]]
            if self._shard_ids[s] is not None:
                shard.fit(block)
                self._shard_ids[s] = np.arange(bounds[s], bounds[s + 1], dtype=np.int64)
            else:
                # mutable shard: rebase through its fit(ids=...) entry point,
                # which bumps version AND generation so pinned read views
                # invalidate
                shard.fit(block, ids=np.arange(bounds[s], bounds[s + 1], dtype=np.int64))
        self._next_id = n
        self.version += 1
        return self

    # -- execution primitives (dispatched by repro_torch.api.execute) ---------
    def _shard_masks(self, rowmask):
        """Translate a LOGICAL-id rowmask into per-shard restrictions.

        Plain segments address rows by local position, so their allowed
        logical ids become sorted local slots (ascending slots are ascending
        lids there, preserving (distance, id) tie order).  Mutable shards
        own their id maps and take the logical ids verbatim.  ``None`` stays
        ``None`` everywhere.
        """
        if rowmask is None:
            return [None] * self.n_shards
        rid = np.asarray(rowmask)
        if rid.dtype == np.bool_:
            live_ids = self.ids()
            if rid.shape != live_ids.shape:
                raise ValueError(f"boolean rowmask must be ({live_ids.shape[0]},); got {rid.shape}")
            rid = live_ids[rid]
        else:
            rid = rid.astype(np.int64, copy=False)
        masks = []
        for s in range(self.n_shards):
            ids = self._shard_ids[s]
            masks.append(rid if ids is None else np.nonzero(np.isin(ids, rid))[0])
        return masks

    @staticmethod
    def _mask_kw(mask) -> dict:
        """``rowmask`` kwarg only when a mask exists (unfiltered fan-out keeps
        the pre-filter call shape)."""
        return {} if mask is None else {"rowmask": mask}

    def _exec_knn(self, q, k: int, cfg=None, qpd=None, radius_hint=None, rowmask=None) -> QueryResult:
        q = np.asarray(q)
        block = None if qpd is None else torch.as_tensor(qpd, dtype=torch.float64).reshape(1, -1)
        block, pc = self._block_qpd(q[None, :], cfg, block)
        qpd1 = None if block is None else block[0]
        masks = self._shard_masks(rowmask)
        merge = TopKMerge(int(k), cap=radius_hint)
        stats = QueryStats()
        box = [None]  # first-completed approx config (identical across shards)
        lock = threading.Lock()
        pool = self._fanout_pool()
        overlapped = pool is not None

        def scan(s):
            # read the hint BEFORE scanning: any k-th distance already merged
            # by a finished shard caps this shard's refinement radius
            hint = merge.radius() if overlapped else radius_hint
            with on_device(self.device):
                r = self._shards[s]._exec_knn(q, k, cfg, qpd=qpd1, radius_hint=hint, **self._mask_kw(masks[s]))
            with lock:
                stats.merge(r.stats)
                box[0] = box[0] or r.approx
                merge.push(r.distances, self._map(s, r.ids))

        for _ in run_fanout([lambda s=s: scan(s) for s in range(self.n_shards)], pool):
            pass
        stats.original_calls += pc
        ids, d = merge.result()
        return QueryResult(ids=ids, distances=d, stats=stats, approx=box[0])

    def _exec_knn_batch(self, queries, k: int, cfg=None, qpd=None, radius_hint=None,
                        rowmask=None) -> BatchQueryResult:
        queries = np.atleast_2d(np.asarray(queries))
        t0 = time.perf_counter()
        qpd, pc = self._block_qpd(queries, cfg, qpd)
        masks = self._shard_masks(rowmask)
        Q = queries.shape[0]
        merges = [
            TopKMerge(int(k), cap=None if radius_hint is None else float(radius_hint[qi])) for qi in range(Q)
        ]
        stats = [QueryStats() for _ in range(Q)]
        approxes = [None] * Q
        lock = threading.Lock()
        pool = self._fanout_pool()
        overlapped = pool is not None

        def scan(s):
            if overlapped:
                hint = np.fromiter((m.radius() for m in merges), dtype=np.float64, count=Q)
            else:
                hint = radius_hint
            with on_device(self.device):
                b = self._shards[s]._exec_knn_batch(
                    queries, k, cfg, qpd=qpd, radius_hint=hint, **self._mask_kw(masks[s])
                )
            with lock:
                for qi, r in enumerate(b.results):
                    stats[qi].merge(r.stats)
                    approxes[qi] = approxes[qi] or r.approx
                    merges[qi].push(r.distances, self._map(s, r.ids))

        for _ in run_fanout([lambda s=s: scan(s) for s in range(self.n_shards)], pool):
            pass
        results = []
        for qi in range(Q):
            stats[qi].original_calls += pc
            ids, d = merges[qi].result()
            results.append(QueryResult(ids=ids, distances=d, stats=stats[qi], approx=approxes[qi]))
        return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)

    # -- execution primitives: threshold search --------------------------------
    def _merge_threshold_one(self, per_shard_results) -> QueryResult:
        stats = QueryStats()
        ids_parts, d_parts, have_d = [], [], True
        approx = None
        for s, r in per_shard_results:
            stats.merge(r.stats)
            approx = approx or r.approx
            ids_parts.append(self._map(s, r.ids))
            if r.distances is None:
                have_d = False
            else:
                d_parts.append(r.distances)
        ids = np.concatenate(ids_parts) if ids_parts else np.empty(0, np.int64)
        order = np.argsort(ids, kind="stable")
        distances = np.concatenate(d_parts)[order] if (have_d and d_parts) else None
        return QueryResult(ids=ids[order], distances=distances, stats=stats, approx=approx)

    def _shard_search(self, s, *args, **kw):
        with on_device(self.device):
            return s, self._shards[s]._exec_search_batch(*args, **kw)

    def _exec_search(self, q, threshold: float, cfg=None, qpd=None, rowmask=None) -> QueryResult:
        q = np.asarray(q)
        block = None if qpd is None else torch.as_tensor(qpd, dtype=torch.float64).reshape(1, -1)
        block, pc = self._block_qpd(q[None, :], cfg, block)
        qpd1 = None if block is None else block[0]
        masks = self._shard_masks(rowmask)
        pool = self._fanout_pool()

        def one(s):
            with on_device(self.device):
                return s, self._shards[s]._exec_search(q, threshold, cfg, qpd=qpd1, **self._mask_kw(masks[s]))

        # completion order is irrelevant: ids are globally unique and the
        # merge sorts by id; stats accumulate commutatively
        thunks = [lambda s=s: one(s) for s in range(self.n_shards)]
        out = self._merge_threshold_one([pair for _, pair in run_fanout(thunks, pool)])
        out.stats.original_calls += pc
        return out

    def _host_search_batch(self, queries, thresholds, cfg=None, qpd=None, masks=None) -> List[QueryResult]:
        """Per-shard threshold fan-out.  ``qpd``'s pivot-call charge is NOT
        added here — the caller owns it (device fallbacks share one block).
        ``masks`` is the pre-translated per-shard rowmask list (or None)."""
        if masks is None:
            masks = [None] * self.n_shards
        pool = self._fanout_pool()
        thunks = [
            lambda s=s: self._shard_search(s, queries, thresholds, cfg, qpd=qpd, **self._mask_kw(masks[s]))
            for s in range(self.n_shards)
        ]
        per_shard = dict(pair for _, pair in run_fanout(thunks, pool))
        return [
            self._merge_threshold_one([(s, per_shard[s].results[qi]) for s in range(self.n_shards)])
            for qi in range(queries.shape[0])
        ]

    def _exec_search_batch(self, queries, thresholds, cfg=None, qpd=None, rowmask=None) -> BatchQueryResult:
        queries = np.atleast_2d(np.asarray(queries))
        thresholds = np.broadcast_to(np.asarray(thresholds, dtype=np.float64), (queries.shape[0],))
        t0 = time.perf_counter()
        qpd, pc = self._block_qpd(queries, cfg, qpd)
        # the flattened device filter has no mask lane; filtered batches fan
        # out on host (the planner's shard_fanout stage records the same rule)
        if rowmask is None and self._use_device_filter(thresholds, cfg):
            results = self._device_search_batch(queries, thresholds, qpd=qpd)
        else:
            results = self._host_search_batch(
                queries, thresholds, cfg, qpd=qpd, masks=self._shard_masks(rowmask)
            )
        for r in results:
            r.stats.original_calls += pc
        return BatchQueryResult(results=results, elapsed_s=time.perf_counter() - t0)

    # -- device filter path ----------------------------------------------------
    def _use_device_filter(self, thresholds, cfg=None) -> bool:
        if self.device_filter is False:
            return False
        # approx queries fan out on host: the device filter is the exact
        # two-sided decision, and the quality dial lives in the segments
        if cfg is not None:
            return False
        return (
            self.inner_kind == "nsimplex"
            and self._projector is not None
            and bool(np.all(thresholds > _MIN_DEVICE_THRESHOLD))
        )

    def _flat_state(self):
        """(table float32 (P, n), lids (P,) with -1 = tombstoned, rows (P, dim),
        max squared row norm): every shard's physical segments concatenated
        on the device (the f32 kernel tables and rows; the ids on the host),
        cached on the mutation version."""
        if self._flat is not None and self._flat_version == self.version:
            return self._flat
        tables, lids, rows = [], [], []
        for s, shard in enumerate(self._shards):
            parts = _shard_table_parts(shard)
            if parts is None:
                parts = [(shard, self._shard_ids[s])]
            for seg, ids in parts:
                tables.append(seg._inner._kernel_table())
                lids.append(ids)
                rows.append(seg.data)
        table = torch.cat(tables)
        row_sq = float((table.double() ** 2).sum(dim=1).max()) if table.shape[0] else 0.0
        self._flat = (table, np.concatenate(lids).astype(np.int64), torch.cat(rows), row_sq)
        self._flat_version = self.version
        return self._flat

    def _device_filter_fn(self):
        if self._filter_fn is None:
            from repro_torch.search.distributed import build_distributed_filter
            from repro_torch.sharding.rules import ShardLayout, make_scaleout_mesh

            devices = self._grid_devices
            if devices is None and self.device.type != "cuda":
                devices = [self.device]
            mesh = make_scaleout_mesh(ShardLayout.from_dict(self.layout), devices)
            self._mesh = mesh
            self._mesh_replicas = int(mesh.shape.get("replica", 1))
            self._mesh_data = int(mesh.shape["data"])
            # the guard bands are computed per call (from the actual table /
            # query norms) and passed as explicit t_hi / t_lo
            self._filter_fn = build_distributed_filter(mesh, max_candidates=self.max_candidates, selection="topk")
        return self._filter_fn

    def _device_table(self, table: torch.Tensor):
        """The flat table padded to a multiple of the grid's ``data`` size
        with sentinel rows (last coordinate 1e30: they can never match) and
        placed on the grid; cached on the mutation version."""
        from repro_torch.sharding import place_rows

        if self._placed is not None and self._placed[0] == self.version:
            return self._placed[1]
        pad = (-table.shape[0]) % max(self._mesh_data, 1)
        if pad:
            sentinel = torch.zeros((pad, table.shape[1]), dtype=table.dtype, device=table.device)
            sentinel[:, -1] = 1e30
            table = torch.cat([table, sentinel])
        placed = place_rows(self._mesh, table)
        self._placed = (self.version, placed)
        return placed

    def _fp32_slack(self, row_sq: float, apexes: torch.Tensor, t_min: float) -> float:
        """Distance-domain error bound for the fp32 filter: the squared-domain
        accumulation error mapped through d ≈ err/(2t), plus the float32 cast
        of table and query apex coordinates themselves.

        The formula is the JAX package's, written for its jnp GEMM form
        (|q|² + |x|² - 2 q·x in f32, any summation order).  K3 evaluates the
        same GEMM form with every operation explicitly rounded (fused
        multiply-adds in ascending coordinate order, no TF32): each of its
        n + 8 roundings is one of those the bound already charges, and a
        fused multiply-add rounds once where the GEMM form may round twice,
        so its error lies inside the same bound and the bands
        ``t·(1 ± eps_eff)`` stay sound for it."""
        q_sq = float((apexes * apexes).sum(dim=1).max()) if apexes.shape[0] else 0.0
        n = apexes.shape[1]
        eps32 = float(np.finfo(np.float32).eps)
        err_sq = 4.0 * (n + 8) * eps32 * (row_sq + q_sq)
        cast = 4.0 * eps32 * (np.sqrt(row_sq) + np.sqrt(q_sq))
        return err_sq / (2.0 * max(t_min, 1e-12)) + cast + 1e-9

    def _device_search_batch(self, queries, thresholds, qpd=None) -> List[QueryResult]:
        metric = self.metric
        table, lids, rows, row_sq = self._flat_state()
        Q = queries.shape[0]
        filter_fn = self._device_filter_fn()  # also resolves the grid shape
        placed = self._device_table(table)
        q_t = torch.as_tensor(queries, device=self.device)
        # query apexes: the shared (Q, n) pivot-distance block (measured once
        # by the caller) + one projection (K4)
        qd = qpd if qpd is not None else metric.cross(q_t, self._projector.pivots_t)
        apexes = torch.atleast_2d(self._projector.project_distances(qd))
        # exactness guard bands: relative eps covering both the index's own
        # guard and the fp32 evaluation error — a row inside the band falls
        # back to RECHECK, so neither a false ACCEPT nor a false EXCLUDE can
        # slip through
        t_min = float(thresholds.min())
        slack = self._fp32_slack(row_sq, apexes, t_min)
        eps_eff = self._eps + slack / t_min
        # replica layout splits the query stream over the replica groups;
        # pad Q to a multiple of the replica count (repeat the last query)
        qpad = (-Q) % max(self._mesh_replicas, 1)
        ap32 = apexes.to(torch.float32)
        t_hi = (thresholds * (1.0 + eps_eff)).astype(np.float32)
        t_lo = (thresholds * (1.0 - eps_eff)).astype(np.float32)
        if qpad:
            ap32 = torch.cat([ap32, ap32[-1:].expand(qpad, -1)])
            t_hi = np.concatenate([t_hi, np.repeat(t_hi[-1:], qpad)])
            t_lo = np.concatenate([t_lo, np.repeat(t_lo[-1:], qpad)])
        _, cand_idx, cand_code = filter_fn(placed, ap32.contiguous(), torch.from_numpy(t_hi), torch.from_numpy(t_lo))
        idxs, codes = cand_idx[:, :Q, :], cand_code[:, :Q, :]   # (groups, Q, K) physical rows
        K = self.max_candidates
        valid = idxs >= 0
        # slot overflow on some device: exactness is not provable from the
        # packed candidates — host fan-out for that query
        over = (valid.sum(dim=2) == K).any(dim=0)
        # decode every other query's slots in one pass on the device; only
        # (query, row, code) triples come back, query-major
        qq, dd, kk = torch.nonzero((valid & ~over[None, :, None]).permute(1, 0, 2), as_tuple=True)
        packed = torch.stack([qq, idxs[dd, qq, kk], codes[dd, qq, kk].to(torch.int64)]).cpu().numpy()
        over = over.cpu().numpy()
        q_of, flat_idx, flat_code = packed
        bounds = np.searchsorted(q_of, np.arange(Q + 1))
        results: List[Optional[QueryResult]] = [None] * Q
        for qi in range(Q):
            if over[qi]:
                continue
            idx_q = flat_idx[bounds[qi]:bounds[qi + 1]]
            code_q = flat_code[bounds[qi]:bounds[qi + 1]]
            q_lids = lids[idx_q]
            live = q_lids >= 0
            idx_q, code_q, q_lids = idx_q[live], code_q[live], q_lids[live]
            accepted = code_q == ACCEPT
            recheck_m = code_q == RECHECK
            stats = QueryStats(
                # a caller-supplied qpd block means the caller owns the
                # pivot-call charge; otherwise the pivots were measured here
                original_calls=0 if qpd is not None else self._projector.n_pivots,
                surrogate_calls=int(table.shape[0]),
                accepted_no_check=int(accepted.sum()),
                candidates=int(len(idx_q)),
            )
            keep = [q_lids[accepted]]
            if np.any(recheck_m):
                sel = torch.as_tensor(idx_q[recheck_m], device=rows.device)
                d = metric.one_to_many(q_t[qi], rows[sel]).cpu().numpy()
                stats.original_calls += int(recheck_m.sum())
                keep.append(q_lids[recheck_m][d <= thresholds[qi]])
            results[qi] = QueryResult(ids=np.sort(np.concatenate(keep)), distances=None, stats=stats)
        fallback = np.flatnonzero(over)
        self.filter_overflow_queries += len(fallback)
        if len(fallback):
            host = self._host_search_batch(
                queries[fallback], thresholds[fallback],
                qpd=None if qpd is None else qd[torch.as_tensor(fallback, device=qd.device)],
            )
            for qi, r in zip(fallback, host):
                results[qi] = r
        return results

    # -- protocol: stats / persistence -----------------------------------------
    def _resolved_fanout_workers(self) -> int:
        """The effective fan-out pool size (0 = sequential scan)."""
        if self.n_shards <= 1:
            return 0
        w = self.fanout_workers
        if w is None:
            return default_fanout_workers()
        return max(0, int(w))

    def stats(self) -> dict:
        per_shard = [s.stats() for s in self._shards]
        out = {
            **per_shard[0],
            "kind": self.kind,
            "inner_kind": self.inner_kind,
            "n_shards": self.n_shards,
            "mutable": self.mutable,
            "n_objects": sum(s["n_objects"] for s in per_shard),
            "shard_objects": [s["n_objects"] for s in per_shard],
            "device_filter": self.device_filter,
            "shared_projector": self._projector is not None,
            "fanout_workers": self._resolved_fanout_workers(),
            "fanout_overlap": self._fanout_pool() is not None,
            "layout": dict(self.layout),
        }
        if self.mutable:
            out["delta_rows"] = sum(s.get("delta_rows", 0) for s in per_shard)
            out["tombstones"] = sum(s.get("tombstones", 0) for s in per_shard)
            out["pending_compaction"] = any(s.get("pending_compaction", False) for s in per_shard)
            out["compactions"] = sum(s.get("compactions", 0) for s in per_shard)
            out["generation"] = max(s.get("generation", 0) for s in per_shard)
        return out

    def save(self, path) -> None:
        """The JAX package's layout: own manifest + per-shard id maps, each
        shard under ``shard_SSS/`` (mutable shards nest their own base/delta);
        no distance is re-measured on load."""
        path = os.fspath(path)
        arrays = {}
        for s in range(self.n_shards):
            if self._shard_ids[s] is not None:
                arrays[f"ids_{s:03d}"] = self._shard_ids[s]
        write_index_dir(
            path,
            kind=self.kind,
            params={
                "inner_kind": self.inner_kind,
                "mutable": self.mutable,
                "n_shards": self.n_shards,
                "next_id": self._next_id,
                "eps": self._eps,
                "device_filter": self.device_filter,
                "max_candidates": self.max_candidates,
                "approx": self.approx,
                "fanout_workers": self.fanout_workers,
                "layout": dict(self.layout),
                "query_options": self.query_options.to_dict() if self.query_options else None,
            },
            arrays=arrays,
        )
        for s, shard in enumerate(self._shards):
            shard.save(os.path.join(path, f"shard_{s:03d}"))
        self._save_attributes(path)

    @classmethod
    def _load(cls, path, manifest: dict, arrays: dict, *, device="cuda") -> "ShardedIndex":
        from repro_torch.api.factory import load_index

        params = manifest["params"]
        shards, shard_ids = [], []
        for s in range(int(params["n_shards"])):
            shards.append(load_index(os.path.join(os.fspath(path), f"shard_{s:03d}"), device=device))
            ids = arrays.get(f"ids_{s:03d}")
            shard_ids.append(None if ids is None else np.asarray(ids, dtype=np.int64))
        out = cls(
            shards,
            shard_ids,
            inner_kind=params["inner_kind"],
            mutable=bool(params["mutable"]),
            next_id=int(params["next_id"]),
            projector=_shared_projector(shards[0], params["inner_kind"]),
            eps=float(params["eps"]),
            device_filter=params["device_filter"],
            max_candidates=int(params["max_candidates"]),
            approx=params.get("approx"),
            fanout_workers=params.get("fanout_workers"),
            layout=params.get("layout"),
        )
        return _restore_options(out, params)


def _shared_projector(shard, inner_kind: str):
    """The fitted NSimplexProjector shared by every simplex shard, or None."""
    if inner_kind != "nsimplex":
        return None
    seg = shard._base if hasattr(shard, "_base") else shard
    return seg._inner.projector
