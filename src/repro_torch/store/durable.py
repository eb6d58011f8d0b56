"""DurableIndex — the crash-safe ingest layer over ``MutableIndex``.

Composition (one directory = one durable index), the JAX package's
``repro.store.durable`` layout byte for byte:

    <wal_dir>/
        wal-00000000.log ...    append-only mutation log  (``repro_torch.store.wal``)
        snapshots/ckpt-...      internal checkpoints      (``repro_torch.store.snapshot``)
        CURRENT                 atomic pointer to the live checkpoint

Contracts:

  * **Durability** — every ``add``/``remove``/``upsert`` is appended to the
    WAL *before* it is applied in memory, under one write lock, so the log
    is always a superset of the applied state.  Recovery
    (``open_durable`` / ``load_index``) loads the ``CURRENT`` checkpoint and
    replays the WAL tail past its pinned position through the same
    ``upsert`` path as the live writes (K5 and K4 on the card), so the result
    is bit-identical to an uncrashed twin that performed exactly the
    surviving operations.  Replay is idempotent (``apply_record``).
  * **Reader isolation** — a query captures one immutable read view
    (``MutableIndex.read_view``, carrying a frozen view of the attribute
    store) under the lock and executes against it off-lock, from the
    predicate match to the last merge.  Writers follow a rebind-don't-mutate
    discipline (copy-on-write live masks, functional delta-segment
    extension), so a view captured mid-write can never see a torn (rows,
    ids, live) triple.
  * **Generation swaps** — compaction and drift refits run OFF the write
    lock: freeze a point-in-time copy (``MutableIndex.frozen_copy``), fold
    or refit it on the maintenance thread, replay the WAL records that
    arrived meanwhile, and swap the finished index in under the lock with a
    bumped ``generation``.  Queries in flight keep the view they started
    with; writers stall only for the pointer swap and the catch-up replay.
  * **Drift** — when a ``DriftDetector`` is attached (table kinds), every
    ingested batch updates a pivot-distance histogram; past the divergence
    threshold ``drift_pending`` is raised and the next maintenance ``tick``
    stages a pivot re-selection + refit on a shadow index and swaps it in.

Segments, their rows and tables live on the index's device; the log, the
checkpoints, ids, live flags and the drift histograms are host state.
Exactness is unconditional: queries are answered by the inner
``MutableIndex``, whose results are bit-identical to a fresh rebuild over
the live rows regardless of which fit generation is installed.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.execute import QuerySurface, execute
from repro_torch.api.mutable import MutableIndex
from repro_torch.api.planner import QueryPlan
from repro_torch.api.query import Query, QueryOptions
from repro_torch.store.drift import DriftDetector
from repro_torch.store.snapshot import (
    STATE_SUBDIR,
    checkpoint_next_seq,
    current_checkpoint,
    publish_checkpoint,
    write_snapshot,
)
from repro_torch.store.wal import (
    DEFAULT_FSYNC_EVERY,
    LogPosition,
    WalRecord,
    WriteAheadLog,
)

__all__ = ["DurableIndex", "apply_record", "open_durable", "segment_pivots"]

#: records between automatic checkpoints (picked up by ``tick``); None = only
#: explicit ``checkpoint()`` calls
DEFAULT_CHECKPOINT_EVERY = 4096

_TABLE_KINDS = ("nsimplex", "laesa")


def segment_pivots(seg) -> Optional[np.ndarray]:
    """The fitted pivot set of a table segment, host numpy (None for the tree)."""
    if seg.kind == "nsimplex":
        return np.asarray(seg._inner.projector.pivots)
    if seg.kind == "laesa":
        return np.asarray(seg._inner.pivots)
    return None


def apply_record(inner: MutableIndex, rec: WalRecord, attributes=None) -> None:
    """Apply one WAL record to a ``MutableIndex``, idempotently.

    ``add`` replays as ``upsert`` (a second application replaces the row
    with itself), ``remove`` skips ids that are already gone — so replaying
    any log range twice reaches the same live state as replaying it once.
    With an ``AttributeStore``, attribute columns logged on the record are
    re-applied the same way (put overwrites, drop ignores absentees).
    """
    if rec.op in ("add", "upsert"):
        inner.upsert(rec.ids, rec.rows)
        if attributes is not None and rec.attrs:
            attributes.put(rec.ids, rec.attrs)
    else:  # remove
        present = [int(i) for i in rec.ids if inner.has_id(int(i))]
        if present:
            inner.remove(present)
        if attributes is not None:
            attributes.drop(rec.ids)


def _refit_segment(template, rows: torch.Tensor, build_params: dict, *, seed: int):
    """A freshly fitted same-kind segment over ``rows`` on the template's
    device (new pivots for the table kinds, new tree for the tree kind).
    The pivots are drawn on the host by ``select_pivots``, as the JAX package
    draws them, so both packages refit on the same pivots.  Returns
    (segment, pivots)."""
    from repro_torch.api.indexes import MetricTreeIndex, PivotTableIndex, SimplexTableIndex
    from repro_torch.core import select_pivots

    metric, device = template.metric, template.device
    if template.kind in _TABLE_KINDS:
        n_pivots = int(build_params.get("n_pivots", template.stats()["n_pivots"]))
        pivots = select_pivots(
            rows.cpu().numpy(),
            n_pivots,
            strategy=build_params.get("pivot_strategy", "random"),
            seed=seed,
            metric=metric,
        )
        if template.kind == "nsimplex":
            seg = SimplexTableIndex.build(
                rows,
                metric,
                pivots=pivots,
                eps=float(build_params.get("eps", 1e-6)),
                use_kernel=bool(build_params.get("use_kernel", True)),
                approx=template.approx,
                device=device,
            )
        else:
            seg = PivotTableIndex.build(rows, metric, pivots=pivots, approx=template.approx, device=device)
        return seg, pivots
    seg = MetricTreeIndex.build(
        rows, metric, leaf_size=int(build_params.get("leaf_size", 32)), seed=seed, device=device
    )
    return seg, None


class DurableIndex(QuerySurface):
    """``Index`` + ``SupportsMutation`` with a WAL, checkpoints, background
    generation swaps, and drift-triggered refits.  Thread-safe for
    concurrent readers AND writers: one writer lock serialises
    mutations/swaps, while queries capture an immutable point-in-time view
    (``_snapshot``) and execute against it entirely off-lock."""

    kind = "durable"

    def __init__(self, inner: MutableIndex, wal: WriteAheadLog, *, wal_dir,
                 build_params: Optional[dict] = None,
                 drift: Optional[DriftDetector] = None,
                 checkpoint_every: Optional[int] = DEFAULT_CHECKPOINT_EVERY,
                 refits: int = 0):
        self._inner = inner
        self._view: Optional[MutableIndex] = None   # cached read view
        self._wal = wal
        self.wal_dir = os.path.abspath(os.fspath(wal_dir))
        self.build_params = dict(build_params or {})
        self._drift = drift
        self.checkpoint_every = (
            int(checkpoint_every) if checkpoint_every is not None else None
        )
        self.refits = int(refits)
        self.drift_pending = False
        #: longest write-lock hold of a generation swap (catch-up replay +
        #: pointer swap), seconds
        self.max_swap_hold_s = 0.0
        self._lock = threading.RLock()          # writers + swaps + snapshots
        self._maintenance = threading.RLock()   # one fold/refit/checkpoint at a time
        self._ckpt_seq = wal.next_seq           # next_seq at the last checkpoint

    # -- construction ----------------------------------------------------------
    @classmethod
    def create(cls, inner: MutableIndex, wal_dir, *,
               build_params: Optional[dict] = None,
               drift_threshold: Optional[float] = None,
               fsync_every: int = DEFAULT_FSYNC_EVERY,
               checkpoint_every: Optional[int] = DEFAULT_CHECKPOINT_EVERY,
               query_options=None,
               attributes=None,
               ) -> "DurableIndex":
        """Initialise a brand-new durable store under ``wal_dir`` (refuses a
        directory that already holds a checkpoint — recover those with
        ``open_durable``) and publish the initial checkpoint so recovery is
        possible from the first record on."""
        wal_dir = os.path.abspath(os.fspath(wal_dir))
        if current_checkpoint(wal_dir) is not None:
            raise ValueError(
                f"{wal_dir!r} already holds a durable store; recover it with "
                "repro_torch.store.open_durable (or load_index on a snapshot) "
                "instead of building over it"
            )
        wal = WriteAheadLog(wal_dir, fsync_every=fsync_every)
        if wal.next_seq:
            raise ValueError(
                f"{wal_dir!r} holds WAL records but no checkpoint; refusing "
                "to overwrite a possibly-recoverable log"
            )
        build_params = dict(build_params or {})
        build_params.setdefault("fsync_every", int(fsync_every))
        build_params["checkpoint_every"] = checkpoint_every
        drift = None
        if drift_threshold is not None and inner._base.kind in _TABLE_KINDS:
            drift = DriftDetector(
                segment_pivots(inner._base), inner.metric, inner._base.data,
                threshold=float(drift_threshold), device=inner.device,
            )
            build_params["drift_threshold"] = float(drift_threshold)
        out = cls(
            inner, wal, wal_dir=wal_dir, build_params=build_params,
            drift=drift, checkpoint_every=checkpoint_every,
        )
        out.query_options = query_options
        if attributes is not None:
            # attach BEFORE the initial checkpoint so recovery from record
            # zero already carries the schema (and any pre-ingested rows)
            out.attach_attributes(attributes)
        out.checkpoint()
        return out

    # -- introspection ---------------------------------------------------------
    @property
    def metric(self):
        return self._inner.metric

    @property
    def device(self) -> torch.device:
        return self._inner.device

    @property
    def data(self) -> torch.Tensor:
        return self._snapshot().data

    @property
    def generation(self) -> int:
        return self._snapshot().generation

    @property
    def pending_compaction(self) -> bool:
        return self._snapshot().pending_compaction

    def ids(self) -> np.ndarray:
        return self._snapshot().ids()

    def has_id(self, logical_id: int) -> bool:
        return self._snapshot().has_id(logical_id)

    def drift_stat(self) -> float:
        with self._lock:
            return self._drift.statistic() if self._drift is not None else 0.0

    def attach_attributes(self, store):
        with self._lock:
            self.attributes = store
            self._view = None
        return self

    def _snapshot(self) -> MutableIndex:
        """An immutable point-in-time view of the inner index.

        The view shares the live arrays under the rebind-don't-mutate
        discipline (``MutableIndex.read_view``), so a concurrent
        ``add``/``upsert``/``remove``/generation swap can never tear the
        (rows, ids, live) triple a reader captured, and concurrent readers
        share one already-materialised delta segment.  It carries a
        ``view()`` of the attribute store taken at the same point.  The
        cached view is invalidated by every mutation (and by a direct
        ``put``/``drop`` on the store, seen by its version) and rebuilt
        lazily here."""
        with self._lock:
            view, store = self._view, self.attributes
            stale_attrs = store is not None and (view is None or view.attributes is None
                                                 or view.attributes.version != store.version)
            if view is None or stale_attrs:
                view = self._inner.read_view()
                view.attributes = None if store is None else store.view()
                self._view = view
            return view

    # -- queries ---------------------------------------------------------------
    def query(self, q, spec: Query, *, plan: Optional[QueryPlan] = None):
        """Answer one ``Query`` against ONE read view, held for the whole
        execution: the predicate match, an allowlist's row gather and every
        segment call see the same point in time.  The plan is this index's
        own (``index_kind`` "durable"), and this index's ``telemetry`` (not
        the view's) observes the execution, as the planner reads it here."""
        qp = plan if plan is not None else self.plan(spec)
        return execute(self._snapshot(), q, spec, plan=qp, telemetry=self.telemetry)

    # -- mutations (WAL-first) -------------------------------------------------
    def add(self, rows: np.ndarray, ids=None, attrs=None) -> np.ndarray:
        rows = np.atleast_2d(np.asarray(rows))
        with self._lock:
            self._inner._check_rows(rows)
            if ids is None:
                ids = np.arange(
                    self._inner._next_id, self._inner._next_id + len(rows),
                    dtype=np.int64,
                )
            else:
                ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
                # validate BEFORE logging: a rejected mutation must never
                # reach the WAL (recovery would replay it)
                if ids.shape != (len(rows),):
                    raise ValueError(f"need {len(rows)} ids; got {ids.shape}")
                if len(np.unique(ids)) != len(ids):
                    raise ValueError(f"duplicate ids in one add batch: {ids.tolist()}")
                for i in ids:
                    if self._inner._locate(int(i)) is not None:
                        raise KeyError(f"id {int(i)} is already live; use upsert")
            if attrs is not None and len(rows):
                # the store validates and rebinds atomically, so a rejected
                # attrs batch aborts here — before the WAL sees the record
                self._attrs_put(ids, attrs)
            if len(rows):
                self._wal.append("add", ids, rows, attrs=attrs)
            out = self._inner.add(rows, ids=ids)
            self._view = None
            self._observe(rows)
            return out

    def remove(self, ids) -> None:
        with self._lock:
            ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
            # validate BEFORE logging (uniqueness included): a rejected batch
            # must never reach the WAL half-applied — replay would reapply it
            if len(np.unique(ids)) != len(ids):
                raise ValueError(f"duplicate ids in one remove batch: {ids.tolist()}")
            for i in ids:
                if self._inner._locate(int(i)) is None:
                    raise KeyError(f"id {int(i)} not in index")
            self._wal.append("remove", ids)
            self._inner.remove(ids)
            self._attrs_drop(ids)
            self._view = None

    def upsert(self, ids, rows: np.ndarray, attrs=None) -> np.ndarray:
        rows = np.atleast_2d(np.asarray(rows))
        with self._lock:
            self._inner._check_rows(rows)
            ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
            if ids.shape != (len(rows),):
                raise ValueError(f"need {len(rows)} ids; got {ids.shape}")
            if len(np.unique(ids)) != len(ids):
                raise ValueError(f"duplicate ids in one upsert batch: {ids.tolist()}")
            if attrs is not None:
                self._attrs_put(ids, attrs)   # validate-and-rebind before logging
            self._wal.append("upsert", ids, rows, attrs=attrs)
            out = self._inner.upsert(ids, rows)
            self._view = None
            self._observe(rows)
            return out

    def _observe(self, rows) -> None:
        """Fold ingested rows into the drift histogram (lock held)."""
        if self._drift is None or not len(rows):
            return
        self._drift.update(rows)
        if self._drift.drifted:
            self.drift_pending = True

    def flush(self) -> None:
        """Force-sync every acknowledged mutation to stable storage."""
        self._wal.flush()

    def close(self) -> None:
        self._wal.close()

    # -- maintenance: compaction / refit / checkpoint --------------------------
    def compact(self) -> "DurableIndex":
        """Fold the delta + tombstones into a fresh base and swap it in under
        the next generation.  The fold runs on the calling thread but OFF the
        write lock: a point-in-time copy is folded, writes that land
        meanwhile are caught up from the WAL, and only the swap itself
        briefly holds the lock."""
        with self._maintenance:
            with self._lock:
                frozen = self._inner.frozen_copy()
                from_pos = self._wal.position()
            folded = frozen.compact()           # the expensive fold, off-lock
            self._swap_in(folded, from_pos)
        return self

    def refit(self) -> "DurableIndex":
        """Stage a pivot re-selection + refit on a shadow index and swap it
        in atomically (the drift response; also callable directly).  The
        shadow is fitted off the write lock; ids, query results, and the
        WAL tail all carry over exactly."""
        with self._maintenance:
            with self._lock:
                frozen = self._inner.frozen_copy()
                from_pos = self._wal.position()
            folded = frozen.compact()
            live = folded._base_live
            rows = folded._base.data[torch.as_tensor(live, device=folded.device)]
            lids = folded._base_ids[live]
            if not len(lids):               # nothing to fit a pivot set on
                with self._lock:
                    self.drift_pending = False
                return self
            seed = int(self.build_params.get("seed", 0)) + 1000 * (self.refits + 1)
            seg, pivots = _refit_segment(folded._base, rows, self.build_params, seed=seed)
            shadow = MutableIndex(seg, ids=lids, compact_threshold=folded.compact_threshold)
            shadow.generation = folded.generation + 1
            shadow.compactions = folded.compactions
            shadow._next_id = folded._next_id
            shadow.query_options = self.query_options
            self._swap_in(shadow, from_pos)
            with self._lock:
                self.refits += 1
                self.drift_pending = False
                if self._drift is not None and pivots is not None:
                    self._drift.rebase(pivots, rows)
            self.checkpoint()               # pin the new fit for recovery
        return self

    def _swap_in(self, candidate: MutableIndex, from_pos: LogPosition) -> None:
        """Replay the records that arrived after ``from_pos`` into the
        candidate, then install it (the generation swap)."""
        with self._lock:
            t0 = time.perf_counter()
            for rec in self._wal.replay(from_pos):
                apply_record(candidate, rec)
            candidate.version = max(candidate.version, self._inner.version)
            self._inner = candidate
            self._view = None
            self.max_swap_hold_s = max(self.max_swap_hold_s, time.perf_counter() - t0)

    @property
    def checkpoint_due(self) -> bool:
        return (
            self.checkpoint_every is not None
            and self._wal.next_seq - self._ckpt_seq >= self.checkpoint_every
        )

    def checkpoint(self) -> str:
        """Publish an internal checkpoint: roll the WAL, snapshot the state
        behind an atomically-replaced ``CURRENT`` pointer, GC superseded
        checkpoints and fully-covered WAL segments.  The device-to-host copy
        of the state runs off the write lock, on a frozen copy."""
        with self._maintenance:
            with self._lock:
                self._wal.roll()
                frozen = self._inner.frozen_copy()
                pos = self._wal.position()
                next_seq = self._wal.next_seq
                self._ckpt_seq = next_seq
                # the attribute view must be captured at the SAME point as
                # the frozen state, or replay from ``pos`` would double- or
                # under-apply attrs relative to the rows
                attrs = None if self.attributes is None else self.attributes.view()
            path = publish_checkpoint(
                self.wal_dir, frozen, position=pos, next_seq=next_seq,
                refits=self.refits, build_params=self.build_params,
                query_options=self._options_dict(), attributes=attrs,
            )
            self._wal.remove_segments_before(pos.segment)
            return path

    def tick(self) -> Optional[str]:
        """One background-maintenance step (called by
        ``BackgroundCompactor``): drift refit first (it also compacts),
        then deferred compaction, then a due checkpoint."""
        if self.drift_pending:
            self.refit()
            return "refit"
        if self._inner.pending_compaction:
            self.compact()
            return "compact"
        if self.checkpoint_due:
            self.checkpoint()
            return "checkpoint"
        return None

    # -- protocol: fit ---------------------------------------------------------
    def fit(self, data) -> "DurableIndex":
        """Full rebuild over new data (ids reset 0..N-1).  The WAL history
        no longer describes the state, so a checkpoint is published
        immediately — recovery resumes from the new baseline."""
        with self._maintenance:
            with self._lock:
                self._inner.fit(data)
                self._view = None
                if self._drift is not None:
                    pivots = segment_pivots(self._inner._base)
                    if pivots is not None:
                        self._drift.rebase(pivots, self._inner._base.data)
                self.drift_pending = False
            self.checkpoint()
        return self

    # -- execution primitives (dispatched by repro_torch.api.execute) ----------
    # rowmask carries LOGICAL ids here (the currency queries and the
    # attribute store speak); the snapshot translates them per side
    def _exec_knn(self, q, k, cfg=None, **kw):
        return self._snapshot()._exec_knn(q, k, cfg, **kw)

    def _exec_knn_batch(self, queries, k, cfg=None, **kw):
        return self._snapshot()._exec_knn_batch(queries, k, cfg, **kw)

    def _exec_search(self, q, threshold, cfg=None, **kw):
        return self._snapshot()._exec_search(q, threshold, cfg, **kw)

    def _exec_search_batch(self, queries, thresholds, cfg=None, **kw):
        return self._snapshot()._exec_search_batch(queries, thresholds, cfg, **kw)

    # -- stats / persistence ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            inner = self._inner
            drift_stat = self._drift.statistic() if self._drift is not None else 0.0
            drift_pending = self.drift_pending
            refits = self.refits
        wal = self._wal.stats()
        return {
            **inner.stats(),
            "kind": self.kind,
            "wal_dir": self.wal_dir,
            "wal_records": int(wal["next_seq"]),
            "wal_bytes": int(self._wal.total_bytes()),
            "wal_synced": int(wal["synced_through"]),
            "refits": int(refits),
            "drift_stat": float(drift_stat),
            "drift_pending": bool(drift_pending),
        }

    def _options_dict(self) -> Optional[dict]:
        return self.query_options.to_dict() if self.query_options else None

    def save(self, path) -> None:
        """External snapshot-consistent save — legal while dirty and while
        writes keep arriving.  The manifest pins the WAL position at the
        freeze; ``load_index`` replays everything past it, so the loaded
        index equals the live state, not the save-time state.  Loading
        verifies sequence continuity against the pinned position: if a later
        checkpoint garbage-collected part of the pinned tail, ``load_index``
        raises ``WalCorruption`` instead of silently recovering a state that
        is neither the save-time nor the live one (take a fresh save after
        checkpoints you intend to load across)."""
        with self._lock:
            frozen = self._inner.frozen_copy()
            pos = self._wal.position()
            next_seq = self._wal.next_seq
            attrs = None if self.attributes is None else self.attributes.view()
        self._wal.flush()
        write_snapshot(
            frozen, path, wal_dir=self.wal_dir, position=pos,
            next_seq=next_seq, refits=self.refits,
            build_params=self.build_params,
            query_options=self._options_dict(), attributes=attrs,
        )

    @classmethod
    def _load(cls, path, manifest: dict, arrays: dict, *, device="cuda",
              wal_dir_override: Optional[str] = None) -> "DurableIndex":
        from repro_torch.api.factory import load_index
        from repro_torch.filter.store import AttributeStore

        params = manifest["params"]
        inner = load_index(os.path.join(os.fspath(path), STATE_SUBDIR), device=device)
        bp = dict(params.get("build_params") or {})
        wal_dir = wal_dir_override or params["wal_dir"]
        # seq_floor: even if every segment the manifest knew about has been
        # garbage-collected (empty head after a checkpoint roll), new records
        # must never restart numbering below already-snapshotted ones.  The
        # live internal checkpoint's next_seq is the authoritative tail after
        # a GC — without it, loading a stale external snapshot whose pinned
        # tail was collected would pass completeness verification silently.
        floor = int(params.get("next_seq", 0))
        internal = checkpoint_next_seq(wal_dir)
        if internal is not None:
            floor = max(floor, internal)
        wal = WriteAheadLog(
            wal_dir,
            fsync_every=int(bp.get("fsync_every", DEFAULT_FSYNC_EVERY)),
            seq_floor=floor,
        )
        drift = None
        if bp.get("drift_threshold") is not None and inner._base.kind in _TABLE_KINDS:
            drift = DriftDetector(
                segment_pivots(inner._base), inner.metric, inner._base.data,
                threshold=float(bp["drift_threshold"]), device=inner.device,
            )
        out = cls(
            inner, wal, wal_dir=wal_dir, build_params=bp, drift=drift,
            checkpoint_every=bp.get("checkpoint_every", DEFAULT_CHECKPOINT_EVERY),
            refits=int(params.get("refits", 0)),
        )
        attrs = AttributeStore.maybe_load(os.path.join(os.fspath(path), "attributes"))
        if attrs is not None:
            out.attach_attributes(attrs)
        # replay the tail past the pinned position — idempotent, torn-tail
        # tolerant, and the drift histogram re-observes the replayed rows.
        # expect_seq pins the first replayed record to the manifest's
        # next_seq: if the log between the snapshot and the surviving
        # segments was garbage-collected (e.g. a checkpoint GC'd the segment
        # an external save pinned), recovery raises WalCorruption instead of
        # silently replaying a partial tail onto the save-time state.
        pos = LogPosition.from_dict(params["position"])
        expected = params.get("next_seq")
        with out._lock:
            for rec in wal.replay(pos, expect_seq=None if expected is None else int(expected)):
                apply_record(inner, rec, attributes=out.attributes)
                if rec.rows is not None:
                    out._observe(rec.rows)
        out._ckpt_seq = int(params.get("next_seq", wal.next_seq))
        out.query_options = QueryOptions.from_dict(params.get("query_options"))
        return out

    def __enter__(self) -> "DurableIndex":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_durable(wal_dir, *, device="cuda") -> DurableIndex:
    """Crash-recovery entry point: reopen the durable store living under
    ``wal_dir`` on ``device`` from its ``CURRENT`` checkpoint + WAL tail.
    The directory is relocatable — recovery replays from the directory it
    was given, not the path recorded at checkpoint time."""
    from repro_torch.api.persistence import read_index_dir
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    wal_dir = os.path.abspath(os.fspath(wal_dir))
    ckpt = current_checkpoint(wal_dir)
    if ckpt is None:
        raise FileNotFoundError(
            f"no durable checkpoint under {wal_dir!r} (missing CURRENT); "
            "was this directory created by build_index(durable=True)?"
        )
    manifest, arrays = read_index_dir(ckpt)
    return DurableIndex._load(ckpt, manifest, arrays, device=dev, wal_dir_override=wal_dir)

