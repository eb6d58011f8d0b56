"""The durable store in the port (``repro_torch.store``), on the CPU.

Two halves.  The first twins every test of the JAX package's
``tests/test_store.py`` on ``device="cpu"``: the WAL, crash recovery at every
record boundary and mid-record, snapshots and checkpoints, deferred
compaction and generation swaps, drift refits, the factory surface, replay
verification and reader isolation under concurrent writes.  The second holds
the port against the JAX package (built under ``enable_x64``; the n-simplex
kind with ``use_kernel=True``, the algorithm the port follows): WAL records
byte-equal, durable directories (checkpoint + WAL tail, with attributes)
written by either package opened by the other with ids in (distance, id)
order equal, distances within 1e-12 and ``QueryStats`` counts equal, the same
torn tail replayed to the same count and position, the drift statistic
within 1e-9 with the same ``drift_pending``, the same refit pivots and
answers, ``explain()`` equal, and the WAL tools' lines equal.
"""

import io
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Query as RQuery, build_index as rbuild, load_index as rload
from repro.compat import enable_x64
from repro.data import colors_like
from repro.filter import AttributeStore as RStore, Predicate as RPredicate
from repro.store import open_durable as ropen_durable, segment_pivots as rsegment_pivots
from repro.store.wal import encode_record as rencode_record
from repro_torch.api import STATS_CONTRACT, Query, build_index, load_index
from repro_torch.filter import AttributeStore, Predicate
from repro_torch.store import (
    BackgroundCompactor,
    DurableIndex,
    LogPosition,
    WalCorruption,
    WriteAheadLog,
    current_checkpoint,
    encode_record,
    list_checkpoints,
    open_durable,
    scan_segment,
    segment_pivots,
)
from repro_torch.store import compactor as compactor_mod, wal_inspect
from repro_torch.store.wal import PREFIX_BYTES

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
BUILD_KW = dict(n_pivots=5, pivot_strategy="maxmin", seed=3)


def pbuild(data, metric="euclidean", **kw):
    return build_index(data, metric, device="cpu", **kw)


def popen(wal_dir):
    return open_durable(wal_dir, device="cpu")


def durable_kw(tmp_path, name="wal", **over):
    kw = dict(
        durable=True,
        wal_dir=os.fspath(tmp_path / name),
        fsync_every=2,
        checkpoint_every=None,
        compact_threshold=None,
        **BUILD_KW,
    )
    kw.update(over)
    return kw


def assert_same_results(a, b, queries, k=5):
    """ids, rows, and k-NN answers (ids AND distances) bit-identical."""
    ia, ib = np.sort(a.ids()), np.sort(b.ids())
    assert np.array_equal(ia, ib)
    da = dict(zip(a.ids().tolist(), a.data.numpy()))
    db = dict(zip(b.ids().tolist(), b.data.numpy()))
    for i in ia:
        np.testing.assert_array_equal(da[int(i)], db[int(i)])
    if len(ia):
        ra = a.knn_batch(queries, k=min(k, len(ia)))
        rb = b.knn_batch(queries, k=min(k, len(ib)))
        for qa, qb in zip(ra, rb):
            assert np.array_equal(qa.ids, qb.ids)
            np.testing.assert_array_equal(qa.distances, qb.distances)


# ---------------------------------------------------------------------------
# WAL unit behaviour
# ---------------------------------------------------------------------------
class TestWal:
    def test_append_replay_roundtrip(self, tmp_path):
        rows = colors_like(n=6, seed=1)
        with WriteAheadLog(tmp_path / "w") as wal:
            wal.append("add", [0, 1, 2], rows[:3])
            wal.append("remove", [1])
            wal.append("upsert", [0, 5], rows[3:5])
            recs = list(wal.replay())
        assert [r.op for r in recs] == ["add", "remove", "upsert"]
        assert [r.seq for r in recs] == [0, 1, 2]
        np.testing.assert_array_equal(recs[0].ids, [0, 1, 2])
        np.testing.assert_array_equal(recs[0].rows, rows[:3])
        assert recs[0].rows.dtype == rows.dtype and recs[0].rows.flags.writeable
        assert recs[1].rows is None
        np.testing.assert_array_equal(recs[2].rows, rows[3:5])

    def test_seq_continues_across_reopen_and_roll(self, tmp_path):
        with WriteAheadLog(tmp_path / "w") as wal:
            wal.append("add", [0], colors_like(n=1, seed=2))
            wal.roll()
            wal.append("remove", [0])
        wal2 = WriteAheadLog(tmp_path / "w")
        assert wal2.next_seq == 2
        wal2.append("remove", [9])
        assert [r.seq for r in wal2.replay()] == [0, 1, 2]
        wal2.close()

    def test_replay_from_position(self, tmp_path):
        rows = colors_like(n=4, seed=3)
        wal = WriteAheadLog(tmp_path / "w")
        wal.append("add", [0], rows[:1])
        mid = wal.position()
        wal.append("add", [1], rows[1:2])
        wal.append("remove", [0])
        tail = list(wal.replay(mid))
        assert [r.seq for r in tail] == [1, 2]
        wal.close()

    def test_torn_tail_is_dropped_and_truncated_on_reopen(self, tmp_path):
        wal = WriteAheadLog(tmp_path / "w")
        wal.append("add", [0], colors_like(n=1, seed=4))
        wal.close()
        seg = os.path.join(wal.dir, "wal-00000000.log")
        good = os.path.getsize(seg)
        with open(seg, "ab") as f:
            f.write(b"\x01\x02torn-garbage")
        wal2 = WriteAheadLog(tmp_path / "w")
        assert [r.seq for r in wal2.replay()] == [0]
        assert os.path.getsize(seg) == good          # tail truncated
        wal2.append("remove", [0])                   # appends stay valid
        assert [r.op for r in wal2.replay()] == ["add", "remove"]
        wal2.close()

    def test_corruption_in_older_segment_raises(self, tmp_path):
        wal = WriteAheadLog(tmp_path / "w")
        wal.append("add", [0], colors_like(n=1, seed=5))
        wal.roll()
        wal.append("remove", [0])
        seg0 = os.path.join(wal.dir, "wal-00000000.log")
        blob = bytearray(open(seg0, "rb").read())
        blob[PREFIX_BYTES + 2] ^= 0xFF               # flip a header byte
        open(seg0, "wb").write(bytes(blob))
        with pytest.raises(WalCorruption):
            list(wal.replay())
        wal.close()

    def test_checksum_rejects_payload_flip(self, tmp_path):
        wal = WriteAheadLog(tmp_path / "w")
        wal.append("add", [0, 1], colors_like(n=2, seed=6))
        wal.flush()
        seg = os.path.join(wal.dir, "wal-00000000.log")
        blob = bytearray(open(seg, "rb").read())
        blob[-3] ^= 0x40                             # flip a payload byte
        open(seg, "wb").write(bytes(blob))
        records, valid_end, size = scan_segment(seg)
        assert records == [] and valid_end == 0 and size == len(blob)
        wal.close()

    def test_fsync_batching_counters(self, tmp_path):
        wal = WriteAheadLog(tmp_path / "w", fsync_every=4)
        for i in range(6):
            wal.append("remove", [i])
        assert wal.stats()["synced_through"] == 4    # one batch synced
        wal.flush()
        assert wal.stats()["synced_through"] == 6
        assert wal.total_bytes() > 0
        wal.close()

    def test_segment_gc(self, tmp_path):
        wal = WriteAheadLog(tmp_path / "w")
        wal.append("remove", [0])
        wal.roll()
        wal.append("remove", [1])
        wal.roll()
        assert wal.segments() == [0, 1, 2]
        removed = wal.remove_segments_before(2)
        assert removed == [0, 1] and wal.segments() == [2]
        wal.close()

    def test_position_ordering(self):
        assert LogPosition(0, 100) < LogPosition(1, 0) < LogPosition(1, 50)
        d = LogPosition(3, 17).to_dict()
        assert LogPosition.from_dict(d) == LogPosition(3, 17)


# ---------------------------------------------------------------------------
# crash-recovery fault injection
# ---------------------------------------------------------------------------
def _ops_script(pool):
    """Deterministic mixed mutation sequence (each op = one WAL record)."""
    return [
        ("add", None, pool[0:3]),
        ("add", None, pool[3:5]),
        ("remove", [301], None),
        ("upsert", [300, 410], pool[5:7]),
        ("add", None, pool[7:8]),
        ("remove", [300, 410], None),
        ("upsert", [302, 303], pool[8:10]),
    ]


def _apply_op(idx, op):
    kind, ids, rows = op
    if kind == "add":
        idx.add(rows, ids=ids)
    elif kind == "remove":
        idx.remove(ids)
    else:
        idx.upsert(ids, rows)


def _newest_segment(wal_dir) -> int:
    wal = WriteAheadLog(wal_dir)          # read-only peek at the layout
    seg = sorted(wal.segments())[-1]
    wal.close()
    return seg


class TestCrashRecovery:
    @pytest.fixture()
    def crashed(self, tmp_path):
        """A durable store with the op script applied, plus its twin-by-
        construction (same base build) to replay op prefixes against."""
        data = colors_like(n=300, seed=20)
        pool = colors_like(n=16, seed=21)
        queries = colors_like(n=4, seed=22)
        live = pbuild(data, **durable_kw(tmp_path, "live"))
        twin = pbuild(data, **durable_kw(tmp_path, "twin"))
        for op in _ops_script(pool):
            _apply_op(live, op)
        live.flush()
        live.close()
        return tmp_path, pool, queries, twin

    def _recover_copy(self, tmp_path, n, cut):
        """Copy the live WAL dir and cut its active segment at byte ``cut``."""
        src = os.fspath(tmp_path / "live")
        dst = os.fspath(tmp_path / f"crash-{n}")
        shutil.copytree(src, dst)
        seg_path = os.path.join(dst, f"wal-{_newest_segment(src):08d}.log")
        with open(seg_path, "r+b") as f:
            f.truncate(cut)
        return popen(dst)

    def _boundaries(self, tmp_path):
        src = os.fspath(tmp_path / "live")
        records, valid_end, size = scan_segment(os.path.join(src, f"wal-{_newest_segment(src):08d}.log"))
        return records, valid_end, size

    def test_kill_at_every_record_boundary(self, crashed):
        tmp_path, pool, queries, twin = crashed
        records, valid_end, size = self._boundaries(tmp_path)
        assert valid_end == size and len(records) == len(_ops_script(pool))
        boundaries = [0] + [r[4] for r in records]
        ops = _ops_script(pool)
        for i, cut in enumerate(boundaries):
            recovered = self._recover_copy(tmp_path, f"b{i}", cut)
            # twin has exactly ops[:i] applied at this point of the sweep
            assert_same_results(recovered, twin, queries)
            recovered.close()
            if i < len(ops):
                _apply_op(twin, ops[i])

    def test_kill_mid_record_drops_only_the_torn_record(self, crashed):
        tmp_path, pool, queries, twin = crashed
        records, _, _ = self._boundaries(tmp_path)
        boundaries = [0] + [r[4] for r in records]
        ops = _ops_script(pool)
        for i in range(len(ops)):
            start, end = boundaries[i], boundaries[i + 1]
            for j, cut in enumerate(
                {start + 1, start + PREFIX_BYTES, start + (end - start) // 2, end - 1}
            ):
                recovered = self._recover_copy(tmp_path, f"m{i}-{j}", cut)
                # the torn record i is dropped: state == ops[:i]
                assert_same_results(recovered, twin, queries)
                recovered.close()
            _apply_op(twin, ops[i])

    def test_replay_is_idempotent_and_recovery_can_continue(self, crashed):
        tmp_path, pool, queries, twin = crashed
        for op in _ops_script(pool):
            _apply_op(twin, op)
        dst = os.fspath(tmp_path / "reopen")
        shutil.copytree(os.fspath(tmp_path / "live"), dst)
        r1 = popen(dst)
        assert_same_results(r1, twin, queries)
        r1.close()
        r2 = popen(dst)                  # recover the recovered store
        assert_same_results(r2, twin, queries)
        extra = colors_like(n=2, seed=23)
        new_ids = r2.add(extra)          # recovery leaves an appendable log
        r2.flush()
        r2.close()
        twin.add(extra, ids=new_ids)
        r3 = popen(dst)
        assert_same_results(r3, twin, queries)
        r3.close()
        twin.close()

    def test_garbage_tail_is_survivable(self, tmp_path):
        data = colors_like(n=120, seed=24)
        idx = pbuild(data, **durable_kw(tmp_path, "g"))
        idx.add(colors_like(n=3, seed=25))
        idx.flush()
        idx.close()
        wal_dir = os.fspath(tmp_path / "g")
        with open(os.path.join(wal_dir, f"wal-{_newest_segment(wal_dir):08d}.log"), "ab") as f:
            f.write(os.urandom(37))      # torn write: partial garbage record
        recovered = popen(wal_dir)
        assert recovered.stats()["n_objects"] == 123
        recovered.close()


# ---------------------------------------------------------------------------
# snapshots: checkpoints + save-while-dirty
# ---------------------------------------------------------------------------
class TestSnapshots:
    def test_save_while_dirty_roundtrips_through_load_index(self, tmp_path):
        data = colors_like(n=200, seed=30)
        queries = colors_like(n=4, seed=31)
        idx = pbuild(data, **durable_kw(tmp_path))
        idx.add(colors_like(n=20, seed=32))
        idx.remove([5, 17, 203])
        idx.upsert([7, 500], colors_like(n=2, seed=33))
        assert idx.stats()["delta_rows"] > 0      # genuinely dirty
        snap = os.fspath(tmp_path / "snap")
        idx.save(snap)
        loaded = load_index(snap, device="cpu")
        assert loaded.kind == "durable"
        assert_same_results(loaded, idx, queries)
        loaded.close()
        idx.close()

    def test_save_then_more_writes_load_replays_tail(self, tmp_path):
        # the snapshot pins a WAL position; writes AFTER the save are in the
        # log, so load returns the LIVE state, not the save-time state
        data = colors_like(n=150, seed=34)
        queries = colors_like(n=4, seed=35)
        idx = pbuild(data, **durable_kw(tmp_path))
        snap = os.fspath(tmp_path / "snap")
        idx.save(snap)
        idx.add(colors_like(n=10, seed=36))
        idx.remove([3])
        idx.flush()
        loaded = load_index(snap, device="cpu")
        assert_same_results(loaded, idx, queries)
        loaded.close()
        idx.close()

    def test_checkpoint_gc_and_current_pointer(self, tmp_path):
        data = colors_like(n=100, seed=37)
        idx = pbuild(data, **durable_kw(tmp_path))
        wal_dir = idx.wal_dir
        first = current_checkpoint(wal_dir)
        assert first is not None
        idx.add(colors_like(n=8, seed=38))
        idx.checkpoint()
        second = current_checkpoint(wal_dir)
        assert second != first
        assert list_checkpoints(wal_dir) == [os.path.basename(second)]
        assert not os.path.isdir(first)          # superseded ckpt collected
        assert len(idx._wal.segments()) == 1     # covered segments collected
        idx.close()

    def test_checkpoint_due_and_tick(self, tmp_path):
        data = colors_like(n=100, seed=39)
        idx = pbuild(data, **durable_kw(tmp_path, checkpoint_every=3))
        assert idx.tick() is None
        for i in range(3):
            idx.add(colors_like(n=1, seed=40 + i))
        assert idx.checkpoint_due
        assert idx.tick() == "checkpoint"
        assert not idx.checkpoint_due
        idx.close()

    def test_create_refuses_existing_store(self, tmp_path):
        data = colors_like(n=80, seed=41)
        idx = pbuild(data, **durable_kw(tmp_path))
        idx.close()
        with pytest.raises(ValueError, match="already holds a durable store"):
            pbuild(data, **durable_kw(tmp_path))


# ---------------------------------------------------------------------------
# deferred compaction + generation swaps
# ---------------------------------------------------------------------------
def _wait_until(cond, timeout_s=20.0):
    """Poll ``cond`` until true or the deadline; a generous deadline so a
    loaded test machine (many workers) cannot flake a background-thread wait."""
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


class TestCompaction:
    def test_deferred_flag_and_explicit_compact(self, tmp_path):
        data = colors_like(n=200, seed=50)
        queries = colors_like(n=4, seed=51)
        idx = pbuild(data, **durable_kw(tmp_path, compact_threshold=0.2))
        idx.add(colors_like(n=80, seed=52))
        st = idx.stats()
        assert st["pending_compaction"] and st["delta_rows"] == 80
        before = idx.knn_batch(queries, k=5)
        g0 = idx.generation
        idx.compact()
        st = idx.stats()
        assert not st["pending_compaction"]
        assert st["delta_rows"] == 0 and st["base_rows"] == 280
        assert idx.generation == g0 + 1
        after = idx.knn_batch(queries, k=5)
        for a, b in zip(before, after):
            assert np.array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.distances, b.distances)
        idx.close()

    def test_background_compactor_picks_up_pending(self, tmp_path):
        data = colors_like(n=200, seed=53)
        idx = pbuild(data, **durable_kw(tmp_path, compact_threshold=0.2))
        bg = BackgroundCompactor(idx)
        idx.add(colors_like(n=80, seed=54))
        assert idx.pending_compaction
        assert bg.run_pending() == 1             # inline pass (no thread)
        assert not idx.pending_compaction
        assert bg.counters["compactions"] == 1
        assert idx.stats()["delta_rows"] == 0
        idx.close()

    def test_background_thread_lifecycle(self, tmp_path):
        data = colors_like(n=150, seed=55)
        idx = pbuild(data, **durable_kw(tmp_path, compact_threshold=0.2))
        with BackgroundCompactor(idx, interval_s=0.005) as bg:
            assert bg.running
            idx.add(colors_like(n=60, seed=56))
            bg.kick()
            # wait on the compactor's own counter, with a deadline of seconds
            assert _wait_until(lambda: bg.counters["compactions"] >= 1)
            assert not idx.pending_compaction
        assert not bg.running
        assert bg.last_error is None and bg.counters["errors"] == 0
        idx.close()

    def test_writes_during_fold_survive_the_swap(self, tmp_path):
        # freeze -> fold -> catch-up replay: rows added between the freeze
        # and the swap must be present afterwards (the WAL catch-up path)
        data = colors_like(n=150, seed=57)
        idx = pbuild(data, **durable_kw(tmp_path))
        idx.add(colors_like(n=30, seed=58))
        frozen = idx._inner.frozen_copy()
        from_pos = idx._wal.position()
        late = idx.add(colors_like(n=5, seed=59))    # lands after the freeze
        folded = frozen.compact()
        idx._swap_in(folded, from_pos)
        for i in late:
            assert idx.has_id(int(i))
        assert idx.stats()["n_objects"] == 185
        idx.close()

    def test_stats_contract(self, tmp_path):
        data = colors_like(n=100, seed=60)
        idx = pbuild(data, **durable_kw(tmp_path))
        st = idx.stats()
        assert st["kind"] == "durable"
        assert STATS_CONTRACT["durable"] <= set(st)
        assert STATS_CONTRACT["mutable"] <= set(st)
        idx.close()


# ---------------------------------------------------------------------------
# drift detection + shadow refit
# ---------------------------------------------------------------------------
def _shifted(n, seed, dim, dtype=np.float32):
    return np.roll(colors_like(n=n, seed=seed, dtype=dtype), dim // 3, axis=1)


def _mean_bound_width(seg, queries) -> float:
    """Mean two-sided bound width (upb - lwb) of ``queries`` against a
    fitted ``SimplexTableIndex`` segment (the JAX package's benchmark helper
    of the same name, on the port's segment)."""
    inner = seg._inner
    lwb, upb = inner.bounds_batch(inner.query_apex_batch(np.asarray(queries)))
    return float((upb - lwb).mean())


class TestDrift:
    def test_same_distribution_does_not_trigger(self, tmp_path):
        X = colors_like(n=600, seed=70)      # one draw: identical mixture
        data, stream = X[:400], X[400:]
        idx = pbuild(data, **durable_kw(tmp_path, drift_threshold=0.2))
        idx.add(stream)
        assert not idx.drift_pending
        assert idx.drift_stat() < 0.2
        idx.close()

    def test_shifted_burst_triggers_refit_and_preserves_results(self, tmp_path):
        data = colors_like(n=400, seed=72)
        burst = _shifted(300, 73, data.shape[1])
        queries = _shifted(4, 74, data.shape[1])
        idx = pbuild(data, **durable_kw(tmp_path, drift_threshold=0.15))
        idx.add(burst)
        assert idx.drift_pending
        stat_before = idx.drift_stat()
        assert stat_before > 0.15
        before = idx.knn_batch(queries, k=5)
        g0 = idx.generation
        assert idx.tick() == "refit"             # drift outranks compaction
        st = idx.stats()
        assert st["refits"] == 1 and not st["drift_pending"]
        assert idx.generation > g0
        assert idx.drift_stat() < stat_before    # histogram rebased
        after = idx.knn_batch(queries, k=5)      # exactness is unconditional
        for a, b in zip(before, after):
            assert np.array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.distances, b.distances)
        idx.close()

    def test_refit_tightens_bounds_for_the_new_distribution(self, tmp_path):
        data = colors_like(n=300, seed=75)
        burst = _shifted(250, 76, data.shape[1])
        queries = _shifted(6, 77, data.shape[1])
        idx = pbuild(data, **durable_kw(tmp_path, drift_threshold=0.15))
        idx.add(burst)
        stale = idx._snapshot().frozen_copy().compact()
        w_stale = _mean_bound_width(stale._base, queries)
        idx.refit()
        w_refit = _mean_bound_width(idx._snapshot()._base, queries)
        assert w_refit < w_stale
        idx.close()

    def test_refit_survives_recovery(self, tmp_path):
        # refit checkpoints the new fit; recovery must come back with the
        # refitted pivots, not replay history into the stale ones
        data = colors_like(n=200, seed=78)
        idx = pbuild(data, **durable_kw(tmp_path, drift_threshold=0.15))
        idx.add(_shifted(150, 79, data.shape[1]))
        idx.refit()
        queries = _shifted(4, 80, data.shape[1])
        expected = idx.knn_batch(queries, k=5)
        idx.flush()
        idx.close()
        recovered = popen(tmp_path / "wal")
        assert recovered.stats()["refits"] == 1
        got = recovered.knn_batch(queries, k=5)
        for a, b in zip(expected, got):
            assert np.array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.distances, b.distances)
        recovered.close()


# ---------------------------------------------------------------------------
# factory surface + misc contracts
# ---------------------------------------------------------------------------
class TestFactorySurface:
    def test_durable_needs_wal_dir(self):
        data = colors_like(n=50, seed=90)
        with pytest.raises(ValueError, match="requires wal_dir"):
            pbuild(data, durable=True, **BUILD_KW)

    def test_wal_dir_without_durable_rejected(self, tmp_path):
        data = colors_like(n=50, seed=91)
        with pytest.raises(ValueError, match="only meaningful with durable"):
            pbuild(data, wal_dir=os.fspath(tmp_path / "w"), **BUILD_KW)

    def test_durable_does_not_compose_with_shards(self, tmp_path):
        data = colors_like(n=50, seed=92)
        with pytest.raises(ValueError, match="does not compose with shards"):
            pbuild(data, durable=True, shards=2, wal_dir=os.fspath(tmp_path / "w"), **BUILD_KW)

    def test_rejected_mutations_never_reach_the_wal(self, tmp_path):
        data = colors_like(n=60, seed=93)
        idx = pbuild(data, **durable_kw(tmp_path))
        n_before = idx.stats()["wal_records"]
        with pytest.raises(KeyError):
            idx.remove([9999])
        with pytest.raises(KeyError):
            idx.add(colors_like(n=1, seed=94), ids=[5])  # already live
        with pytest.raises(ValueError):
            idx.upsert([1, 1], colors_like(n=2, seed=95))  # dup ids
        with pytest.raises(ValueError, match="rows must be"):
            idx.add(np.ones((1, 3)))                       # wrong dimensionality
        with pytest.raises(ValueError, match="finite"):
            idx.upsert([5], np.full((1, data.shape[1]), np.nan))
        assert idx.stats()["wal_records"] == n_before
        idx.close()

    @pytest.mark.parametrize("kind", ["laesa", "tree"])
    def test_other_kinds_are_durable_too(self, tmp_path, kind):
        data = colors_like(n=120, seed=96)
        queries = colors_like(n=3, seed=97)
        kw = durable_kw(tmp_path)
        if kind == "tree":
            kw = {k: v for k, v in kw.items() if k not in ("n_pivots", "pivot_strategy")}
        idx = pbuild(data, kind=kind, **kw)
        idx.add(colors_like(n=10, seed=98))
        idx.remove([4])
        idx.flush()
        idx.close()
        recovered = popen(tmp_path / "wal")
        twin = pbuild(data, kind=kind, **durable_kw(tmp_path, "twin"))
        twin.add(colors_like(n=10, seed=98))
        twin.remove([4])
        assert_same_results(recovered, twin, queries)
        recovered.close()
        twin.close()

    def test_wal_inspect_tool(self, tmp_path, capsys):
        data = colors_like(n=80, seed=99)
        idx = pbuild(data, **durable_kw(tmp_path))
        idx.add(colors_like(n=5, seed=100))
        idx.remove([2])
        idx.flush()
        idx.close()
        rc = wal_inspect.main([os.fspath(tmp_path / "wal")])
        out = capsys.readouterr().out
        assert rc == 0
        assert "add" in out and "remove" in out and "OK" in out
        # a torn tail in the NEWEST segment is a legal crash artifact (exit
        # 0, reported); corruption in an OLDER segment loses acknowledged
        # records and must fail verification
        raw = _two_segment_log(tmp_path / "raw")
        rc = wal_inspect.main(["--verify", raw])
        assert rc == 0
        _corrupt_first_segment(raw)
        rc = wal_inspect.main(["--verify", raw])
        capsys.readouterr()
        assert rc != 0


def _two_segment_log(path) -> str:
    raw = WriteAheadLog(path)
    raw.append("add", [0], colors_like(n=1, seed=101))
    raw.roll()
    raw.append("remove", [0])
    raw.close()
    return os.fspath(path)


def _corrupt_first_segment(wal_dir) -> None:
    seg0 = os.path.join(wal_dir, "wal-00000000.log")
    blob = bytearray(open(seg0, "rb").read())
    blob[PREFIX_BYTES + 1] ^= 0xFF
    open(seg0, "wb").write(bytes(blob))


# ---------------------------------------------------------------------------
# replay completeness verification (GC gaps fail loudly, benign gaps don't)
# ---------------------------------------------------------------------------
class TestReplayVerification:
    def test_replay_missing_pinned_segment(self, tmp_path):
        rows = colors_like(n=4, seed=110)
        with WriteAheadLog(tmp_path / "w") as wal:
            wal.append("add", [0, 1], rows[:2])
            pos = wal.position()
            wal.roll()
            wal.append("add", [2, 3], rows[2:])
            wal.remove_segments_before(1)          # GC the pinned segment
            with pytest.raises(WalCorruption, match="garbage-collected"):
                list(wal.replay(pos))              # unverifiable without seqs
            recs = list(wal.replay(pos, expect_seq=1))   # seqs prove no gap
            assert [r.seq for r in recs] == [1]
            with pytest.raises(WalCorruption, match="sequence gap"):
                list(wal.replay(pos, expect_seq=0))      # record 0 is gone

    def test_load_after_checkpoint_gc_of_pinned_tail_fails_loudly(self, tmp_path):
        data = colors_like(n=120, seed=111)
        idx = pbuild(data, **durable_kw(tmp_path))
        idx.add(colors_like(n=4, seed=112))
        snap = os.fspath(tmp_path / "snap")
        idx.save(snap)
        idx.add(colors_like(n=4, seed=113))      # lands in the pinned segment
        idx.checkpoint()                          # roll + GC that segment
        with pytest.raises(WalCorruption):
            load_index(snap, device="cpu")
        idx.close()

    def test_save_then_checkpoint_without_writes_still_loads(self, tmp_path):
        data = colors_like(n=120, seed=114)
        queries = colors_like(n=3, seed=115)
        idx = pbuild(data, **durable_kw(tmp_path))
        idx.add(colors_like(n=4, seed=116))
        snap = os.fspath(tmp_path / "snap")
        idx.save(snap)
        idx.checkpoint()
        loaded = load_index(snap, device="cpu")
        assert_same_results(loaded, idx, queries)
        loaded.close()
        idx.close()

    def test_seq_floor_survives_checkpoint_gc_and_reopen(self, tmp_path):
        data = colors_like(n=100, seed=117)
        queries = colors_like(n=3, seed=118)
        idx = pbuild(data, **durable_kw(tmp_path))
        idx.add(colors_like(n=4, seed=119), ids=np.arange(500, 504))
        idx.checkpoint()
        before = idx._wal.next_seq
        idx.close()
        r1 = popen(tmp_path / "wal")
        assert r1._wal.next_seq == before
        r1.add(colors_like(n=2, seed=120), ids=[600, 601])
        r1.flush()
        r1.close()
        r2 = popen(tmp_path / "wal")
        twin = pbuild(data, **durable_kw(tmp_path, "twin"))
        twin.add(colors_like(n=4, seed=119), ids=np.arange(500, 504))
        twin.add(colors_like(n=2, seed=120), ids=[600, 601])
        assert_same_results(r2, twin, queries)
        r2.close()
        twin.close()

    def test_duplicate_ids_in_remove_batch_rejected_atomically(self, tmp_path):
        data = colors_like(n=60, seed=121)
        idx = pbuild(data, **durable_kw(tmp_path))
        n_before = idx.stats()["wal_records"]
        with pytest.raises(ValueError, match="duplicate ids"):
            idx.remove([5, 5])
        assert idx.has_id(5)
        assert idx.stats()["wal_records"] == n_before
        idx.flush()
        idx.close()
        recovered = popen(tmp_path / "wal")
        assert recovered.has_id(5)
        recovered.remove([5])                    # a valid remove still works
        assert not recovered.has_id(5)
        recovered.close()


# ---------------------------------------------------------------------------
# reader/writer isolation: queries run off-lock against immutable views
# ---------------------------------------------------------------------------
class TestConcurrentReads:
    def test_queries_never_tear_under_concurrent_writes(self, tmp_path):
        data = colors_like(n=200, seed=130)
        pool = colors_like(n=360, seed=131)
        queries = colors_like(n=4, seed=132)
        idx = pbuild(data, **durable_kw(tmp_path, compact_threshold=0.25))
        failures = []
        done = threading.Event()

        def writer():
            try:
                next_id = 10_000
                for i in range(120):
                    j = 3 * (i % 120)
                    idx.add(pool[j:j + 3], ids=np.arange(next_id, next_id + 3))
                    next_id += 3
                    if i % 5 == 0:
                        idx.remove([next_id - 1])
                    if i % 7 == 0:
                        idx.upsert([int(idx.ids()[0])], pool[j:j + 1])
            except Exception as e:  # noqa: BLE001 — surfaced after join
                failures.append(e)
            finally:
                done.set()

        # generation swaps race the queries too: the background compactor
        # folds whenever the write burst crosses the threshold
        with BackgroundCompactor(idx, interval_s=0.005) as bg:
            t = threading.Thread(target=writer)
            t.start()
            while not done.is_set():
                for r in idx.knn_batch(queries, k=5):
                    assert len(r.ids) == 5
                    assert np.all(np.diff(r.distances) >= 0)
            t.join(timeout=60)
            assert not t.is_alive()
        assert not failures, failures
        assert bg.last_error is None
        assert idx.stats()["compactions"] >= 1   # swaps actually happened
        # quiesced: answers are bit-identical to a fresh rebuild of the
        # live rows (the exactness contract survived the race)
        fresh = pbuild(idx.data.numpy(), **BUILD_KW)
        for a, b in zip(idx.knn_batch(queries, k=5), fresh.knn_batch(queries, k=5)):
            np.testing.assert_array_equal(a.distances, b.distances)
        idx.close()


# ---------------------------------------------------------------------------
# the port's own concurrency contracts
# ---------------------------------------------------------------------------
SCHEMA = {"bucket": "int", "tag": "categorical"}


def _attrs(ids):
    ids = np.asarray(ids, dtype=np.int64)
    return {"bucket": ids % 7, "tag": np.array(["a", "b", "c"])[ids % 3]}


def test_filtered_reads_never_tear_under_writes_refits_and_compactions(tmp_path):
    """Filtered and allowlist readers against a writer with attributes while
    the compactor refits (drift) and folds: every answer comes from one view
    (ids live at some point, matching the predicate, each distance the
    metric's to that id's row, sorted), the segments' lazy fills race
    harmlessly, and the quiesced index equals a fresh build over its live
    rows.  No id is upserted, so each id names one row for the whole run."""
    data = colors_like(n=240, seed=140)
    stream = _shifted(600, 141, data.shape[1])
    queries = colors_like(n=3, seed=142)
    store = AttributeStore(SCHEMA)
    store.put(np.arange(len(data)), _attrs(np.arange(len(data))))
    idx = pbuild(data, attributes=store, **durable_kw(tmp_path, compact_threshold=0.3, drift_threshold=0.15))
    ever = set(range(len(data)))
    row_of = {i: data[i].astype(np.float64) for i in range(len(data))}
    failures, done = [], threading.Event()
    pred = Predicate.eq("bucket", 2)

    def writer():
        try:
            for i in range(20):
                ids = np.arange(1000 + 30 * i, 1030 + 30 * i)
                row_of.update(zip(ids.tolist(), stream[30 * i:30 * i + 30].astype(np.float64)))
                ever.update(ids.tolist())
                idx.add(stream[30 * i:30 * i + 30], ids=ids, attrs=_attrs(ids))
                idx.remove(ids[:5])
        except Exception as e:  # noqa: BLE001 — surfaced after join
            failures.append(e)
        finally:
            done.set()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)              # interleave the threads finely
    try:
        with BackgroundCompactor(idx, interval_s=0.005) as bg:
            t = threading.Thread(target=writer)
            t.start()
            _read_until(done, idx, queries, pred, ever, row_of)
            t.join(timeout=60)
            assert not t.is_alive()
            assert _wait_until(lambda: not idx.drift_pending and not idx.pending_compaction)
    finally:
        sys.setswitchinterval(switch)
    assert not failures, failures
    assert bg.last_error is None and bg.counters["errors"] == 0
    assert bg.counters["refits"] >= 1
    # no lost update: every acknowledged record is in the log and applied
    assert idx.stats()["wal_records"] == 40 and idx.stats()["n_objects"] == len(data) + 20 * 25
    fresh = pbuild(idx.data.numpy(), **BUILD_KW)
    live = idx.ids()
    for a, b in zip(idx.knn_batch(queries, k=5), fresh.knn_batch(queries, k=5)):
        np.testing.assert_array_equal(a.distances, b.distances)
        np.testing.assert_array_equal(a.ids, live[b.ids])
    np.testing.assert_array_equal(idx.attributes.match(pred), live[live % 7 == 2])


def _read_until(done, idx, queries, pred, ever, row_of):
    """Loop filtered, unfiltered-planner and allowlist k-NN batches until
    ``done``; every answer must come from one point in time."""
    while not done.is_set():
        for spec in (Query.knn(4, where=pred, filter_mode="pushdown"), Query.knn(4, where=pred),
                     Query.knn(4, allow=tuple(range(0, 2000, 3)))):
            for q, r in zip(queries, idx.query(queries, spec)):
                assert len(r.ids) == 4
                assert np.all(np.diff(r.distances) >= 0)
                assert set(r.ids.tolist()) <= ever
                true = [np.linalg.norm(row_of[int(i)] - q) for i in r.ids]
                np.testing.assert_allclose(r.distances, true, rtol=1e-5)
                if spec.where is not None:
                    assert np.all(r.ids % 7 == 2)


def test_a_write_between_the_executors_reads_cannot_tear_an_answer(tmp_path, monkeypatch):
    """A query runs on the one view it captured: a remove that lands while
    it runs (here, whenever the durable index's live rows are read) cannot
    pair rows with the wrong ids in an allowlist scan.  Reading ``data`` and
    ``ids()`` as two snapshots, as the JAX package's executor does for a
    durable index, would shift every id past the removed one by a row."""
    data = colors_like(n=300, seed=145)
    queries = colors_like(n=3, seed=146)
    idx = pbuild(data, **durable_kw(tmp_path))
    spec = Query.knn(4, allow=tuple(range(0, 300, 3)))
    want = idx.query(queries, spec)
    victims = iter(range(1, 300, 3))                 # never in the allowlist
    data_of = DurableIndex.data

    def data_then_remove(self):
        out = data_of.fget(self)
        self.remove([next(victims)])
        return out

    monkeypatch.setattr(DurableIndex, "data", property(data_then_remove))
    got = idx.query(queries, spec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.distances, w.distances)
    idx.close()


def test_compactor_thread_enters_the_index_device(monkeypatch):
    """Each tick runs with the index's device current on the maintenance
    thread (a thread that did not enter it would launch on device 0, which
    one card hides): recorded through ``on_device`` for an index on a
    device other than 0."""
    entered = threading.local()
    seen = []

    class _Ctx:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.dev = self.dev

        def __exit__(self, *exc):
            entered.dev = None

    class _Index:
        device = torch.device("cuda", 3)

        def tick(self):
            seen.append((threading.current_thread().name, getattr(entered, "dev", None)))
            return "compact"

    monkeypatch.setattr(compactor_mod, "on_device", _Ctx)
    with BackgroundCompactor(_Index(), interval_s=0.005) as bg:
        bg.kick()
        assert _wait_until(lambda: bg.counters["compactions"] >= 1)
    assert seen and all(name == "repro-compactor" and dev == torch.device("cuda", 3) for name, dev in seen)


def test_compactor_counts_errors_and_keeps_the_last_one(tmp_path):
    class _Broken:
        device = torch.device("cpu")

        def tick(self):
            raise RuntimeError("fold failed")

    bg = BackgroundCompactor(_Broken())
    assert bg.run_pending() == 0 and bg.run_pending() == 0
    assert bg.counters["errors"] == 2 and str(bg.last_error) == "fold failed"


def test_replay_keeps_the_logged_dtype(tmp_path):
    """An f32 corpus replays as f32 bits through the same upsert path as the
    live writes (the recovered rows are the logged bytes)."""
    data = colors_like(n=80, seed=150)
    rows = colors_like(n=6, seed=151)
    idx = pbuild(data, **durable_kw(tmp_path))
    ids = idx.add(rows)
    idx.flush()
    rec = popen(tmp_path / "wal")
    got = rec.data[torch.as_tensor(np.searchsorted(rec.ids(), ids))]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), rows)
    rec.close()
    idx.close()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------
def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


def same(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    if want.distances is not None:
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-12, atol=1e-12)
    assert _stats(got.stats) == _stats(want.stats)


def rquery(spec: Query) -> RQuery:
    kw = {f: getattr(spec, f) for f in ("task", "k", "threshold", "mode", "dims", "refine", "allow", "deny",
                                         "budget", "filter_mode")}
    kw["where"] = None if spec.where is None else RPredicate.from_dict(spec.where.to_dict())
    return RQuery(**kw)


PARITY_N, PARITY_DIM = 260, 112
PARITY_KW = dict(n_pivots=6, seed=5, fsync_every=3, checkpoint_every=None, compact_threshold=None)


def _parity_specs(rows, q0, metric):
    """k-NN, range (between query 0's 20th and 21st neighbour distances) and
    filtered k-NN specs."""
    from repro_torch.metrics import get_metric

    d = np.sort(get_metric(metric).one_to_many(torch.as_tensor(q0), torch.as_tensor(rows)).numpy())
    return [
        Query.knn(7),
        Query.range(float(0.5 * (d[20] + d[21]))),
        Query.knn(5, where=Predicate.eq("bucket", 3), filter_mode="pushdown"),
        Query.knn(5, where=Predicate.isin("tag", ["a", "c"])),
    ]


def _mutate(idx, pool):
    """A checkpoint-then-tail history with attributes: adds, a remove and an
    upsert, each a WAL record; the checkpoint falls in the middle."""
    a = np.arange(PARITY_N, PARITY_N + 12)
    idx.add(pool[:12], ids=a, attrs=_attrs(a))
    idx.remove([3, 40, PARITY_N + 2])
    idx.checkpoint()
    b = np.arange(PARITY_N + 12, PARITY_N + 20)
    idx.add(pool[12:20], ids=b, attrs=_attrs(b))
    idx.upsert([7, PARITY_N + 5], pool[20:22], attrs=_attrs([7, PARITY_N + 5]))
    idx.remove([11])
    idx.flush()


def _durable_pair_data(metric):
    data = colors_like(n=PARITY_N, dim=PARITY_DIM, seed=160, dtype=np.float64)
    pool = colors_like(n=24, dim=PARITY_DIM, seed=161, dtype=np.float64)
    queries = colors_like(n=4, dim=PARITY_DIM, seed=162, dtype=np.float64)
    return data, pool, queries


def _write_port(tmp_path, metric, name="port"):
    data, pool, _ = _durable_pair_data(metric)
    store = AttributeStore(SCHEMA)
    store.put(np.arange(PARITY_N), _attrs(np.arange(PARITY_N)))
    idx = pbuild(data, metric, durable=True, wal_dir=os.fspath(tmp_path / name), attributes=store, **PARITY_KW)
    _mutate(idx, pool)
    return idx


def _write_ref(tmp_path, metric, name="ref"):
    data, pool, _ = _durable_pair_data(metric)
    store = RStore(SCHEMA)
    store.put(np.arange(PARITY_N), _attrs(np.arange(PARITY_N)))
    with enable_x64(True):
        idx = rbuild(data, metric, durable=True, wal_dir=os.fspath(tmp_path / name), attributes=store,
                     use_kernel=True, **PARITY_KW)
        _mutate(idx, pool)
    return idx


def _assert_answers_equal(port, ref, metric):
    _, _, queries = _durable_pair_data(metric)
    for spec in _parity_specs(port.data.numpy(), queries[0], metric):
        got = port.query(queries, spec)
        with enable_x64(True):
            want = ref.query(queries, rquery(spec))
        for g, w in zip(got, want):
            same(g, w)


@pytest.mark.parametrize("metric", ["euclidean", "jensen_shannon"])
@pytest.mark.parametrize("entry", ["open_durable", "load_index"])
def test_reference_directory_opens_in_the_port(tmp_path, metric, entry):
    ref = _write_ref(tmp_path, metric)
    if entry == "load_index":
        with enable_x64(True):
            ref.save(os.fspath(tmp_path / "snap"))
        port = load_index(tmp_path / "snap", device="cpu")
    else:
        port = popen(ref.wal_dir)
    assert port.kind == "durable" and port.stats()["wal_records"] == ref.stats()["wal_records"]
    np.testing.assert_array_equal(port.ids(), ref.ids())
    np.testing.assert_array_equal(port.attributes.ids(), ref.attributes.ids())
    _assert_answers_equal(port, ref, metric)
    port.close()
    ref.close()


@pytest.mark.parametrize("metric", ["euclidean", "jensen_shannon"])
@pytest.mark.parametrize("entry", ["open_durable", "load_index"])
def test_port_directory_opens_in_the_reference(tmp_path, metric, entry):
    port = _write_port(tmp_path, metric)
    with enable_x64(True):
        if entry == "load_index":
            port.save(os.fspath(tmp_path / "snap"))
            ref = rload(tmp_path / "snap")
        else:
            ref = ropen_durable(port.wal_dir)
    assert ref.kind == "durable" and ref.stats()["wal_records"] == port.stats()["wal_records"]
    np.testing.assert_array_equal(ref.ids(), port.ids())
    np.testing.assert_array_equal(ref.attributes.ids(), port.attributes.ids())
    _assert_answers_equal(port, ref, metric)
    port.close()
    ref.close()


@pytest.mark.parametrize("op", ["add", "remove", "upsert"])
@pytest.mark.parametrize("with_attrs", [False, True])
def test_encode_record_bytes_equal_reference(op, with_attrs):
    ids = [4, 9, 1]
    rows = None if op == "remove" else colors_like(n=3, seed=170)
    attrs = None
    if with_attrs:
        attrs = {"bucket": np.array([1, 2, 3]), "tag": np.array(["x", "y", "x"]),
                 "price": np.array([0.5, 1.25, 3.0]), "ok": np.array([True, False, True])}
    got = encode_record(17, op, ids, rows, attrs=attrs)
    assert got == rencode_record(17, op, ids, rows, attrs=attrs)


def test_torn_tail_replays_the_same_in_both_packages(tmp_path):
    port = _write_port(tmp_path, "euclidean")
    port.close()
    src = port.wal_dir
    seg = _newest_segment(src)
    records, _, _ = scan_segment(os.path.join(src, f"wal-{seg:08d}.log"))
    start, end = records[-2][4], records[-1][4]           # the last record
    copies = []
    for name in ("a", "b"):
        dst = os.fspath(tmp_path / name)
        shutil.copytree(src, dst)
        with open(os.path.join(dst, f"wal-{seg:08d}.log"), "r+b") as f:
            f.truncate(start + (end - start) // 2)
        copies.append(dst)
    got = popen(copies[0])
    with enable_x64(True):
        want = ropen_durable(copies[1])
    assert got._wal.next_seq == want._wal.next_seq == port._wal.next_seq - 1
    assert got._wal.position() == LogPosition(want._wal.position().segment, want._wal.position().offset)
    assert got._wal.position().offset == start
    np.testing.assert_array_equal(got.ids(), want.ids())
    assert got.has_id(11) and want.has_id(11)                # the torn remove never happened
    got.close()
    want.close()


@pytest.mark.parametrize("metric", ["euclidean", "jensen_shannon"])
@pytest.mark.parametrize("stream", ["same", "shifted"])
def test_drift_statistic_equals_reference(tmp_path, metric, stream):
    data = colors_like(n=300, seed=180, dtype=np.float64)
    if stream == "same":
        rows = colors_like(n=300 + 160, seed=180, dtype=np.float64)[300:]
    else:
        rows = _shifted(160, 181, data.shape[1], dtype=np.float64)
    threshold = 0.15
    kw = dict(n_pivots=6, seed=4, drift_threshold=threshold, checkpoint_every=None, compact_threshold=None)
    port = pbuild(data, metric, durable=True, wal_dir=os.fspath(tmp_path / "p"), **kw)
    with enable_x64(True):
        ref = rbuild(data, metric, durable=True, wal_dir=os.fspath(tmp_path / "r"), use_kernel=True, **kw)
    for block in np.array_split(rows, 5):
        port.add(block)
        with enable_x64(True):
            ref.add(block)
        want = ref.drift_stat()
        assert want == 0.0 or abs(want - threshold) >= 0.02   # a decision the rounding cannot flip
        assert abs(port.drift_stat() - want) <= 1e-9
        assert port.drift_pending == ref.drift_pending
    assert port.drift_pending == (stream == "shifted")
    port.close()
    ref.close()


@pytest.mark.parametrize("metric", ["euclidean", "jensen_shannon"])
def test_refit_selects_the_reference_pivots_and_answers_alike(tmp_path, metric):
    data = colors_like(n=300, seed=190, dtype=np.float64)
    burst = _shifted(200, 191, data.shape[1], dtype=np.float64)
    queries = _shifted(4, 192, data.shape[1], dtype=np.float64)
    kw = dict(n_pivots=6, seed=8, drift_threshold=0.15, checkpoint_every=None, compact_threshold=None)
    port = pbuild(data, metric, durable=True, wal_dir=os.fspath(tmp_path / "p"), **kw)
    with enable_x64(True):
        ref = rbuild(data, metric, durable=True, wal_dir=os.fspath(tmp_path / "r"), use_kernel=True, **kw)
    port.add(burst)
    port.remove([2, 9])
    port.refit()
    with enable_x64(True):
        ref.add(burst)
        ref.remove([2, 9])
        ref.refit()
    assert port.refits == ref.refits == 1
    np.testing.assert_array_equal(segment_pivots(port._inner._base), rsegment_pivots(ref._inner._base))
    assert port.generation == ref.generation
    got = port.query(queries, Query.knn(6))
    with enable_x64(True):
        want = ref.query(queries, RQuery.knn(6))
    for g, w in zip(got, want):
        same(g, w)
    assert abs(port.drift_stat() - ref.drift_stat()) <= 1e-9
    port.close()
    ref.close()


@pytest.mark.parametrize("spec", [
    Query.knn(5), Query.range(0.1), Query.knn(5, mode="approx", dims=3, refine=16),
    Query.knn(5, where=Predicate.eq("bucket", 3)), Query.range(0.1, where=Predicate.isin("tag", ["a"])),
    Query.knn(5, where=Predicate.eq("bucket", 3), filter_mode="postfilter"), Query.knn(5, allow=(1, 2, 3)),
], ids=["knn", "range", "approx", "where-knn", "where-range", "postfilter", "allow"])
def test_explain_on_a_durable_index_equals_reference(tmp_path, spec):
    port = _write_port(tmp_path, "euclidean")
    ref = _write_ref(tmp_path, "euclidean")
    with enable_x64(True):
        want = ref.plan(rquery(spec)).explain()
    assert port.plan(spec).explain() == want
    assert want["index_kind"] == "durable"
    port.close()
    ref.close()


def _inspect_lines(tool, wal_dir, verify=False):
    buf = io.StringIO()
    rc = tool.inspect(wal_dir, verify_only=verify, out=buf)
    return rc, buf.getvalue()


def _reference_wal_inspect():
    """The reference's ``tools/wal_inspect.py`` loaded under a name of its
    own: its ``inspect(..., out=sys.stdout)`` binds the stream current at
    import, so importing the shared ``tools.wal_inspect`` here would leave
    ``tests/test_store.py``'s run of it in the same process printing into
    this test's capture."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / "wal_inspect.py"
    spec = importlib.util.spec_from_file_location("_reference_wal_inspect", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_wal_inspect_lines_equal_the_reference_tool_both_ways(tmp_path):
    rtool = _reference_wal_inspect()

    port = _write_port(tmp_path, "euclidean")
    ref = _write_ref(tmp_path, "euclidean")
    port.close()
    ref.close()
    for wal_dir in (port.wal_dir, ref.wal_dir):
        for verify in (False, True):
            got, want = _inspect_lines(wal_inspect, wal_dir, verify), _inspect_lines(rtool, wal_dir, verify)
            assert got == want and got[0] == 0
    # the reference tool on a port-written log, the port tool on a
    # reference-written one: both verify, and both fail a corrupt older segment
    raw_port = _two_segment_log(tmp_path / "raw_port")
    with enable_x64(True):
        from repro.store import WriteAheadLog as RWal

        raw = RWal(tmp_path / "raw_ref")
        raw.append("add", [0], colors_like(n=1, seed=101))
        raw.roll()
        raw.append("remove", [0])
        raw.close()
    raw_ref = os.fspath(tmp_path / "raw_ref")
    assert _inspect_lines(rtool, raw_port, True)[0] == 0
    assert _inspect_lines(wal_inspect, raw_ref, True)[0] == 0
    assert _inspect_lines(wal_inspect, raw_port) == _inspect_lines(rtool, raw_ref)
    for d in (raw_port, raw_ref):
        _corrupt_first_segment(d)
        assert _inspect_lines(wal_inspect, d, True)[0] != 0
        assert _inspect_lines(rtool, d, True)[0] != 0
    # the module entry point prints the same lines and exits as inspect does
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for d, rc in ((port.wal_dir, 0), (raw_port, 1)):
        out = subprocess.run([sys.executable, "-m", "repro_torch.store.wal_inspect", "--verify", d],
                             env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == rc and out.stdout == _inspect_lines(rtool, d, True)[1], out.stderr


def test_durable_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    data = colors_like(n=60, seed=200)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(data, durable=True, wal_dir=os.fspath(tmp_path / "w"), n_pivots=4)
    idx = pbuild(data, **durable_kw(tmp_path, "ok"))
    idx.close()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_durable(tmp_path / "ok")
    assert isinstance(popen(tmp_path / "ok"), DurableIndex)
