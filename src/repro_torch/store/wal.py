"""Append-only, checksummed, fsync-batched write-ahead log for index mutations.

A copy of the JAX package's ``repro.store.wal`` (stdlib and numpy only, so
it runs on the host beside the card): the same record layout byte for byte,
so a log written by either package replays in the other.

One ``WriteAheadLog`` is a directory of segment files ``wal-<8 digits>.log``.
Each segment is a flat sequence of records; a record is::

    magic   u32   0x57414C31 ("WAL1", little-endian on disk)
    seq     u64   monotonically increasing across segments (torn-tail guard)
    op      u8    1=add 2=remove 3=upsert
    hdr_len u32   length of the JSON header
    pay_len u32   length of the raw row payload (0 for remove)
    crc     u32   crc32 over header + payload
    header  bytes JSON: {"ids": [...], "dtype": "<f8", "shape": [r, d],
                  "attrs": {col: [per-row values]}}  (attrs optional)
    payload bytes C-order row bytes

Attribute columns ride in the JSON header (they are tiny next to the row
payload), so crash recovery replays them into the ``AttributeStore``
alongside the rows — a record without ``attrs`` replays exactly as before.

Durability contract:

  * ``append`` writes through the OS page cache immediately (readers —
    including the background compactor's catch-up replay — always see every
    appended record) and issues ``fsync`` once per ``fsync_every`` records;
    ``flush()`` forces the sync point.  A crash can therefore lose at most
    the unsynced tail — never a *synced* record, and never the middle of
    the file.
  * ``replay`` is tolerant of torn tails: it stops at the first record
    whose magic / length / sequence / checksum fails and reports the last
    valid position.  Reopening for append truncates the torn tail so new
    records never interleave with garbage.
  * Positions (``LogPosition``: segment + byte offset) are stable names for
    points in the log; snapshot manifests pin one and recovery replays the
    tail from it.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

MAGIC = 0x57414C31
_PREFIX = struct.Struct("<IQBIII")  # magic, seq, op, hdr_len, pay_len, crc
PREFIX_BYTES = _PREFIX.size

OPS = {"add": 1, "remove": 2, "upsert": 3}
OP_NAMES = {v: k for k, v in OPS.items()}

SEGMENT_FMT = "wal-%08d.log"
DEFAULT_FSYNC_EVERY = 8


class WalCorruption(RuntimeError):
    """A record failed validation somewhere other than the final tail."""


@dataclass(frozen=True, order=True)
class LogPosition:
    """A stable point in the log: (segment number, byte offset within it)."""

    segment: int
    offset: int

    def to_dict(self) -> dict:
        return {"segment": int(self.segment), "offset": int(self.offset)}

    @classmethod
    def from_dict(cls, d: dict) -> "LogPosition":
        return cls(segment=int(d["segment"]), offset=int(d["offset"]))


@dataclass(frozen=True)
class WalRecord:
    """One decoded mutation record plus where its successor starts."""

    seq: int
    op: str                       # "add" | "remove" | "upsert"
    ids: np.ndarray               # (r,) int64 logical ids
    rows: Optional[np.ndarray]    # (r, d) rows, or None for remove
    pos: LogPosition              # position AFTER this record (replay cursor)
    attrs: Optional[dict] = None  # {column: [per-row values]}, or None


def _attrs_payload(attrs) -> dict:
    """Normalise an attribute mapping into the JSON header form."""
    out = {}
    for name, values in attrs.items():
        vals = np.asarray(values).reshape(-1).tolist()
        out[str(name)] = vals
    return out


def encode_record(seq: int, op: str, ids, rows=None, attrs=None) -> bytes:
    """Serialise one record (pure function; the inspect tool reuses it)."""
    ids = np.asarray(ids, dtype=np.int64).ravel()
    header = {"ids": [int(i) for i in ids]}
    payload = b""
    if rows is not None:
        rows = np.ascontiguousarray(rows)
        header["dtype"] = rows.dtype.str
        header["shape"] = list(rows.shape)
        payload = rows.tobytes()
    if attrs is not None:
        header["attrs"] = _attrs_payload(attrs)
    hdr = json.dumps(header, sort_keys=True).encode()
    crc = zlib.crc32(hdr + payload) & 0xFFFFFFFF
    return _PREFIX.pack(MAGIC, seq, OPS[op], len(hdr), len(payload), crc) + hdr + payload


def _decode_one(buf: bytes, offset: int, expect_seq: Optional[int]):
    """(seq, op, ids, rows, end_offset, attrs) or None when the bytes at
    ``offset`` are not one whole valid record (torn tail / corruption)."""
    if offset + PREFIX_BYTES > len(buf):
        return None
    magic, seq, op, hdr_len, pay_len, crc = _PREFIX.unpack_from(buf, offset)
    if magic != MAGIC or op not in OP_NAMES:
        return None
    if expect_seq is not None and seq != expect_seq:
        return None
    start = offset + PREFIX_BYTES
    end = start + hdr_len + pay_len
    if end > len(buf):
        return None
    hdr_bytes = buf[start:start + hdr_len]
    payload = buf[start + hdr_len:end]
    if (zlib.crc32(hdr_bytes + payload) & 0xFFFFFFFF) != crc:
        return None
    try:
        header = json.loads(hdr_bytes)
        ids = np.asarray(header["ids"], dtype=np.int64)
        rows = None
        if pay_len:
            # frombuffer rows are read-only views of the file bytes: the
            # one copy here is what replay hands to torch, in the logged dtype
            rows = np.frombuffer(
                payload, dtype=np.dtype(header["dtype"])
            ).reshape(header["shape"]).copy()
        attrs = header.get("attrs")
        if attrs is not None and not isinstance(attrs, dict):
            return None
    except (ValueError, KeyError, TypeError):
        return None
    return seq, OP_NAMES[op], ids, rows, end, attrs


def scan_segment(path: str, *, start_offset: int = 0,
                 expect_seq: Optional[int] = None):
    """Decode records from one segment file starting at ``start_offset``.

    Returns ``(records, valid_end, file_size)`` where ``records`` is a list
    of ``(seq, op, ids, rows, end_offset, attrs)`` tuples (``end_offset``
    stays at index 4 — existing consumers index it) and ``valid_end`` is the
    byte offset of the first invalid/torn record (== ``file_size`` for a
    clean segment)."""
    with open(path, "rb") as f:
        buf = f.read()
    out = []
    offset = int(start_offset)
    seq = expect_seq
    while offset < len(buf):
        rec = _decode_one(buf, offset, seq)
        if rec is None:
            break
        out.append(rec)
        offset = rec[4]
        seq = rec[0] + 1
    return out, offset, len(buf)


class WriteAheadLog:
    """The append/replay surface over one WAL directory (thread-safe)."""

    def __init__(self, directory, *, fsync_every: int = DEFAULT_FSYNC_EVERY,
                 seq_floor: int = 0):
        """``seq_floor`` is a lower bound for the next sequence number.
        Recovery passes the snapshot manifest's ``next_seq``: after a
        checkpoint rolls the log and GCs every older segment, the head
        segment can be empty, and without the floor a reopened log would
        restart numbering at 0 — colliding with sequence numbers the
        snapshot already covers and breaking strict replay verification."""
        if fsync_every < 1:
            raise ValueError(f"fsync_every must be >= 1; got {fsync_every}")
        self.dir = os.fspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.fsync_every = int(fsync_every)
        self._lock = threading.Lock()
        self._unsynced = 0
        self.appended = 0            # records appended by THIS handle
        self.synced_through = 0      # records covered by the last fsync
        segments = self.segments()
        self._segment = segments[-1] if segments else 0
        self._next_seq, end = self._recover_tail(self._segment)
        self._next_seq = max(self._next_seq, int(seq_floor))
        self._fh = open(self._segment_path(self._segment), "ab")
        if self._fh.tell() > end:
            # torn tail from a previous crash: drop it before appending
            self._fh.truncate(end)
            self._fh.seek(end)

    # -- layout ----------------------------------------------------------------
    def _segment_path(self, segment: int) -> str:
        return os.path.join(self.dir, SEGMENT_FMT % segment)

    def segments(self) -> List[int]:
        """Sorted segment numbers present on disk."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("wal-") and name.endswith(".log"):
                try:
                    out.append(int(name[4:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def _recover_tail(self, segment: int) -> Tuple[int, int]:
        """(next sequence number, valid byte end) for the newest segment."""
        path = self._segment_path(segment)
        if not os.path.exists(path):
            return 0, 0
        records, valid_end, _size = scan_segment(path)
        if records:
            return records[-1][0] + 1, valid_end
        # empty/unreadable head segment: derive the seq floor from older ones
        next_seq = 0
        for older in reversed(self.segments()):
            if older >= segment:
                continue
            recs, _, _ = scan_segment(self._segment_path(older))
            if recs:
                next_seq = recs[-1][0] + 1
                break
        return next_seq, valid_end

    # -- append side -----------------------------------------------------------
    def position(self) -> LogPosition:
        """The position one past the last appended record."""
        with self._lock:
            return LogPosition(self._segment, self._fh.tell())

    @property
    def next_seq(self) -> int:
        with self._lock:
            return self._next_seq

    def append(self, op: str, ids, rows=None, attrs=None) -> LogPosition:
        """Append one record; returns the position AFTER it.  The record is
        immediately visible to readers; it is durable after the next batched
        fsync (``fsync_every`` records) or an explicit ``flush()``."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; one of {sorted(OPS)}")
        with self._lock:
            blob = encode_record(self._next_seq, op, ids, rows, attrs=attrs)
            self._fh.write(blob)
            self._fh.flush()         # visible to readers now; durable at fsync
            self._next_seq += 1
            self.appended += 1
            self._unsynced += 1
            if self._unsynced >= self.fsync_every:
                self._fsync_locked()
            return LogPosition(self._segment, self._fh.tell())

    def _fsync_locked(self) -> None:
        os.fsync(self._fh.fileno())
        self.synced_through = self._next_seq
        self._unsynced = 0

    def flush(self) -> None:
        """Force-sync every appended record to stable storage."""
        with self._lock:
            self._fh.flush()
            self._fsync_locked()

    def roll(self) -> int:
        """Flush and start a new segment (checkpoints roll so older segments
        become garbage-collectable once nothing pins them)."""
        with self._lock:
            self._fh.flush()
            self._fsync_locked()
            self._fh.close()
            self._segment += 1
            self._fh = open(self._segment_path(self._segment), "ab")
            return self._segment

    def remove_segments_before(self, segment: int) -> List[int]:
        """Delete whole segments strictly older than ``segment`` (the GC the
        checkpointer runs once a snapshot no longer pins them)."""
        removed = []
        with self._lock:
            for s in self.segments():
                if s < segment and s != self._segment:
                    os.remove(self._segment_path(s))
                    removed.append(s)
        return removed

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fsync_locked()
                self._fh.close()

    # -- replay side -----------------------------------------------------------
    def replay(self, from_pos: Optional[LogPosition] = None, *,
               expect_seq: Optional[int] = None) -> Iterator[WalRecord]:
        """Yield every valid record at/after ``from_pos`` (default: the whole
        log).  Stops silently at a torn tail in the NEWEST segment; a torn or
        corrupt record in an older segment raises ``WalCorruption`` (records
        after it exist, so silently dropping them would lose acknowledged
        writes).

        ``expect_seq`` pins the sequence number the FIRST replayed record
        must carry (snapshot manifests record it as ``next_seq``) and turns
        on completeness verification: any gap — a garbage-collected segment
        the position points into, a sequence jump between records, or a log
        whose tail does not line up with the last replayed record — raises
        ``WalCorruption`` instead of silently recovering a state that is
        neither the snapshot's nor the live one.  A missing pinned segment
        is tolerated only when the surviving records (or the empty log's
        sequence floor) prove that nothing in the gap was lost."""
        segments = self.segments()
        if from_pos is not None:
            if from_pos.segment not in segments and expect_seq is None:
                raise WalCorruption(
                    f"replay position pins segment {from_pos.segment} but only "
                    f"segments {segments} survive; the records between the "
                    "pinned position and the surviving log were "
                    "garbage-collected and replay cannot verify the gap"
                )
            segments = [s for s in segments if s >= from_pos.segment]
        expect = expect_seq
        for i, seg in enumerate(segments):
            start = (
                from_pos.offset
                if from_pos is not None and seg == from_pos.segment
                else 0
            )
            path = self._segment_path(seg)
            records, valid_end, size = scan_segment(path, start_offset=start)
            if valid_end < size and i < len(segments) - 1:
                raise WalCorruption(
                    f"segment {seg} is corrupt at byte {valid_end} but later "
                    f"segments exist; refusing to silently drop records"
                )
            for seq, op, ids, rows, end, attrs in records:
                if expect is not None and seq != expect:
                    raise WalCorruption(
                        f"sequence gap in segment {seg}: expected record "
                        f"{expect}, found {seq} — the records in between were "
                        "lost (garbage-collected or corrupt); refusing to "
                        "replay a partial tail"
                    )
                expect = seq + 1
                yield WalRecord(
                    seq=seq, op=op, ids=ids, rows=rows,
                    pos=LogPosition(seg, end), attrs=attrs,
                )
        if expect_seq is not None and expect != self.next_seq:
            raise WalCorruption(
                f"replay ended at sequence {expect} but the log's next "
                f"sequence is {self.next_seq}; records past the pinned "
                "position are missing"
            )

    def total_bytes(self) -> int:
        """Bytes currently on disk across every segment file."""
        total = 0
        for s in self.segments():
            try:
                total += os.path.getsize(self._segment_path(s))
            except OSError:
                continue
        return total

    def stats(self) -> dict:
        with self._lock:
            return {
                "segment": self._segment,
                "offset": self._fh.tell() if not self._fh.closed else 0,
                "next_seq": self._next_seq,
                "appended": self.appended,
                "synced_through": self.synced_through,
                "fsync_every": self.fsync_every,
            }

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
