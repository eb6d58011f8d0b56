"""Snapshot-consistent persistence for the durable ingest layer.

The JAX package's ``repro.store.snapshot`` over ``repro_torch.api.persistence``:
the same layout, manifest keys and fsync order, so a checkpoint or external
save written by either package loads in the other.

A durable snapshot is a directory in the versioned index format: a
``manifest.json`` whose kind is ``"durable"`` and whose params pin the WAL
position the state was captured at, plus a nested ``state/`` directory
holding the full ``MutableIndex`` save (base + materialised delta — nothing
is re-measured on load).  Loading replays the WAL tail past the pinned
position, so a snapshot taken *while dirty* (writes still arriving)
round-trips to the exact current state.

Two consumers share the format:

  * **internal checkpoints** — ``publish_checkpoint`` writes a snapshot under
    ``<wal_dir>/snapshots/`` behind an atomically-replaced ``CURRENT``
    pointer file (crash mid-checkpoint leaves the previous checkpoint
    intact; recovery just replays a longer tail), then garbage-collects
    superseded snapshots.  Every data file and directory of the new
    checkpoint is fsynced BEFORE ``CURRENT`` repoints at it and before any
    GC runs, so even power loss cannot leave ``CURRENT`` naming a checkpoint
    whose blocks never reached disk after the WAL history that could
    rebuild it is gone.
  * **external saves** — ``DurableIndex.save(path)`` writes the same layout
    anywhere; ``load_index(path)`` reattaches to the recorded ``wal_dir``
    and replays the tail.

Saving copies every segment's rows and table from the device to the host
(``MutableIndex.save``); callers run it off the write lock on a frozen copy.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional, Tuple

from repro_torch.api.persistence import MANIFEST_NAME, read_index_dir, write_index_dir
from repro_torch.store.wal import LogPosition

__all__ = [
    "CURRENT_NAME",
    "SNAPSHOT_SUBDIR",
    "STATE_SUBDIR",
    "checkpoint_next_seq",
    "current_checkpoint",
    "list_checkpoints",
    "publish_checkpoint",
    "read_snapshot",
    "write_snapshot",
]

SNAPSHOT_SUBDIR = "snapshots"
CURRENT_NAME = "CURRENT"
STATE_SUBDIR = "state"


def _fsync_path(path: str) -> None:
    """fsync one file or directory by descriptor.  Directory fsync makes a
    rename/create durable on POSIX; platforms that cannot open a directory
    for reading are tolerated (their rename durability is best-effort)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(path: str) -> None:
    """fsync every file then every directory under ``path``, bottom-up, so a
    rename publishing the tree can never become durable before its contents
    — the power-loss half of the checkpoint durability contract."""
    for dirpath, _dirnames, filenames in os.walk(path, topdown=False):
        for name in filenames:
            _fsync_path(os.path.join(dirpath, name))
        _fsync_path(dirpath)


def write_snapshot(frozen, path, *, wal_dir: str, position: LogPosition,
                   next_seq: int, refits: int, build_params: Optional[dict],
                   query_options: Optional[dict] = None,
                   attributes=None) -> None:
    """Write one snapshot directory: durable manifest + nested inner state.

    ``frozen`` must be a point-in-time ``MutableIndex`` copy (the caller
    captures it under the write lock via ``frozen_copy()``); everything here
    runs off-lock, so saving never stalls the ingest path.  ``attributes``
    (an ``AttributeStore`` view captured at the same point) lands under
    ``attributes/`` so filtered search survives recovery.
    """
    path = os.fspath(path)
    write_index_dir(
        path,
        kind="durable",
        params={
            "wal_dir": os.path.abspath(os.fspath(wal_dir)),
            "position": position.to_dict(),
            "next_seq": int(next_seq),
            "generation": int(frozen.generation),
            "refits": int(refits),
            "build_params": build_params,
            "query_options": query_options,
        },
        arrays={},
    )
    frozen.save(os.path.join(path, STATE_SUBDIR))
    if attributes is not None:
        attributes.save(os.path.join(path, "attributes"))


def read_snapshot(path, *, device="cuda") -> Tuple[object, dict]:
    """(inner ``MutableIndex`` on ``device``, snapshot params) from one
    snapshot directory."""
    from repro_torch.api.factory import load_index

    path = os.fspath(path)
    manifest, _arrays = read_index_dir(path)
    if manifest["kind"] != "durable":
        raise ValueError(
            f"{path!r} is a {manifest['kind']!r} index directory, not a "
            "durable snapshot"
        )
    inner = load_index(os.path.join(path, STATE_SUBDIR), device=device)
    return inner, manifest["params"]


def _snapshot_root(wal_dir) -> str:
    return os.path.join(os.fspath(wal_dir), SNAPSHOT_SUBDIR)


def current_checkpoint(wal_dir) -> Optional[str]:
    """Path of the live internal checkpoint, or None before the first one."""
    pointer = os.path.join(os.fspath(wal_dir), CURRENT_NAME)
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    path = os.path.join(_snapshot_root(wal_dir), name)
    return path if os.path.isdir(path) else None


def checkpoint_next_seq(wal_dir) -> Optional[int]:
    """``next_seq`` recorded by the live internal checkpoint, or None.

    After a checkpoint rolls the log and GCs every covered segment, this
    manifest is the only surviving witness of how far the sequence actually
    ran — recovery uses it as a floor so that a replay against a stale
    external snapshot cannot silently pass completeness verification."""
    ckpt = current_checkpoint(wal_dir)
    if ckpt is None:
        return None
    try:
        with open(os.path.join(ckpt, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        return int(manifest["params"]["next_seq"])
    except (OSError, KeyError, TypeError, ValueError):
        return None


def list_checkpoints(wal_dir) -> List[str]:
    root = _snapshot_root(wal_dir)
    if not os.path.isdir(root):
        return []
    return sorted(n for n in os.listdir(root) if n.startswith("ckpt-"))


def publish_checkpoint(wal_dir, frozen, *, position: LogPosition,
                       next_seq: int, refits: int,
                       build_params: Optional[dict],
                       query_options: Optional[dict] = None,
                       attributes=None) -> str:
    """Write an internal checkpoint and atomically repoint ``CURRENT`` at it.

    The snapshot is written under a dot-prefixed temp name first, fully
    fsynced (every data file and directory, then the parent after the
    rename), renamed into place, and only then referenced from ``CURRENT``
    (itself fsynced and replaced atomically via ``os.replace``) — a crash
    OR power loss at any point leaves a readable previous checkpoint, and
    by the time the caller garbage-collects older checkpoints and WAL
    segments the new checkpoint's blocks are on stable storage, never only
    in the page cache.  Superseded checkpoints are removed afterwards.
    """
    wal_dir = os.fspath(wal_dir)
    root = _snapshot_root(wal_dir)
    os.makedirs(root, exist_ok=True)
    name = f"ckpt-{int(next_seq):012d}-g{int(frozen.generation):06d}"
    tmp = os.path.join(root, f".{name}.tmp")
    final = os.path.join(root, name)
    for stale in (tmp, final):
        if os.path.isdir(stale):
            shutil.rmtree(stale)
    write_snapshot(
        frozen, tmp, wal_dir=wal_dir, position=position, next_seq=next_seq,
        refits=refits, build_params=build_params, query_options=query_options,
        attributes=attributes,
    )
    _fsync_tree(tmp)
    os.rename(tmp, final)
    _fsync_path(root)
    pointer = os.path.join(wal_dir, CURRENT_NAME)
    pointer_tmp = pointer + ".tmp"
    with open(pointer_tmp, "w") as f:
        f.write(name + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(pointer_tmp, pointer)
    _fsync_path(wal_dir)
    for other in list_checkpoints(wal_dir):
        if other != name:
            shutil.rmtree(os.path.join(root, other), ignore_errors=True)
    return final
