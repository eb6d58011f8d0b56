"""repro_torch.store — durable online ingest for the index layer.

The persistence spine under ``build_index(durable=True, wal_dir=...)``, the
JAX package's ``repro.store`` on PyTorch with the same on-disk format (a log
or checkpoint written by either package opens in the other):

  * ``wal``        — append-only, checksummed, fsync-batched mutation log.
  * ``snapshot``   — snapshot-consistent checkpoints behind an atomic
                     ``CURRENT`` pointer; external ``save()`` in the same
                     format.
  * ``durable``    — ``DurableIndex``: WAL-first mutations, generation-swap
                     compaction/refits, crash recovery (``open_durable``).
  * ``drift``      — pivot-distance histogram divergence that triggers
                     shadow refits when the stream leaves the fitted
                     distribution.
  * ``compactor``  — the background maintenance thread that runs all of the
                     above off the query path.
  * ``wal_inspect`` — ``python -m repro_torch.store.wal_inspect [--verify]
                     <wal_dir>``: dump or verify a log.

The log, the checkpoints' files and the drift histograms are host state;
segments, replay's and refits' K5/K4 work and the drift witnesses' distances
run on the index's device.
"""

from repro_torch.store.compactor import BackgroundCompactor
from repro_torch.store.drift import DriftDetector
from repro_torch.store.durable import (
    DurableIndex,
    apply_record,
    open_durable,
    segment_pivots,
)
from repro_torch.store.snapshot import (
    checkpoint_next_seq,
    current_checkpoint,
    list_checkpoints,
    publish_checkpoint,
    read_snapshot,
    write_snapshot,
)
from repro_torch.store.wal import (
    LogPosition,
    WalCorruption,
    WalRecord,
    WriteAheadLog,
    encode_record,
    scan_segment,
)

__all__ = [
    "BackgroundCompactor",
    "DriftDetector",
    "DurableIndex",
    "LogPosition",
    "WalCorruption",
    "WalRecord",
    "WriteAheadLog",
    "apply_record",
    "checkpoint_next_seq",
    "current_checkpoint",
    "encode_record",
    "list_checkpoints",
    "open_durable",
    "publish_checkpoint",
    "read_snapshot",
    "scan_segment",
    "segment_pivots",
    "write_snapshot",
]
