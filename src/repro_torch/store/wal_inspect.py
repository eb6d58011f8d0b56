"""Dump / verify a durable store's write-ahead log.

    PYTHONPATH=src python -m repro_torch.store.wal_inspect <wal_dir>            # dump
    PYTHONPATH=src python -m repro_torch.store.wal_inspect --verify <wal_dir>   # verify only

Dump prints one line per record (seq, op, ids, payload shape, end offset)
plus the checkpoint pointer and the pinned replay position.  Verify walks
every segment record-by-record, checking magic / sequence continuity /
checksums, and exits nonzero on corruption anywhere other than the final
tail (a torn tail is a legal crash artifact and is reported, not failed).
The lines are those of the JAX package's ``tools/wal_inspect.py`` on the
same directory; the log format is shared, so either tool reads either
package's logs.  Host only: nothing here touches a device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.store.snapshot import current_checkpoint
from repro_torch.store.wal import scan_segment

__all__ = ["inspect", "main"]


def _segments(wal_dir):
    out = []
    for name in sorted(os.listdir(wal_dir)):
        if name.startswith("wal-") and name.endswith(".log"):
            out.append((int(name[4:-4]), os.path.join(wal_dir, name)))
    return sorted(out)


def inspect(wal_dir: str, *, verify_only: bool = False, out=None) -> int:
    out = sys.stdout if out is None else out
    wal_dir = os.path.abspath(wal_dir)
    if not os.path.isdir(wal_dir):
        print(f"error: {wal_dir!r} is not a directory", file=out)
        return 2
    segments = _segments(wal_dir)
    if not segments:
        print(f"error: no wal-*.log segments under {wal_dir!r}", file=out)
        return 2

    ckpt = current_checkpoint(wal_dir)
    if ckpt is not None:
        with open(os.path.join(ckpt, "manifest.json")) as f:
            params = json.load(f)["params"]
        pinned = (params["position"]["segment"], params["position"]["offset"])
        print(f"checkpoint: {os.path.basename(ckpt)} "
              f"(pins segment {pinned[0]} offset {pinned[1]}, "
              f"next_seq {params['next_seq']}, refits {params['refits']})",
              file=out)
    else:
        print("checkpoint: none (CURRENT missing)", file=out)

    status = 0
    expect_seq = None
    n_records = 0
    last = segments[-1][0]
    for seg, path in segments:
        records, valid_end, size = scan_segment(path, expect_seq=expect_seq)
        for seq, op, ids, rows, end, attrs in records:
            expect_seq = seq + 1
            n_records += 1
            if not verify_only:
                shape = "-" if rows is None else "x".join(map(str, rows.shape))
                ids_s = ",".join(map(str, ids[:6])) + ("…" if len(ids) > 6 else "")
                attrs_s = "" if not attrs else f" attrs={','.join(sorted(attrs))}"
                print(f"  seg {seg} seq {seq:>6} {op:<6} ids=[{ids_s}] "
                      f"rows={shape} end={end}{attrs_s}", file=out)
        if valid_end < size:
            torn = size - valid_end
            if seg == last:
                print(f"segment {seg}: torn tail ({torn} bytes past offset "
                      f"{valid_end}) — legal crash artifact, recovery drops it",
                      file=out)
            else:
                print(f"segment {seg}: CORRUPT at offset {valid_end} "
                      f"({torn} bytes unreadable) with later segments present "
                      "— acknowledged records are unrecoverable", file=out)
                status = 1
    print(f"{'FAIL' if status else 'OK'}: {len(segments)} segment(s), "
          f"{n_records} valid record(s)", file=out)
    return status


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("wal_dir", help="durable store directory (holds wal-*.log)")
    ap.add_argument("--verify", action="store_true",
                    help="suppress the per-record dump; just validate")
    args = ap.parse_args(argv)
    return inspect(args.wal_dir, verify_only=args.verify)


if __name__ == "__main__":
    sys.exit(main())
