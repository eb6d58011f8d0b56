"""Background maintenance thread: compaction, drift refits, checkpoints.

``BackgroundCompactor`` owns one daemon thread that polls its registered
indexes and runs whatever maintenance each one reports as pending — for a
``DurableIndex`` that is its ``tick()`` (drift refit > deferred compaction >
due checkpoint); for a bare ``MutableIndex`` it folds when
``pending_compaction`` is set (callers must not mutate a bare mutable index
concurrently — only ``DurableIndex`` carries its own write lock).

The point of the thread is *where* the fold runs, not *whether*: the
``add()`` path only ever marks ``pending_compaction``, and the compactor
picks it up here — so insert latency never carries the full-rebuild stall,
and queries in flight keep their snapshot while the swap happens under the
index's generation counter.

    with BackgroundCompactor(index) as bg:
        ... serve reads and writes; folds happen off-path ...
    # or without the context manager:
    bg = BackgroundCompactor(index, interval_s=0.05).start()
    ...
    bg.stop()

Each tick runs with the index's device current on the maintenance thread
(``on_device``), so the fold's and the refit's kernels (K5, K4) launch on
the card that holds the index, on that card's default stream, ordered with
the readers' launches.  ``kick()`` wakes the thread immediately.
Maintenance errors are counted and remembered (``last_error``) but never
kill the thread — a failed fold retries on the next pass; nothing falls
back to another device.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from repro_torch.device import on_device

__all__ = ["BackgroundCompactor"]

_ACTION_COUNTERS = {
    "compact": "compactions",
    "refit": "refits",
    "checkpoint": "checkpoints",
}


class BackgroundCompactor:
    """Daemon maintenance loop over one or more online indexes."""

    def __init__(self, *indexes, interval_s: float = 0.02):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive; got {interval_s}")
        self.interval_s = float(interval_s)
        self._indexes: List[object] = list(indexes)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopping = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self.counters = {
            "ticks": 0,
            "compactions": 0,
            "refits": 0,
            "checkpoints": 0,
            "errors": 0,
        }

    # -- registration ----------------------------------------------------------
    def register(self, index) -> None:
        with self._lock:
            if index not in self._indexes:
                self._indexes.append(index)
        self._wake.set()

    def unregister(self, index) -> None:
        with self._lock:
            if index in self._indexes:
                self._indexes.remove(index)

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "BackgroundCompactor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._run, name="repro-compactor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, *, timeout: float = 30.0) -> None:
        """Stop the loop; the in-progress maintenance step (if any) is
        allowed to finish so a half-built fold is never abandoned."""
        self._stopping.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def kick(self) -> None:
        """Wake the thread for an immediate pass."""
        self._wake.set()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- the loop --------------------------------------------------------------
    def _run(self) -> None:
        while not self._stopping.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stopping.is_set():
                break
            self.run_pending()

    def run_pending(self) -> int:
        """One synchronous pass over every registered index (also the test
        hook: call it inline instead of starting the thread).  Returns the
        number of maintenance actions performed."""
        with self._lock:
            indexes = list(self._indexes)
            self.counters["ticks"] += 1
        did = 0
        for idx in indexes:
            try:
                action = self._tick_one(idx)
            except Exception as e:  # noqa: BLE001 — maintenance must not die
                with self._lock:
                    self.counters["errors"] += 1
                    self.last_error = e
                continue
            if action:
                did += 1
                counter = _ACTION_COUNTERS.get(action)
                if counter:
                    with self._lock:
                        self.counters[counter] += 1
        return did

    @staticmethod
    def _tick_one(idx) -> Optional[str]:
        with on_device(idx.device):
            tick = getattr(idx, "tick", None)
            if callable(tick):
                return tick()
            if getattr(idx, "pending_compaction", False):
                idx.compact()
                return "compact"
            return None

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out["running"] = self.running
        out["interval_s"] = self.interval_s
        return out

    def __enter__(self) -> "BackgroundCompactor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
