"""The closed loop of clients and the arithmetic of its end-to-end metrics.

C clients each have one request outstanding: a client sends its next
request as soon as its previous one is answered, until the window closes.
One sender thread sends every request; the answer's callback stamps its
time and hands the client back to the sender, so the load comes from one
thread, not C.  Every request takes the next query of the pool in issue
order, so no query repeats in a run and the n-th request issued always
carries query n.  A request sent inside the window is waited for past the
close (up to ``grace_s``); one that never comes, or that raises, has
failed.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from typing import Any, Dict, List

import numpy as np

__all__ = ["Window", "closed_loop", "p95_ms", "qps"]


class Window:
    """The records of one window, request n at position n, in arrays: no
    object per request outlives its answer, so the harness adds no garbage
    for the collector to walk while the program runs."""

    def __init__(self, n: int):
        self.t_submit = np.full(n, np.nan)
        self.t_done = np.full(n, np.inf)
        self.ok = np.zeros(n, dtype=bool)
        #: ``digest(answer)`` of each answered request (None otherwise)
        self.kept: List[Any] = [None] * n
        self.errors: Dict[int, str] = {}
        self.issued = 0
        self.t_open = self.t_close = math.nan


def closed_loop(submit, queries, *, clients: int, seconds: float, digest=lambda answer: answer,
                grace_s: float = 60.0, on_open=None) -> Window:
    """Run the window: ``submit(q) -> Future``; ``digest(answer)`` is what
    is kept of each answer.  ``on_open(t_open, t_close)`` runs in the
    calling thread once the window is open (the traced run starts its
    profiler from there)."""
    win = Window(len(queries))
    answered: "queue.SimpleQueue[int]" = queue.SimpleQueue()
    fatal = []

    def on_answer(i: int, fut) -> None:
        t = time.perf_counter()
        exc = fut.exception()
        if exc is None:
            win.kept[i] = digest(fut.result())
            win.ok[i] = True
        else:
            win.errors[i] = f"{type(exc).__name__}: {exc}"
        win.t_done[i] = t
        answered.put(i)

    def send() -> bool:
        now = time.perf_counter()
        if now >= win.t_close:
            return False
        i = win.issued
        if i >= len(queries):
            raise RuntimeError(f"the query pool ({len(queries)} rows) ran out: raise query_pool")
        win.issued += 1
        win.t_submit[i] = now
        try:
            fut = submit(queries[i])
        except Exception as e:  # noqa: BLE001 - a refused request is counted, not raised
            win.errors[i], win.t_done[i] = f"{type(e).__name__}: {e}", time.perf_counter()
            answered.put(i)
            return True
        fut.add_done_callback(lambda f, i=i: on_answer(i, f))
        return True

    def sender() -> None:
        try:
            outstanding = sum(send() for _ in range(clients))
            while outstanding:
                try:
                    answered.get(timeout=max(0.0, win.t_close - time.perf_counter()) + grace_s)
                except queue.Empty:
                    return                     # the rest never came: failed
                outstanding -= 1
                outstanding += send()
        except RuntimeError as e:
            fatal.append(e)

    thread = threading.Thread(target=sender, name="closed-loop-sender", daemon=True)
    win.t_open = time.perf_counter()
    win.t_close = win.t_open + seconds
    thread.start()
    if on_open is not None:
        on_open(win.t_open, win.t_close)
    thread.join(timeout=seconds + 2 * grace_s)
    if fatal:
        raise fatal[0]
    if thread.is_alive():
        raise RuntimeError("the closed loop did not finish within the grace period")
    for i in range(win.issued):
        if not win.ok[i] and i not in win.errors:
            win.errors[i] = "never answered"
    return win


def qps(win: Window) -> float:
    """Requests answered per second of the window: each answered inside the
    window counts 1, each still in flight at the close the share of its
    latency that fell inside the window (so the rate holds all the work of
    the window, not whole batches only)."""
    n = win.issued
    ok, a, b = win.ok[:n], win.t_submit[:n], win.t_done[:n]
    inside = ok & (b <= win.t_close)
    late = ok & (b > win.t_close) & (a < win.t_close)
    done = inside.sum() + ((win.t_close - a[late]) / (b[late] - a[late])).sum()
    return float(done) / (win.t_close - win.t_open)


def p95_ms(win: Window) -> float:
    """95th percentile (nearest rank) of client-side latency over every
    request issued in the window, a failed one counting as infinitely late."""
    n = win.issued
    if n == 0:
        return math.inf
    lat = np.sort(np.where(win.ok[:n], win.t_done[:n] - win.t_submit[:n], np.inf))
    return 1e3 * float(lat[max(0, math.ceil(0.95 * n) - 1)])
