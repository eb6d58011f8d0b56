"""Spans of the search path, kept in memory.

A span is one interval on ``time.perf_counter()``: its name, start and end,
its own id, the id of its parent (the innermost span open on the same
thread when it began, or the one ``record`` names), a trace id that every
span under one root shares, and a few attributes.

Spans are recorded after ``enable()``, while a ``torch.profiler`` session
records, and under a span that is itself being recorded (so a root span
open when the profiler stops still gets all its children).  Otherwise a
span site returns one shared no-op context: no span object is made and
nothing is kept.  Finished spans go to a bounded ring (the oldest drop out
first); ``snapshot()`` copies it, ``summary()`` totals it by name.

The span sites and what reads them are listed in ``PERF.md`` (section 3).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

import torch.autograd.profiler as _profiler

__all__ = ["NO_SPAN", "RING", "Span", "clear", "disable", "enable", "record", "snapshot", "span", "summary"]

#: finished spans kept (the oldest drop out first)
RING = 1 << 16

_perf = time.perf_counter
_ids = itertools.count(1)
_ring: deque = deque(maxlen=RING)
_ring_lock = threading.Lock()
_enabled = False


class _Local(threading.local):
    """Each thread's stack of open recorded spans (set up on a thread's
    first access, so a read never misses)."""

    def __init__(self):
        self.stack: List["Span"] = []


_local = _Local()


class Span:
    """One span: a context manager while open, a record once finished."""

    __slots__ = ("name", "t0", "t1", "id", "parent", "trace", "attrs")

    def __init__(self, name: str, attrs: dict, parent: Optional["Span"] = None):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.trace = parent.trace if parent is not None else self.id
        self.t0 = self.t1 = None

    def __enter__(self) -> "Span":
        _local.stack.append(self)
        self.t0 = _perf()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = _perf()
        _local.stack.pop()
        _keep(self)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _NoSpan:
    """The shared no-op context a span site returns while spans are off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass

    def __bool__(self) -> bool:
        return False


NO_SPAN = _NoSpan()


def _keep(s: Span) -> None:
    with _ring_lock:
        _ring.append(s)


def span(name: str, **attrs):
    """A span around a ``with`` block: a new ``Span`` whose parent is the
    innermost open span of this thread, or ``NO_SPAN`` while spans are off
    and no recorded span is open on this thread."""
    stack = _local.stack
    if stack:
        return Span(name, attrs, stack[-1])
    if _enabled or _profiler._is_profiler_enabled:
        return Span(name, attrs)
    return NO_SPAN


def record(name: str, t0: float, t1: float, parent=None, **attrs) -> Optional[Span]:
    """Keep an interval measured elsewhere (another thread, a queue) as a
    finished span under ``parent`` (default: this thread's innermost open
    span).  Under ``NO_SPAN``, or with spans off and none open, it keeps
    nothing and returns None."""
    if parent is None:
        stack = _local.stack
        parent = stack[-1] if stack else None
        if parent is None and not (_enabled or _profiler._is_profiler_enabled):
            return None
    elif not parent:
        return None
    s = Span(name, attrs, parent)
    s.t0, s.t1 = t0, t1
    _keep(s)
    return s


def enable() -> None:
    """Record spans from now on, profiler or not."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records (the default)."""
    global _enabled
    _enabled = False


def clear() -> None:
    """Drop every finished span."""
    with _ring_lock:
        _ring.clear()


def snapshot() -> List[Span]:
    """The finished spans, oldest first."""
    with _ring_lock:
        return list(_ring)


def summary(spans: Optional[Iterable[Span]] = None) -> Dict[str, dict]:
    """By name: ``count``, inclusive seconds ``total_s`` and ``self_s``, the
    inclusive seconds less the part of each span that its children cover
    (children clipped to their parent's interval, overlaps counted once).
    Over ``spans``, or over ``snapshot()``."""
    spans = snapshot() if spans is None else list(spans)
    children: Dict[int, list] = {}
    for s in spans:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.t0, s.t1))
    out: Dict[str, dict] = {}
    for s in spans:
        covered = 0.0
        end = s.t0
        for a, b in sorted(children.get(s.id, ())):
            a, b = max(a, end), min(b, s.t1)
            if b > a:
                covered += b - a
                end = b
        row = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += s.t1 - s.t0
        row["self_s"] += s.t1 - s.t0 - covered
    return out
