"""The traced window: device activity from ``torch.profiler`` (CUPTI).

The profiler covers the last ``trace_seconds`` of a ``--trace 1`` run's
window.  From it come: the device's busy seconds (the union of every kernel,
copy and set on the card), the per-kernel device seconds of the program's
kernels, named through ``kernel_names.json``, and the idle gaps, each
labelled by the benchmark's own host span open at its middle.  The
benchmark's spans are kept on the host clock (``time.perf_counter``) and
put on the trace's clock by one marker range recorded from the main
thread.
"""

from __future__ import annotations

import bisect
import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["Spans", "TraceSummary", "Tracer", "clean_kernel_name", "kernel_ids"]

_HERE = Path(__file__).resolve().parent
_MARK = "portbench.clock_mark"


def clean_kernel_name(name: str) -> str:
    """A device kernel's bare function name (no namespace, template or
    parameters)."""
    bare = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""))[0]
    return re.sub(r"^(void )?.*::", "", bare).removeprefix("void ").strip() or name


def kernel_ids() -> Dict[str, str]:
    """Bare kernel name -> the program's kernel id (K1-K6)."""
    return json.loads((_HERE / "kernel_names.json").read_text())["kernels"]


class Spans:
    """Host intervals by label (thread-safe appends; list.append is atomic)."""

    def __init__(self):
        self.by_label: Dict[str, List[Tuple[float, float]]] = {}

    def add(self, label: str, t0: float, t1: float) -> None:
        self.by_label.setdefault(label, []).append((t0, t1))


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]          # bare name of one of the program's kernels -> device seconds
    op_s: Dict[str, float]              # every device op by bare name -> seconds
    gaps: List[Tuple[str, float]] = field(default_factory=list)   # (host label, idle seconds)
    launches: Dict[str, Dict[tuple, int]] = field(default_factory=dict)
    diag: Dict[str, object] = field(default_factory=dict)

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        totals: Dict[str, float] = {}
        for label, s in self.gaps:
            totals[label] = totals.get(label, 0.0) + s
        idle = [[f"total:{k}", v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]
        longest = sorted(self.gaps, key=lambda g: -g[1])
        idle += [[f"gap:{label}", s] for label, s in longest[: max(0, 10 - len(idle))]]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle[:10]}


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Tracer:
    """Start in the main thread at the traced window's open, stop at its
    close (``stop`` synchronises the device first, so every kernel launched
    before the close is in the trace)."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def warm(self) -> None:
        """Start and stop the profiler once (CUPTI's first start is slow)."""
        torch = self.torch
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch = self.torch
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        with torch.profiler.record_function(_MARK):
            self.mark_host = time.perf_counter()
        self.t_open = self.mark_host

    def stop(self) -> float:
        """Synchronise and stop; returns the host time of the close."""
        self.torch.cuda.synchronize()
        self.t_close = time.perf_counter()
        self.prof.stop()
        return self.t_close

    def summary(self, spans: Spans, launches) -> TraceSummary:
        ids = kernel_ids()
        mark_us = None
        device = []
        for e in self.prof.events():
            if e.name == _MARK:
                mark_us = e.time_range.start
            elif e.device_type.name == "CUDA":
                device.append((e.time_range.start, e.time_range.end, clean_kernel_name(e.name)))
        if mark_us is None:
            raise RuntimeError("the profiler recorded no clock mark")
        # trace microseconds -> host seconds
        to_host = lambda us: self.mark_host + (us - mark_us) * 1e-6  # noqa: E731
        lo, hi = self.t_open, self.t_close
        op_s: Dict[str, float] = {}
        kernel_s: Dict[str, float] = {}
        iv = []
        for a, b, name in device:
            a, b = max(to_host(a), lo), min(to_host(b), hi)
            if b <= a:
                continue
            iv.append((a, b))
            op_s[name] = op_s.get(name, 0.0) + (b - a)
            if name in ids:
                kernel_s[name] = kernel_s.get(name, 0.0) + (b - a)
        busy = _merge(iv)
        open_ = {label: _merge(spans.by_label.get(label, [])) for label in _PRECEDENCE}
        starts = {label: [a for a, _ in v] for label, v in open_.items()}
        gaps = []
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((_label(open_, starts, 0.5 * (a + b)), b - a))
        kinds: Dict[str, int] = {}
        for _, _, name in device:
            kind = "kernel" if name in ids else name.split(" ")[0] if name.startswith("Mem") else "other"
            kinds[kind] = kinds.get(kind, 0) + 1
        diag = {"device_events": len(device), "in_window": len(iv), "by_kind": kinds,
                "first_s": (to_host(min(a for a, _, _ in device)) - lo) if device else None,
                "last_s": (to_host(max(b for _, b, _ in device)) - lo) if device else None}
        return TraceSummary(window_s=hi - lo, busy_s=sum(b - a for a, b in busy), kernel_s=kernel_s,
                            op_s=op_s, gaps=gaps, launches=launches, diag=diag)


#: host labels in order of precedence: the index running a batch, else a
#: request outstanding (queued or being dispatched), else the clients alone
_PRECEDENCE = ("index.query", "service")


def _label(open_: dict, starts: dict, t: float) -> str:
    for label in _PRECEDENCE:
        i = bisect.bisect_right(starts[label], t) - 1
        if i >= 0 and open_[label][i][1] >= t:
            return label
    return "client"
