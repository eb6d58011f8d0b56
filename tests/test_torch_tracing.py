"""The port's spans (``repro_torch.tracing``) on the CPU.

Off by default: a span site returns the shared no-op and nothing is kept.
``enable()`` (or a recording ``torch.profiler``) turns them on: names,
order, parent and trace ids, self time.  Then the span sites of the search
path under a ``SearchService`` over a small ``nsimplex`` index, the public
overflow counter, and the benchmark's six ``program_span`` readers on a
tiny CPU run of a cell.
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.api import Query, build_index
from repro_torch.launch.service import SearchService

_ROOT = Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

torch.set_num_threads(1)

#: the benchmark's readers of the program's spans
SPAN_READERS = ("queue_wait_ms", "fused_passes_ms_per_query", "overflow_bounds_ms_per_query",
                "overflow_select_ms_per_query", "refine_ms_per_query", "kernel_host_us_per_launch")
#: a cell cut to what a CPU test holds in about a second
TINY = {"n_rows": 2000, "query_pool": 400, "clients": 4, "check_sample": 64}


@pytest.fixture
def spans_on():
    tracing.clear()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.clear()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_by_default_records_nothing():
    tracing.clear()
    site = tracing.span("off", rows=3)
    assert site is tracing.NO_SPAN and not site
    with tracing.span("outer") as s:
        s.set(cls=(1, 2))
        with tracing.span("inner"):
            pass
    assert tracing.record("late", 0.0, 1.0) is None
    assert tracing.snapshot() == [] and tracing.summary() == {}


def test_enable_records_names_order_parents_and_traces(spans_on):
    with tracing.span("root", Q=4) as root:
        with tracing.span("a") as a:
            with tracing.span("a.leaf", rows=7):
                pass
        with tracing.span("b") as b:
            b.set(cls=(64, 20))
        q = tracing.record("queued", root.t0 - 1.0, root.t0, parent=root)
    with tracing.span("other_root") as other:
        pass
    got = tracing.snapshot()
    assert [s.name for s in got] == ["a.leaf", "a", "b", "queued", "root", "other_root"]
    by = {s.name: s for s in got}
    assert root.parent is None and root.trace == root.id
    assert by["a"].parent == root.id and by["b"].parent == root.id and q.parent == root.id
    assert by["a.leaf"].parent == a.id
    assert {s.trace for s in got if s is not other} == {root.id}
    assert other.trace == other.id != root.id
    assert by["root"].attrs == {"Q": 4} and by["a.leaf"].attrs == {"rows": 7}
    assert by["b"].attrs == {"cls": (64, 20)}
    assert all(s.t0 <= s.t1 for s in got)
    # the root's self time leaves out what a and b cover (the queued
    # record lies before the root opened, so it covers none of it)
    summ = tracing.summary()
    assert summ["root"]["count"] == 1
    want = root.seconds - a.seconds - b.seconds
    assert summ["root"]["self_s"] == pytest.approx(want, abs=1e-9)
    assert summ["a"]["self_s"] == pytest.approx(a.seconds - by["a.leaf"].seconds, abs=1e-9)
    assert summ["a.leaf"]["self_s"] == summ["a.leaf"]["total_s"]


def test_self_time_counts_overlapping_children_once(spans_on):
    root = tracing.record("root", 10.0, 20.0)
    for t0, t1 in ((11.0, 13.0), (12.0, 14.0), (19.0, 22.0), (5.0, 6.0)):
        tracing.record("child", t0, t1, parent=root)
    summ = tracing.summary()
    # children cover [11, 14] and [19, 20] of the root: 4 of its 10 s
    assert summ["root"] == {"count": 1, "total_s": 10.0, "self_s": 6.0}
    assert summ["child"] == {"count": 4, "total_s": 8.0, "self_s": 8.0}


def test_threads_keep_their_own_parents(spans_on):
    seen = {}

    def work(tag):
        with tracing.span(f"root.{tag}") as r:
            time.sleep(0.01)
            with tracing.span(f"child.{tag}") as c:
                seen[tag] = (r.id, r.trace, c.parent, c.trace)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    for rid, rtrace, cparent, ctrace in seen.values():
        assert cparent == rid and ctrace == rtrace == rid
    assert len(tracing.snapshot()) == 8


def test_profiler_turns_spans_on_and_off():
    tracing.clear()
    assert tracing.span("before") is tracing.NO_SPAN
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("inside") as s:
            torch.zeros(4).add_(1)
        open_root = tracing.span("open_at_stop")
        open_root.__enter__()
    # a span open when the profiler stopped keeps recording its children
    with tracing.span("child_after_stop"):
        pass
    open_root.__exit__(None, None, None)
    assert prof is not None and s
    assert tracing.span("after") is tracing.NO_SPAN
    names = [x.name for x in tracing.snapshot()]
    assert names == ["inside", "child_after_stop", "open_at_stop"]
    tracing.clear()


def _index(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return build_index(rng.random((n, 16)), "euclidean", kind="nsimplex", n_pivots=8, device="cpu"), rng


def test_service_spans_queue_overflow_and_refinement(spans_on):
    index, rng = _index()
    queries = rng.random((24, 16))
    over0 = index.overflow_queries
    tracing.clear()     # the build's spans
    with SearchService(index, max_batch=8, pad_batches=False) as svc:
        futures = [svc.submit(q, Query.knn(10)) for q in queries]
        results = [f.result(timeout=60) for f in futures]
    assert "coalesced_fraction" not in svc.stats()
    spans = tracing.snapshot()
    by = _by_name(spans)
    batches = {s.id: s for s in by["service.batch"]}
    assert sum(b.attrs["requests"] for b in batches.values()) == len(queries)
    assert all(b.attrs["padded"] == b.attrs["requests"] for b in batches.values())
    # one queue span per request, under its batch, in its trace, ending
    # before the batch opened
    assert len(by["service.queue"]) == len(queries)
    for s in by["service.queue"]:
        b = batches[s.parent]
        assert s.trace == b.trace and s.t0 <= s.t1 <= b.t0
    # every span of the search path lies in some batch's trace
    traces = {b.trace for b in batches.values()}
    assert {s.trace for s in spans} == traces
    assert len(by["api.execute"]) == len(batches)
    assert sum(s.attrs["Q"] for s in by["nsimplex.pass_a"]) == len(queries)
    # one overflow span per query the public counter counts, each over cap
    overflow = by.get("nsimplex.overflow", [])
    assert len(overflow) == index.overflow_queries - over0 > 0
    assert all(s.attrs["count"] > s.attrs["cap"] for s in overflow)
    # one bounds span (the K3 re-run) and one select span per batch that
    # overflows, over just its overflowing queries, at a width that holds them
    bounds, select = by["nsimplex.overflow.bounds"], by["nsimplex.overflow.select"]
    assert len(bounds) == len(select) <= len(batches)
    assert sum(s.attrs["Q"] for s in bounds) == sum(s.attrs["Q"] for s in select) == len(overflow)
    for s in bounds:
        counts = [o.attrs["count"] for o in overflow if o.trace == s.trace]
        assert len(counts) == s.attrs["Q"] and max(counts) <= s.attrs["width"] < 2 * max(counts)
    # the refinement's rows are the answers' true-metric calls less the pivots
    calls = sum(r.stats.original_calls for r in results) - len(queries) * index.n_pivots
    assert sum(s.attrs["rows"] for s in by["metric.refine"]) == calls
    # the kernels' wrappers ran under the passes and the overflow route: K3
    # in pass B and again in the route, no K1
    names = {s.name for s in spans}
    assert {"kernel.K2", "kernel.K3", "kernel.K4"} <= names and "kernel.K1" not in names
    assert len(by["kernel.K3"]) == len(by["nsimplex.pass_b"]) + len(bounds) >= 2


def test_overflow_counter_is_public_and_survives_fit():
    index, rng = _index(seed=1)
    assert index.overflow_queries == 0
    index.query(rng.random((8, 16)), Query.knn(10))
    first = index.overflow_queries
    assert first == index._inner.overflow_queries > 0
    index.fit(rng.random((2500, 16)))
    assert index._inner.overflow_queries == 0 and index.overflow_queries == first
    index.query(rng.random((8, 16)), Query.knn(10))
    assert index.overflow_queries == first + index._inner.overflow_queries > first


@pytest.fixture(scope="module")
def tiny_runs():
    """One tiny CPU run of the JSD cell with spans on, one with them off."""
    from portbench import bench

    cell = bench.load_cell("colors112k-jsd.knn-exact")
    out = {}
    for on in (True, False):
        tracing.clear()
        if on:
            tracing.enable()
        try:
            out[on] = bench.run_cell(cell, seed=2**31 + 311, seconds=0.5, trace=True, t_start=time.perf_counter(),
                                     device="cpu", sizes=TINY)
        finally:
            tracing.disable()
    tracing.clear()
    return out


@pytest.mark.parametrize("metric", SPAN_READERS)
def test_span_readers_read_spans_only_when_recorded(tiny_runs, metric):
    on, off = tiny_runs[True], tiny_runs[False]
    assert on["out"]["correct"] and off["out"]["correct"]
    value = on["out"]["metrics"][metric]["value"]
    assert np.isfinite(value) and value > 0
    assert metric not in off["out"]["metrics"]


def test_index_side_spans_lie_inside_the_index_calls(tiny_runs):
    """The four index-side metrics are parts of the proxy's timing of the
    index's calls: together no more than it, and most of it."""
    m = {k: v["value"] for k, v in tiny_runs[True]["out"]["metrics"].items()}
    parts = sum(m[k] for k in ("fused_passes_ms_per_query", "overflow_bounds_ms_per_query",
                               "overflow_select_ms_per_query", "refine_ms_per_query"))
    assert 0.5 * m["index_ms_per_query"] < parts <= 1.05 * m["index_ms_per_query"]
