"""One run of one cell: set-up, the measured window, the check, the result.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; both
are data files found by name (``configs/<config>.json``,
``traffic/<traffic>.json``), the compared numbers' limits are in
``limits/<cell>.json``, and each per-layer metric is read by
``layers/<metric>.py``.  Nothing here names a cell.

Set-up: the deployment's corpus and the seed's query pool (``datagen``);
``build_index`` over the corpus on the card, behind a proxy that times the
index's ``query`` calls;
``SearchService`` over it; two rounds of one warm request per client on
queries past the pool.  The window: the closed loop (``loop``).  Then
``memory_peak_bytes``, the program's state freed, and the reference's check
on the card.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from portbench import check, datagen, loop
from portbench.trace import Spans, TraceSummary, Tracer

__all__ = ["ROOT", "Run", "load_cell", "result_line", "run_cell"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration, mix,
    limits and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = dict(cells[name])
    configs = {c["name"]: c for c in bench["configs"]}
    cell["config_entry"] = configs[cell["config"]]
    cell["config_data"] = _json(root / configs[cell["config"]]["file"])
    cell["traffic_data"] = _json(HERE / "traffic" / f"{cell['traffic']}.json")
    cell["limits"] = _json(HERE / "limits" / f"{name}.json")["limits"]

    def applies(m):
        return name in m.get("workloads", [name])

    cell["end_to_end"] = [m for m in bench["end_to_end"] if applies(m)]
    cell["per_layer"] = [m for m in bench["per_layer"] if applies(m)]
    return cell


def _reader(metric: str) -> Callable:
    import importlib

    return importlib.import_module(f"portbench.layers.{metric}").read


class IndexProxy:
    """The index handed to the service: times each ``query`` call and counts
    its rows; every other attribute is the index's own."""

    def __init__(self, index, spans: Spans):
        self._index = index
        self._spans = spans
        self.calls = 0
        self.rows = 0
        self.seconds = 0.0

    def query(self, q, spec, *, plan=None):
        t0 = time.perf_counter()
        out = self._index.query(q, spec, plan=plan)
        t1 = time.perf_counter()
        self.calls += 1
        self.rows += int(np.atleast_2d(q).shape[0])
        self.seconds += t1 - t0
        self._spans.add("index.query", t0, t1)
        return out

    def __getattr__(self, name):
        return getattr(self._index, name)


def _overflow(index) -> Optional[int]:
    inner = getattr(index, "_inner", None)
    n = getattr(inner, "overflow_queries", None)
    return int(n) if n is not None else None


def _launch_snapshot(ops) -> Dict[str, Dict[tuple, int]]:
    while True:
        try:
            return {k: dict(v) for k, v in ops.SHAPE_LAUNCHES.items()}
        except RuntimeError:        # a class added while copying
            continue


def _launch_delta(a, b):
    out = {}
    for k, by in b.items():
        d = {c: n - a.get(k, {}).get(c, 0) for c, n in by.items()}
        d = {c: n for c, n in d.items() if n > 0}
        if d:
            out[k] = d
    return out


@dataclass
class Run:
    """What a reader sees of a finished run."""

    cell: dict
    n_rows: int
    n_pivots: int
    window: loop.Window
    service: Dict[str, int]
    index: Dict[str, Any]
    trace: Optional[TraceSummary] = None


def cell_data(cfg: dict, mix: dict, seed: int):
    """(the deployment's corpus, the seed's query pool with one warm query
    per client after it)."""
    corpus = datagen.corpus_rows(cfg["n_rows"], dim=cfg["dim"], **cfg["generator"])
    queries = datagen.query_rows(seed, int(mix["query_pool"]) + int(mix["clients"]), dim=cfg["dim"],
                                 **cfg["generator"])
    return corpus, queries


def _digest(answer) -> tuple:
    """What a run keeps of an answer: (true-metric calls, ids, distances);
    a tuple of numbers and arrays, which the garbage collector does not walk."""
    return answer.stats.original_calls, answer.ids, answer.distances


def _spec(mix: dict):
    from repro_torch.api import Query

    if (mix["task"], mix["mode"]) != ("knn", "exact"):
        raise ValueError(f"the harness runs exact k-NN mixes; got task {mix['task']!r}, mode {mix['mode']!r}")
    return Query.knn(int(mix["k"]))


def run_cell(cell: dict, *, seed: int, seconds: float, trace: bool, t_start: float, device: str = "cuda",
             sizes: Optional[dict] = None, wrap_index: Optional[Callable] = None) -> dict:
    """One run; returns the result object (the last line a run prints).

    ``sizes`` overrides the configuration's ``n_rows`` and the mix's
    ``query_pool`` / ``clients`` / ``check_sample`` (the CPU tests);
    ``wrap_index`` wraps the built index before the proxy (the tests plant
    faults there)."""
    import torch

    from portbench.reference import Reference
    from repro_torch.api import build_index
    from repro_torch.kernels import ops
    from repro_torch.launch.service import SearchService

    cfg = dict(cell["config_data"])
    mix = dict(cell["traffic_data"])
    sizes = sizes or {}
    cfg["n_rows"] = sizes.get("n_rows", cfg["n_rows"])
    for key in ("query_pool", "clients", "check_sample"):
        if key in sizes:
            mix[key] = sizes[key]
    on_card = device == "cuda"
    clients, pool = int(mix["clients"]), int(mix["query_pool"])
    metric = cfg["metric"]

    # -- set-up ------------------------------------------------------------------
    phases = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    corpus, queries = cell_data(cfg, mix, seed)
    warm_q, queries = queries[pool:], queries[:pool]
    spec = _spec(mix)
    phases["data"], t = time.perf_counter() - t, time.perf_counter()
    ix = cfg["index"]
    index = build_index(corpus, metric, kind=ix["kind"], n_pivots=ix["n_pivots"], pivot_strategy=ix["pivot_strategy"],
                        seed=ix["pivot_seed"], eps=ix["eps"], device=device)
    if wrap_index is not None:
        index = wrap_index(index)
    if on_card:
        torch.cuda.synchronize()
    phases["build"], t = time.perf_counter() - t, time.perf_counter()
    spans = Spans()
    proxy = IndexProxy(index, spans)
    service = SearchService(proxy, max_batch=cfg["service"]["max_batch"])
    submit = lambda q: service.submit(q, spec)  # noqa: E731
    for _ in range(2):
        for f in [submit(q) for q in warm_q]:
            f.result(timeout=600)
    tracer = Tracer(torch) if (trace and on_card) else None
    if tracer is not None:
        tracer.warm()
    if on_card:
        torch.cuda.synchronize()
    phases["warm"] = time.perf_counter() - t
    before = service.stats()
    over0 = _overflow(index)
    proxy.calls = proxy.rows = 0
    proxy.seconds = 0.0
    spans.by_label.clear()
    ops.reset_launches()
    setup_s = time.perf_counter() - t_start

    # -- the window ----------------------------------------------------------------
    traced = {}

    def on_open(t_open, t_close):
        if tracer is None:
            return
        t_from = max(t_open, t_close - float(mix["trace_seconds"]))
        time.sleep(max(0.0, t_from - time.perf_counter()))
        tracer.start()
        traced["a"] = _launch_snapshot(ops)
        time.sleep(max(0.0, t_close - time.perf_counter()))
        traced["b"] = _launch_snapshot(ops)
        tracer.stop()

    win = loop.closed_loop(submit, queries, clients=clients, seconds=seconds, digest=_digest, on_open=on_open)
    service.close()
    after = service.stats()
    summary = None
    if tracer is not None:
        for i in range(win.issued):
            spans.add("service", win.t_submit[i], min(win.t_done[i], win.t_close))
        summary = tracer.summary(spans, _launch_delta(traced["a"], traced["b"]))
    run = Run(cell=cell, n_rows=cfg["n_rows"], n_pivots=ix["n_pivots"], window=win,
              service={k: after[k] - before[k] for k in ("n_requests", "n_batches")},
              index={"calls": proxy.calls, "rows": proxy.rows, "seconds": proxy.seconds,
                     "overflow": None if over0 is None else _overflow(index) - over0},
              trace=summary)
    window = {"requests": win.issued, "batches": run.service["n_batches"],
              "index_s": proxy.seconds, "index_calls": proxy.calls, "index_rows": proxy.rows,
              "overflow": run.index["overflow"]}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"

    # -- metrics ---------------------------------------------------------------------
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if trace:
        for m in cell["per_layer"]:
            v = _reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics["qps"] = {"value": loop.qps(win), "unit": units["qps"]}
        metrics["p95_ms"] = {"value": loop.p95_ms(win), "unit": units["p95_ms"]}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}

    # -- free the program, then the check ---------------------------------------------
    answered = np.flatnonzero(win.ok[: win.issued])
    n_attempted = win.issued
    n_failed = n_attempted - len(answered)
    picks = answered[check.sample_positions(len(answered), int(mix["check_sample"]), seed)]
    answers = {int(i): win.kept[i][1:] for i in picks}
    del service, proxy, index, run, win
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.compare(mix, queries, answers, n_failed, Reference(corpus, metric, device=device))
    ref_s = time.perf_counter() - t_ref
    limits = cell["limits"]
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing} in limits/{cell['name']}.json")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    out = {
        "correct": bool(correct),
        "attempted": n_attempted,
        "failed": n_failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": int(peak)},
    }
    return {"out": out, "checks": checks, "ref_s": ref_s, "n_compared": len(answers),
            "trace": summary, "setup_phases": phases, "window": window}


def result_line(res: dict) -> str:
    out = dict(res["out"])
    if res["trace"] is not None:
        out["device"] = dict(out["device"], busy_s=res["trace"].busy_s, window_s=res["trace"].window_s)
        out["breakdown"] = res["trace"].breakdown()
    out["checks"] = res["checks"]
    return json.dumps(out)


def forbidden_loaded() -> List[str]:
    """Top-level names of forbidden modules loaded in this process (compared
    whole: ``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))

