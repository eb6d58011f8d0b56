#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

It needs a CUDA device and the repository checkout around it, builds the
CUDA kernels from ``src/repro_torch/kernels/csrc`` and fails (exit code not
0, no result line) on any fault.  One JSON line per phase:

  1. device   — ``nvidia-smi`` name and power limit, torch/CUDA versions,
                kernel build time;
  2. kernels  — each bound-scan kernel against its plain PyTorch version on
                the card at the main path's shapes (Q = 64 query apexes,
                N = 1,000,000 rows, n = 20 pivots, f32, k = 10, cap = 4096)
                plus smaller calls with ``dims``, ``key="mid"``, ``rowmask``
                and f64; K1/K6 within rtol = atol = 2e-5 (f32) or 1e-12
                (f64), K2/K3 exactly equal to a host lexsort and count over
                K1's own f32 matrices; CUDA-event times of kernel and plain;
  3. e2e      — the main path through the public entry points:
                ``build_index(colors_like(n=1_000_000, dim=112), metric,
                n_pivots=20)`` on ``cuda`` for euclidean and jensen_shannon,
                64-query k-NN and range batches, a range batch that overflows
                K3's capacity, 1-D requests, and 256 requests through
                ``SearchService(max_batch=64)``; answers of >= 8 queries per
                task held to a brute-force f64 scan on the card;
  4. kernels  — ``{"kernels": [...]}``: launches of each kernel during phase
                3 (each must be > 0), error, times and bounds;
then the card's ``nvidia-smi`` line, and last the device contract line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 20170726
N_ROWS, DIM, N_PIVOTS = 1_000_000, 112, 20
Q, K, CAP = 64, 10, 4096
#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
#: FLOP/s outside the tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
F32_TOL, F64_TOL = 2e-5, 1e-12
SENTINEL = 2**31 - 1
KERNEL_INFO = {
    "apex_bounds_batch": ("K1", "src/repro_torch/kernels/csrc/apex_bounds_batch.cu",
                          "src/repro/kernels/apex_bounds_batch.py:205"),
    "apex_topk": ("K2", "src/repro_torch/kernels/csrc/select_epilogue.cu",
                  "src/repro/kernels/select_epilogue.py:236"),
    "apex_threshold": ("K3", "src/repro_torch/kernels/csrc/select_epilogue.cu",
                       "src/repro/kernels/select_epilogue.py:293"),
    "apex_bounds": ("K6", "src/repro_torch/kernels/csrc/apex_bounds.cu",
                    "src/repro/kernels/apex_bounds.py:45"),
}


def emit(**fields):
    print(json.dumps(fields), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=10) -> float:
    """Mean CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(Q_, N_, n_, itemsize, out_bytes, flops_per_s):
    """(bound_ms, bound_by): bytes moved (inputs read once, outputs written
    once) over the HBM rate against ~2(n-1) + 12 operations per pair."""
    bytes_ = (N_ * n_ + Q_ * n_) * itemsize + out_bytes
    ops = Q_ * N_ * (2 * (n_ - 1) + 12)
    t_bytes, t_ops = bytes_ / HBM_BPS * 1e3, ops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want, tol):
    """max |got - want|, asserting |got - want| <= tol + tol * |want|."""
    diff = (got - want).abs()
    check(bool((diff <= tol + tol * want.abs()).all()), f"kernel disagrees with plain beyond {tol}")
    return float(diff.max())


def host_select(keys: np.ndarray, live, width: int) -> np.ndarray:
    """Per query the ``width`` smallest (key, id) among live rows by
    ``np.lexsort``, sentinel-padded: the host reference of K2/K3."""
    out = np.full((keys.shape[0], width), SENTINEL, dtype=np.int64)
    for q in range(keys.shape[0]):
        ids = np.arange(keys.shape[1]) if live is None else np.flatnonzero(live[q])
        kq = keys[q, ids]
        if kq.shape[0] > width:
            keep = kq <= np.partition(kq, width - 1)[width - 1]
            ids, kq = ids[keep], kq[keep]
        order = np.lexsort((ids, kq))[:width]
        out[q, : order.shape[0]] = ids[order]
    return out


def check_selection(ids, lwb, upb, want, L, U):
    """Kernel selection == host selection, bounds == K1's at those ids."""
    ids, lwb, upb = (t.cpu().numpy() for t in (ids, lwb, upb))
    check(np.array_equal(ids.astype(np.int64), want), "selection ids differ from host lexsort")
    real = want != SENTINEL
    rows = np.nonzero(real)
    check(np.array_equal(lwb[real], L[rows[0], want[real]]), "selected lwb differs from K1")
    check(np.array_equal(upb[real], U[rows[0], want[real]]), "selected upb differs from K1")
    check(bool(np.all(np.isinf(lwb[~real]))), "empty slots must carry +inf")


def phase_kernels(torch, ops, ref, tab32, ap32):
    """Each kernel against its plain version at the main path's shapes."""
    dev = tab32.device
    N_, n_ = tab32.shape
    rng = np.random.default_rng(SEED)
    tab64, ap64 = tab32.double(), ap32.double()
    small = ap32[:16]
    mask_np = rng.random(N_) < 0.5
    mask = torch.as_tensor(mask_np, device=dev)
    out = {}

    # K1: the main call, a dims call, an f64 call
    L_t, U_t = ops.apex_bounds_batch(tab32, ap32)
    Lr, Ur = ref.apex_bounds_batch_ref(tab32, ap32, n_)
    err = max(max_err(torch, L_t, Lr, F32_TOL), max_err(torch, U_t, Ur, F32_TOL))
    del Lr, Ur
    for args, dims, tol in (((tab32, small), 7, F32_TOL), ((tab64, ap64[:16]), None, F64_TOL)):
        got = ops.apex_bounds_batch(*args, dims=dims)
        want = ref.apex_bounds_batch_ref(*args, dims or n_)
        err_i = max(max_err(torch, got[0], want[0], tol), max_err(torch, got[1], want[1], tol))
        emit(phase="kernels", kernel="K1", dims=dims, dtype=str(args[0].dtype), max_abs_err=err_i)
    ms = time_ms(torch, lambda: ops.apex_bounds_batch(tab32, ap32))
    plain_ms = time_ms(torch, lambda: ref.apex_bounds_batch_ref(tab32, ap32, n_), reps=3)
    out["apex_bounds_batch"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, shape=[Q, N_, n_],
        bound=bound(Q, N_, n_, 4, 2 * Q * N_ * 4, F32_FLOPS),
    )
    emit(phase="kernels", kernel="K1", dims=None, dtype="torch.float32", max_abs_err=err, ms=ms, plain_ms=plain_ms)

    L, U = L_t.cpu().numpy(), U_t.cpu().numpy()
    del L_t, U_t

    # K2: the main call (key="upb", k=10), then key="mid" with dims and rowmask
    ids, lwb, upb = ops.apex_bounds_topk(tab32, ap32, K, key="upb")
    check_selection(ids, lwb, upb, host_select(U, None, K), L, U)
    Ls, Us = (t.cpu().numpy() for t in ops.apex_bounds_batch(tab32, small, dims=7))
    mid = np.float32(0.5) * (Ls + Us)
    ids, lwb, upb = ops.apex_bounds_topk(tab32, small, 100, key="mid", dims=7, rowmask=mask)
    check_selection(ids, lwb, upb, host_select(mid, np.broadcast_to(mask_np, mid.shape), 100), Ls, Us)
    ms = time_ms(torch, lambda: ops.apex_bounds_topk(tab32, ap32, K, key="upb"))
    plain_ms = time_ms(torch, lambda: ref.apex_topk_ref(tab32, ap32, K, "upb", n_), reps=3)
    out["apex_topk"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, shape=[Q, N_, n_, K],
        bound=bound(Q, N_, n_, 4, Q * K * 12, F32_FLOPS),
    )
    emit(phase="kernels", kernel="K2", exact=True, ms=ms, plain_ms=plain_ms)

    # K3: thresholds at per-query ranks below, at and above the capacity
    ranks = np.array([100, 2000, CAP, 20000])[np.arange(Q) % 4]
    thr = np.array([np.partition(L[q], r - 1)[r - 1] for q, r in enumerate(ranks)], dtype=np.float32)
    thr_t = torch.as_tensor(thr, device=dev)
    ids, lwb, upb, counts = ops.apex_bounds_threshold(tab32, ap32, thr_t, CAP)
    hit = L <= thr[:, None]
    check(np.array_equal(counts.cpu().numpy(), hit.sum(axis=1)), "K3 counts differ from host count")
    check(bool((counts.cpu().numpy() > CAP).any()), "K3 check must include an overflowing query")
    check_selection(ids, lwb, upb, host_select(L, hit, CAP), L, U)
    thr_s = thr_t[:16]
    ids, lwb, upb, counts = ops.apex_bounds_threshold(tab32, small, thr_s, 512, dims=7, rowmask=mask)
    hit_s = (Ls <= thr[:16, None]) & mask_np[None, :]
    check(np.array_equal(counts.cpu().numpy(), hit_s.sum(axis=1)), "K3 masked counts differ")
    check_selection(ids, lwb, upb, host_select(Ls, hit_s, 512), Ls, Us)
    ms = time_ms(torch, lambda: ops.apex_bounds_threshold(tab32, ap32, thr_t, CAP))
    plain_ms = time_ms(torch, lambda: ref.apex_threshold_ref(tab32, ap32, thr_t, CAP, n_), reps=3)
    out["apex_threshold"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, shape=[Q, N_, n_, CAP],
        bound=bound(Q, N_, n_, 4, Q * (CAP * 12 + 4), F32_FLOPS),
    )
    emit(phase="kernels", kernel="K3", exact=True, overflowing_queries=int((hit.sum(1) > CAP).sum()),
         ms=ms, plain_ms=plain_ms)
    del L, U, Ls, Us

    # K6: one query, f32 and f64
    errs = []
    for t_, q_, tol in ((tab32, ap32[0], F32_TOL), (tab64, ap64[0], F64_TOL)):
        got, want = ops.apex_bounds(t_, q_), ref.apex_bounds_ref(t_, q_)
        errs.append(max(max_err(torch, got[0], want[0], tol), max_err(torch, got[1], want[1], tol)))
    ms = time_ms(torch, lambda: ops.apex_bounds(tab32, ap32[0]))
    plain_ms = time_ms(torch, lambda: ref.apex_bounds_ref(tab32, ap32[0]))
    out["apex_bounds"] = dict(
        max_abs_err=errs[0], ms=ms, plain_ms=plain_ms, shape=[1, N_, n_],
        bound=bound(1, N_, n_, 4, 2 * N_ * 4, F32_FLOPS),
    )
    emit(phase="kernels", kernel="K6", max_abs_err_f32=errs[0], max_abs_err_f64=errs[1], ms=ms, plain_ms=plain_ms)
    return out


class BruteForce:
    """Float64 scan of the whole corpus on the card: the e2e reference."""

    def __init__(self, torch, data, metric):
        self.torch, self.metric = torch, metric
        self.data64 = data.double()

    def dists(self, q):
        return self.metric.one_to_many(self.torch.as_tensor(q, device=self.data64.device).double(), self.data64)

    def knn(self, q, k):
        d = self.dists(q)
        order = self.torch.sort(d, stable=True).indices[:k]     # ties by ascending id
        return order.cpu().numpy(), d.cpu().numpy()

    def range(self, q, t):
        d = self.dists(q)
        return self.torch.nonzero(d <= t).flatten().cpu().numpy(), d.cpu().numpy()


def agree_knn(res, want_ids, d64, tol):
    """Ids and tie order equal to brute force; with a float32 refine
    (Euclidean on a float32 corpus) ids may swap only between rows whose
    f64 distances agree within ``tol``.  Returns the number of such swaps."""
    got = res.ids
    check(len(got) == len(want_ids), "k-NN result has the wrong length")
    check(bool(np.allclose(res.distances, d64[got], rtol=tol, atol=tol)), "k-NN distances differ")
    swaps = int((got != want_ids).sum())
    check(bool(np.allclose(d64[got], d64[want_ids], rtol=tol, atol=tol)), "k-NN ids differ from brute force")
    return swaps


def agree_range(res, want_ids, d64, t, tol):
    diff = np.setxor1d(res.ids, want_ids)
    check(bool(np.all(np.abs(d64[diff] - t) <= tol * max(t, 1.0))), "range ids differ from brute force")
    return int(diff.shape[0])


def phase_e2e(torch, api, metrics_mod, service_mod, data_np, queries_np, metric_name, index=None):
    """The main path for one metric, through the public entry points."""
    report = lambda **f: emit(phase="e2e", metric=metric_name, **f)  # noqa: E731
    if index is None:
        t0 = time.perf_counter()
        index = api.build_index(data_np, metric_name, n_pivots=N_PIVOTS, seed=SEED % 1000, device="cuda")
        torch.cuda.synchronize()
        report(task="build", rows=N_ROWS, wall_s=time.perf_counter() - t0)
    inner = index._inner
    data = inner.data
    brute = BruteForce(torch, data, metrics_mod.get_metric(metric_name))
    # f32 corpus + Euclidean refines in f32: compare at f32 resolution
    tol = 1e-5 if (metric_name == "euclidean" and data.dtype == torch.float32) else F64_TOL
    swaps = 0

    def run(task, spec, qs):
        before = inner.overflow_queries
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = index.query(qs, spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results = [res] if qs.ndim == 1 else list(res)
        report(task=task, queries=len(results), wall_ms=wall * 1e3,
               original_calls_per_query=float(np.mean([r.stats.original_calls for r in results])),
               overflow_queries=inner.overflow_queries - before)
        return results

    api_q = api.Query
    for b in range(2):
        qs = queries_np[b * Q:(b + 1) * Q]
        results = run("knn_batch", api_q.knn(K), qs)
        for q, r in zip(qs[:8], results[:8]):
            ids, d64 = brute.knn(q, K)
            swaps += agree_knn(r, ids, d64, tol)
    sample = brute.dists(queries_np[0]).cpu().numpy()
    t_range = float(np.sort(sample)[99])                         # ~100th-neighbour distance
    t_over = float(np.sort(sample)[3 * CAP])                      # overflows K3's capacity
    for b in range(2):
        qs = queries_np[b * Q:(b + 1) * Q]
        results = run("range_batch", api_q.range(t_range), qs)
        for q, r in zip(qs[:8], results[:8]):
            ids, d64 = brute.range(q, t_range)
            swaps += agree_range(r, ids, d64, t_range, tol)
    qs = queries_np[:8]
    results = run("range_overflow_batch", api_q.range(t_over), qs)
    check(inner.overflow_queries > 0, "the overflow batch must take the per-query K1 route")
    for q, r in zip(qs, results):
        ids, d64 = brute.range(q, t_over)
        swaps += agree_range(r, ids, d64, t_over, tol)
    for q in queries_np[:8]:
        r = run("knn_1d", api_q.knn(K), q)[0]
        ids, d64 = brute.knn(q, K)
        swaps += agree_knn(r, ids, d64, tol)
        r = run("range_1d", api_q.range(t_range), q)[0]
        ids, d64 = brute.range(q, t_range)
        swaps += agree_range(r, ids, d64, t_range, tol)

    served = queries_np[:256]
    spec = api_q.knn(K)
    with service_mod.SearchService(index, max_batch=64, max_wait_s=0.005) as svc:
        svc.warmup(spec, served[0])
        t0 = time.perf_counter()
        futures = [svc.submit(q, spec) for q in served]
        results = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        st = svc.stats()
    direct = index.query(served, spec)
    for r, w in zip(results, direct):
        check(np.array_equal(r.ids, w.ids) and np.array_equal(r.distances, w.distances),
              "served results differ from a direct batch")
    for q, r in zip(served[:8], results[:8]):
        ids, d64 = brute.knn(q, K)
        swaps += agree_knn(r, ids, d64, tol)
    report(task="service_knn", requests=len(served), wall_ms=wall * 1e3,
           latency_p50_ms=st["latency_p50_ms"], latency_p99_ms=st["latency_p99_ms"],
           mean_batch_occupancy=st["mean_batch_occupancy"], n_batches=st["n_batches"],
           original_calls_per_query=float(np.mean([r.stats.original_calls for r in results])),
           near_tie_differences=swaps)
    return index


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import api, metrics as metrics_mod
    from repro_torch.data import colors_like
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import service as service_mod

    smi = nvidia_smi()
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    t0 = time.perf_counter()
    build.library()
    emit(phase="build", seconds=time.perf_counter() - t0, nvcc_flags=list(build.NVCC_FLAGS))

    t0 = time.perf_counter()
    X = colors_like(n=N_ROWS + 256, dim=DIM, seed=SEED)
    data_np, queries_np = X[:N_ROWS], X[N_ROWS:]
    emit(phase="data", rows=N_ROWS, dim=DIM, dtype=str(X.dtype), wall_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    euclid = api.build_index(data_np, "euclidean", n_pivots=N_PIVOTS, seed=SEED % 1000, device="cuda")
    torch.cuda.synchronize()
    emit(phase="e2e", metric="euclidean", task="build", rows=N_ROWS, wall_s=time.perf_counter() - t0)

    inner = euclid._inner
    ap32 = inner.query_apex_batch(queries_np[:Q]).float().contiguous()
    measured = phase_kernels(torch, ops, ref, inner._kernel_table(), ap32)

    ops.reset_launches()
    phase_e2e(torch, api, metrics_mod, service_mod, data_np, queries_np, "euclidean", index=euclid)
    del euclid, inner
    torch.cuda.empty_cache()
    phase_e2e(torch, api, metrics_mod, service_mod, data_np, queries_np, "jensen_shannon")
    launches = dict(ops.LAUNCHES)

    rows = []
    for name, (kid, source, replaces) in KERNEL_INFO.items():
        m = measured[name]
        check(launches[name] > 0, f"{kid} ({name}) was not launched by the main path")
        rows.append({
            "name": f"{kid} {name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
            "library_ms": None, "shape": m["shape"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
