"""Micro-batched serving demo: SearchService over the Query plan API.

    python -m repro_torch.examples.service_demo                # on the card
    python -m repro_torch.examples.service_demo --device cpu   # on the host

Independent clients fire single-query requests at a ``SearchService``; the
runtime coalesces equal-spec arrivals into fused micro-batches (one plan,
one fused pivot-distance + projection + bounds pass per batch), resolves
each request's future, and exposes latency/occupancy counters.  Every
answer is verified bit-identical to the direct batched call — coalescing
changes cost, never semantics (the JAX package's
``examples/service_demo.py``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import Query, build_index
from repro_torch.data import load_or_generate_colors
from repro_torch.examples.summary import knn_margin, parse, summary
from repro_torch.launch.service import SearchService, run_poisson_open_loop
from repro_torch.metrics import get_metric


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    X = load_or_generate_colors(n=8_000, seed=42)
    data, queries = X[:7_500], X[7_500:7_756]
    metric = get_metric("jensen_shannon")     # expensive metric: fusion pays
    t0 = time.perf_counter()
    index = build_index(data, metric, kind="nsimplex", n_pivots=16, seed=0, device=dev)
    build_s = time.perf_counter() - t0

    spec = Query.knn(10)
    stages = index.plan(spec).explain()["stages"]
    print(f"plan: {stages}")
    index.query(queries[:8], spec)            # warm the scan paths once

    # a burst of concurrent clients -> one fused batch
    with SearchService(index, max_batch=64, max_wait_s=0.05) as service:
        futures = [service.submit(q, spec) for q in queries[:32]]
        burst = [f.result() for f in futures]
        st = service.stats()
    direct = index.query(queries[:32], spec)
    assert all(
        np.array_equal(a.ids, b.ids) and np.array_equal(a.distances, b.distances)
        for a, b in zip(burst, direct)
    )
    burst_batches, burst_occupancy = st["n_batches"], st["mean_batch_occupancy"]
    print(
        f"burst of 32        : {st['n_batches']} fused batch(es), "
        f"occupancy {st['mean_batch_occupancy']:.0f}, "
        f"results bit-identical to direct knn_batch"
    )

    # an open-loop Poisson stream (requests keep arriving regardless of
    # completions — queueing shows up in the latency tail, not back-pressure);
    # warmup() runs the padded bucket shapes once before traffic arrives
    with SearchService(index, max_batch=128, max_wait_s=0.002) as service:
        service.warmup(spec, queries[0])
        run_poisson_open_loop(service, queries, spec, arrival_rate=600.0, seed=7)
        st = service.stats()
    print(
        f"poisson @600/s     : {st['n_requests']} requests in "
        f"{st['n_batches']} batches (mean occupancy "
        f"{st['mean_batch_occupancy']:.1f}), {st['qps']:.0f} QPS"
    )
    print(
        f"latency            : p50 {st['latency_p50_ms']:.1f} ms, "
        f"p99 {st['latency_p99_ms']:.1f} ms"
    )

    return summary(
        exact={"plan": stages, "burst_batches": burst_batches, "burst_occupancy": burst_occupancy,
               "burst_ids": [r.ids.tolist() for r in direct], "poisson_requests": st["n_requests"]},
        close={"burst_distances": [r.distances.tolist() for r in direct]},
        counts={"direct_original_calls": direct.total_original_calls},
        margins={"direct_original_calls": knn_margin(index._inner, queries[:32],
                                                     [r.distances[-1] for r in direct], 10)},
        seconds={"build": build_s, "qps": st["qps"], "latency_p50_ms": st["latency_p50_ms"],
                 "latency_p99_ms": st["latency_p99_ms"], "poisson_batches": st["n_batches"]},
    )


if __name__ == "__main__":
    main()
