"""Quickstart: the unified ``repro_torch.api`` pipeline end to end.

    python -m repro_torch.examples.quickstart                # on the card
    python -m repro_torch.examples.quickstart --device cpu   # on the host

Builds an n-simplex index over colors-like histogram data, answers exact
k-NN and threshold queries through the declarative ``Query`` surface every
mechanism shares, inspects the execution plan, and round-trips the index
through disk (the JAX package's ``examples/quickstart.py``).
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import Query, build_index, load_index
from repro_torch.data import load_or_generate_colors
from repro_torch.examples.summary import knn_margin, parse, range_margin, summary
from repro_torch.metrics import get_metric


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    X = load_or_generate_colors(n=10_000, seed=42)
    data, queries = X[:9_000], X[9_000:9_020]
    metric = get_metric("euclidean")
    seconds = {}

    # one factory call; kind in {"nsimplex", "laesa", "tree"}
    t0 = time.perf_counter()
    index = build_index(data, metric, kind="nsimplex", n_pivots=20, seed=0, device=dev)
    seconds["build"] = time.perf_counter() - t0

    # one declarative spec; a 2-D block answers as a BatchQueryResult
    knn_spec = Query(task="knn", k=10)
    t0 = time.perf_counter()
    batch = index.query(queries, knn_spec)
    seconds["knn"] = time.perf_counter() - t0
    frac = batch.metric_eval_fraction(len(data))

    # the plan is observable before (or without) running anything
    stages = [s["stage"] for s in index.plan(knn_spec).explain()["stages"]]

    # verify against brute force (in the corpus's dtype, as the reference)
    rows = index.data
    for q, res in zip(queries, batch):
        d = metric.one_to_many(torch.as_tensor(q, device=dev), rows).cpu().numpy()
        want = np.lexsort((np.arange(len(d)), d))[:10]
        assert np.array_equal(res.ids, want), "exactness violated!"

    # range (threshold) search through the same entry point; a 1-D query
    # answers as a single QueryResult
    d0 = metric.one_to_many(torch.as_tensor(queries[0], device=dev), rows[:2000]).cpu().numpy()
    t = float(np.quantile(d0, 1e-4))
    t0 = time.perf_counter()
    hits = index.query(queries[0], Query.range(t))
    seconds["threshold"] = time.perf_counter() - t0

    # declarative id filters stay exact: deny the top hit, the runner-up wins
    denied = index.query(queries[0], Query.knn(1, deny=(int(batch[0].ids[0]),)))
    assert denied.ids[0] == batch[0].ids[1]

    # save -> load -> identical results, no distance re-measured
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        index.save(f"{td}/colors.idx")
        reloaded = load_index(f"{td}/colors.idx", device=dev)
        again = reloaded.query(queries, knn_spec)
        assert all(np.array_equal(a.ids, b.ids) for a, b in zip(batch, again))
    seconds["save_load"] = time.perf_counter() - t0

    print(f"index              : {index.stats()}")
    print(f"plan               : {' -> '.join(stages)}")
    print(f"knn queries        : {len(batch)} x k=10 (all verified vs brute force)")
    print(f"true-metric evals  : {100 * frac:.2f}% of the table per query "
          f"(vs 100% brute force)")
    print(f"threshold hits     : {len(hits)} at t={t:.4f} "
          f"({hits.stats.accepted_no_check} admitted bound-only)")
    print("save/load          : round-trip verified (identical ids)")

    inner = index._inner
    threshold_margin = range_margin(inner, queries[:1], t)
    return summary(
        exact={"stats": index.stats(), "plan": stages, "knn_ids": [r.ids.tolist() for r in batch],
               "threshold_ids": sorted(hits.ids.tolist()), "denied_top1": int(denied.ids[0])},
        close={"threshold_f32": t, "knn_distances_f32": [r.distances.tolist() for r in batch]},
        counts={"knn_original_calls": batch.total_original_calls,
                "threshold_original_calls": hits.stats.original_calls,
                "threshold_admitted": hits.stats.accepted_no_check},
        margins={"knn_original_calls": knn_margin(inner, queries, [r.distances[-1] for r in batch], 10),
                 "threshold_original_calls": threshold_margin, "threshold_admitted": threshold_margin},
        seconds=seconds,
    )


if __name__ == "__main__":
    main()
