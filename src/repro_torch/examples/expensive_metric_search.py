"""The paper's motivating case: exact search under an EXPENSIVE metric
(Jensen-Shannon) where the n-simplex surrogate pays for itself ~100x over.

    python -m repro_torch.examples.expensive_metric_search                # on the card
    python -m repro_torch.examples.expensive_metric_search --device cpu   # on the host

Shows the three-way decision ledger (exclude / admit-by-upper-bound /
recheck) and the metric-evaluation savings, plus the fused-bounds kernel
(K6, ``repro_torch.kernels.apex_bounds``) on the same table (the JAX
package's ``examples/expensive_metric_search.py``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.data import load_or_generate_colors
from repro_torch.examples.summary import f32_band, host_bounds, near, parse, range_margin, summary
from repro_torch.kernels import apex_bounds
from repro_torch.metrics import get_metric
from repro_torch.search import ExactSearchEngine


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    X = load_or_generate_colors(n=8_000, seed=7)
    data, queries = X[:7_500], X[7_500:7_520]
    metric = get_metric("jensen_shannon")

    t0 = time.perf_counter()
    eng = ExactSearchEngine(data, metric, n_pivots=16, seed=1, mechanisms=("N_seq",), device=dev)
    build_s = time.perf_counter() - t0

    q0 = torch.as_tensor(queries[0], device=dev)
    t_sample = float(np.quantile(metric.one_to_many(q0, eng.nsimplex.data[:2000]).cpu().numpy(), 2e-4))
    print(f"threshold t={t_sample:.4f} (sqrt-JSD, ~0.02% selectivity)\n")
    ledger = dict(excluded=0, admitted=0, rechecked=0, results=0)
    t0 = time.perf_counter()
    for q in queries:
        rep = eng.search("N_seq", q, t_sample)
        n = data.shape[0]
        rechecked = rep.original_calls - eng.nsimplex.n_pivots
        ledger["excluded"] += n - rep.accepted_no_check - rechecked
        ledger["admitted"] += rep.accepted_no_check
        ledger["rechecked"] += rechecked
        ledger["results"] += len(rep.results)
    dt = time.perf_counter() - t0
    total = len(queries) * data.shape[0]
    print(f"objects considered : {total}")
    for k, v in ledger.items():
        print(f"{k:18s} : {v} ({100 * v / total:.2f}%)" if k != "results" else f"{k:18s} : {v}")
    print(f"\nJSD evaluations avoided: {100 * (1 - (ledger['rechecked'] + 16 * len(queries)) / total):.1f}%")
    print(f"elapsed: {dt:.2f}s for {len(queries)} exact queries over {data.shape[0]} objects")

    # the same filter through the fused-bounds kernel K6 on the f32 table
    q_apex = eng.nsimplex.query_apex(queries[0])
    lwb, upb = apex_bounds(eng.nsimplex.table.to(torch.float32), q_apex.to(torch.float32))
    lwb, upb = lwb.cpu().numpy(), upb.cpu().numpy()
    dec = np.where(lwb > t_sample, "excl", np.where(upb <= t_sample, "admit", "recheck"))
    u, c = np.unique(dec, return_counts=True)
    decisions = dict(zip(u.tolist(), c.tolist()))
    print("\nfused-bounds kernel decisions:", decisions)

    # how far the f32 counts may move: decisions whose f64 bound lies in the
    # f32 band around t (the ledger over every query, K6 over query 0)
    table, apexes, lwb64, upb64 = host_bounds(eng.nsimplex, queries[:1])
    band = f32_band(table, apexes, t_sample)
    k6_margin = near(lwb64, t_sample, band) + near(upb64, t_sample, band)
    ledger_margin = range_margin(eng.nsimplex, queries, t_sample)
    return summary(
        exact={"objects": total, "results": ledger["results"], "last_query_ids": np.sort(rep.results).tolist()},
        close={"threshold": t_sample},
        counts={"excluded": ledger["excluded"], "admitted": ledger["admitted"], "rechecked": ledger["rechecked"],
                "k6_decisions": [decisions.get(k, 0) for k in ("excl", "admit", "recheck")]},
        margins={"excluded": ledger_margin, "admitted": ledger_margin, "rechecked": ledger_margin,
                 "k6_decisions": k6_margin},
        seconds={"build": build_s, "queries": dt},
    )


if __name__ == "__main__":
    main()
