"""The quality dial: truncated-apex approximate search end to end.

    python -m repro_torch.examples.quality_tradeoff                # on the card
    python -m repro_torch.examples.quality_tradeoff --device cpu   # on the host

One fitted n-simplex index serves the whole exact-to-approximate spectrum:
``apex_dims`` truncates the surrogate to k of n dimensions (bounds stay
sound and tighten monotonically in k — the paper's Lemma 2), ``refine``
budgets the true-metric re-rank.  This sweeps k and prints the measured
recall / cost / band-width trade-off, then shows the per-call overrides and
that the config survives persistence (the JAX package's
``examples/quality_tradeoff.py``, whose work runs at import; here it runs
in ``main()``).
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import build_index, load_index
from repro_torch.data import colors_like
from repro_torch.examples.summary import approx_knn_margin, approx_range_margin, parse, summary
from repro_torch.index.knn import knn_select
from repro_torch.metrics import get_metric

N, N_PIVOTS, K = 8000, 32, 10


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    X = colors_like(n=N + 64, seed=7).astype(np.float64)
    data, queries = X[:N], X[N:]
    metric = get_metric("euclidean")

    # one build, apex_dims fixes the default quality point -----------------
    t0 = time.perf_counter()
    index = build_index(
        data, metric, kind="nsimplex", n_pivots=N_PIVOTS,
        apex_dims=N_PIVOTS // 2, refine=64, seed=0, device=dev,
    )
    build_s = time.perf_counter() - t0
    print(f"built: {index.stats()}")

    rows = index.data
    D = metric.cross(torch.as_tensor(queries, device=dev), rows).cpu().numpy()
    oracle = [knn_select(d, np.arange(N, dtype=np.int64), K)[0] for d in D]

    sweep = {"dims": [], "hits": [], "evals_per_query": [], "band_width": []}
    t0 = time.perf_counter()
    print(f"\n{'dims':>5} {'recall@10':>10} {'evals/query':>12} {'band width':>11} {'bytes/obj':>10}")
    for dims in (N_PIVOTS // 8, N_PIVOTS // 4, N_PIVOTS // 2, N_PIVOTS):
        batch = index.knn_batch(queries, K, mode="approx", dims=dims, refine=64)
        hits = sum(
            len(np.intersect1d(r.ids, o)) for r, o in zip(batch, oracle)
        )
        recall = hits / (K * len(queries))
        evals = batch.total_original_calls / len(queries)
        width = float(np.mean([r.stats.bound_width for r in batch]))
        print(f"{dims:>5} {recall:>10.3f} {evals:>12.1f} {width:>11.4f} {dims * 8:>10}")
        for key, v in zip(sweep, (dims, hits, evals, width)):
            sweep[key].append(v)
    sweep_s = time.perf_counter() - t0

    # the same index still answers exactly on demand -----------------------
    exact = index.knn(queries[0], K, mode="exact")
    approx = index.knn(queries[0], K)              # default = the build's dial
    print(f"\nexact ids   : {exact.ids.tolist()}")
    print(f"approx ids  : {approx.ids.tolist()}  (approx={approx.approx})")

    # approximate threshold search: sound outside the straddle band --------
    t = float(np.quantile(D[0], 0.005))
    hit = index.search(queries[0], t)              # approx by default
    print(
        f"threshold {t:.4f}: {len(hit)} results, "
        f"{hit.stats.accepted_no_check} admitted bound/estimate-only, "
        f"band width {hit.stats.bound_width:.4f}"
    )

    # the truncation config is part of the versioned persistence -----------
    with tempfile.TemporaryDirectory() as td:
        index.save(f"{td}/quality.idx")
        loaded = load_index(f"{td}/quality.idx", device=dev)
        assert np.array_equal(loaded.knn(queries[0], K).ids, approx.ids)
    print(f"reloaded approx config: {loaded.approx} (identical results, no re-measure)")

    inner = index._inner
    threshold_margin = approx_range_margin(inner, queries[:1], t, N_PIVOTS // 2)
    return summary(
        exact={"stats": index.stats(), "dims": sweep["dims"], "evals_per_query": sweep["evals_per_query"],
               "exact_ids": exact.ids.tolist(), "approx_ids": approx.ids.tolist(), "approx": approx.approx,
               "reloaded_approx": loaded.approx},
        close={"threshold": t},
        counts={"hits": sweep["hits"], "threshold_results": len(hit),
                "threshold_admitted": hit.stats.accepted_no_check},
        margins={"hits": [approx_knn_margin(inner, queries, d, 64) for d in sweep["dims"]],
                 "threshold_results": threshold_margin, "threshold_admitted": threshold_margin},
        seconds={"build": build_s, "sweep": sweep_s},
    )


if __name__ == "__main__":
    main()
