"""Tuning the bound-scan kernel's launch plan and using the fused top-k
epilogue.

    python -m repro_torch.examples.kernel_tuning                # on the card
    python -m repro_torch.examples.kernel_tuning --device cpu   # on the host

Walkthrough of the two kernel-side subsystems behind batched serving (the
JAX package's ``examples/kernel_tuning.py``, whose work runs at import;
here it runs in ``main()``):

1. ``kernels.tuning`` — sweep K1's launch plans on a representative
   problem, watch every candidate get validated against the plain version
   before it is timed, and persist the winner in an on-disk cache (here a
   temporary one, removed at the end).
2. ``ops.apex_bounds_topk`` — the fused selection epilogue (K2): top-k
   candidates straight out of the scan (O(Q*k) host traffic),
   bit-identical to dense bounds (K1) + host-side selection.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import build_index
from repro_torch.data import colors_like
from repro_torch.examples.summary import f32_band, host_bounds, parse, summary
from repro_torch.kernels import ops, tuning


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    # -- a small real problem: colors data through the n-simplex projector ---
    X = colors_like(n=2_100, seed=7).astype(np.float64)
    data, queries = X[:2_000], X[2_000:2_016]
    index = build_index(data, "euclidean", kind="nsimplex", n_pivots=16, seed=0, device=dev)
    inner = index._inner
    table = inner._kernel_table()                      # (N, n) f32 apex table
    apexes = inner.query_apex_batch(queries).to(torch.float32)

    # -- 1. tune: sweep, validate, time, persist ------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        cache_path = os.path.join(td, "kernel_tuning.json")
        cache = tuning.TuningCache(cache_path)
        winner, report = tuning.autotune(
            table,
            apexes,
            kernel="apex_bounds_batch",
            candidates=tuning.candidate_space(table.shape[0], apexes.shape[0], quick=True),
            cache=cache,
        )
        print(f"swept {len(report)} candidates; winner: {winner}")
        for row in report:
            flag = "ok " if row["valid"] else "BAD"
            print(f"  [{flag}] plan={row['plan']:<6} {row.get('us_per_call', float('nan')):9.1f} us")

        # the winner is now served by lookup(); the K1-K3 wrappers consult
        # the cache at $REPRO_TORCH_KERNEL_TUNE_CACHE (else the default path
        # below) for tensors on the card when no private _plan is passed, so
        # the launches below take that cache's plans, not this one's
        tuning.reset_lookup_memo()
        cached = tuning.lookup("apex_bounds_batch", table.shape[1], None, torch.float32, path=cache_path)
        print(f"lookup() -> {cached} (cache: {cache_path})")
    tuning.reset_lookup_memo()
    tune_s = time.perf_counter() - t0
    print(f"(the real cache default: {tuning.default_cache_path()}; "
          f"override with ${tuning.CACHE_ENV_VAR})")

    # -- 2. fused top-k epilogue ----------------------------------------------
    k = 5
    ids, lwb, upb = (t.cpu().numpy() for t in ops.apex_bounds_topk(table, apexes, k, key="mid"))
    print(f"\nfused top-{k}: ids {ids.shape}, bounds {lwb.shape} — O(Q*k) host traffic")

    # bit-identical to dense bounds + host-side (key, id) selection
    dl, du = (t.cpu().numpy() for t in ops.apex_bounds_batch(table, apexes))
    mid = 0.5 * (dl + du)
    for q in range(apexes.shape[0]):
        want = np.lexsort((np.arange(table.shape[0]), mid[q]))[:k]
        assert np.array_equal(ids[q], want)
    print("fused selection == host lexsort selection for every query")

    # the same epilogue is what index.knn_batch rides — exact answers, no
    # (Q, N) bound matrix on host
    batch = index.knn_batch(queries, k=k, mode="exact")
    print(f"knn_batch top-1 ids: {[int(r.ids[0]) for r in batch[:8]]} ...")

    # the fused ids hang on f32 mid keys: a query whose k + 1 smallest f64
    # mid keys lie closer than the f32 band may order them another way in
    # another package or on another device
    tab64, ap64, l64, u64 = host_bounds(inner, queries)
    head = torch.sort(0.5 * (l64 + u64), dim=1).values[:, :k + 1].numpy()
    band = f32_band(tab64, ap64, head[:, k])
    unsettled = np.flatnonzero((np.diff(head, axis=1) <= 2.0 * band[:, None]).any(axis=1)).tolist()
    return summary(
        exact={"fused_ids": ids.tolist(), "knn_ids": [r.ids.tolist() for r in batch],
               "knn_top1": [int(r.ids[0]) for r in batch[:8]]},
        close={"knn_distances": [r.distances.tolist() for r in batch]},
        margins={"fused_ids": unsettled},
        seconds={"tune": tune_s},
    )


if __name__ == "__main__":
    main()
