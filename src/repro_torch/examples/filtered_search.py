"""Filtered search: attribute predicates pushed into the exact pipeline.

    python -m repro_torch.examples.filtered_search                # on the card
    python -m repro_torch.examples.filtered_search --device cpu   # on the host

Builds an index with a columnar ``AttributeStore`` attached, answers
predicate-constrained k-NN through ``Query.where`` (exact under every
strategy), shows how the planner chooses and records the filter strategy,
carries attributes through online mutation, and round-trips the whole
thing — vectors AND attributes — through disk (the JAX package's
``examples/filtered_search.py``).
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.api import Query, build_index, load_index
from repro_torch.examples.summary import knn_margin, parse, summary
from repro_torch.filter import AttributeStore, Predicate
from repro_torch.metrics import get_metric


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    rng = np.random.default_rng(7)
    n, dim = 20_000, 16
    data = rng.normal(size=(n, dim))
    queries = rng.normal(size=(8, dim))
    metric = get_metric("euclidean")

    # one attribute row per vector, keyed by the same logical row ids
    ids = np.arange(n, dtype=np.int64)
    store = AttributeStore(
        {"price": "float", "category": "categorical", "in_stock": "bool"}
    )
    store.put(
        ids,
        {
            "price": rng.uniform(1.0, 500.0, size=n),
            "category": rng.choice(["book", "game", "tool"], size=n),
            "in_stock": rng.random(n) < 0.8,
        },
    )

    t0 = time.perf_counter()
    index = build_index(
        data, metric, kind="nsimplex", n_pivots=16, seed=0,
        mutable=True, attributes=store, device=dev,
    )
    build_s = time.perf_counter() - t0

    # predicates compose with &; ops: eq / isin / between (+ id allow/deny)
    pred = (
        Predicate.eq("category", "book")
        & Predicate.between("price", lo=10, hi=120)
        & Predicate.eq("in_stock", True)
    )
    spec = Query(task="knn", k=5, where=pred)

    # the planner picks prefilter / pushdown / postfilter from the store's
    # selectivity estimate; explain() records the decision deterministically
    plan = index.plan(spec).explain()
    stage = next(s for s in plan["stages"] if s["stage"] == "predicate_filter")

    t0 = time.perf_counter()
    res = index.query(queries[0], spec)
    query_s = time.perf_counter() - t0

    # exactness: identical to brute force over exactly the matching rows
    match = store.match(pred)
    d = metric.one_to_many(torch.as_tensor(queries[0], device=dev),
                           torch.as_tensor(data[match], device=dev)).cpu().numpy()
    want = match[np.lexsort((match, d))[:5]]
    assert np.array_equal(res.ids, want), "filtered search must stay exact"

    # a forced strategy returns the same answer (only the route changes)
    for mode in ("prefilter", "pushdown", "postfilter"):
        forced = index.query(queries[0], Query(task="knn", k=5, where=pred,
                                               filter_mode=mode))
        assert np.array_equal(forced.ids, res.ids), mode

    # how far the postfilter's count may move: its fetches' k-NN decisions
    # near their radius (fetch 2k, then doubling, until k rows match)
    d_all = metric.one_to_many(torch.as_tensor(queries[0], device=dev), index.data).cpu().numpy()
    order = np.argsort(d_all, kind="stable")
    d_all, in_match = d_all[order], np.isin(order, match)
    fetch, postfilter_margin = max(2 * 5, 5 + 16), 0
    while True:
        postfilter_margin += knn_margin(index._base._inner, queries[:1], [d_all[fetch - 1]], fetch)
        if in_match[:fetch].sum() >= 5 or fetch >= n:
            break
        fetch = min(n, 2 * fetch)

    # attributes ride along with online mutation
    new_ids = np.arange(n, n + 3, dtype=np.int64)
    index.add(
        rng.normal(size=(3, dim)),
        ids=new_ids,
        attrs={
            "price": [49.0, 52.0, 61.0],
            "category": ["book", "book", "tool"],
            "in_stock": [True, True, False],
        },
    )
    fresh = index.query(queries[0], Query(task="knn", k=5, where=pred))
    index.remove(new_ids)

    # save -> load round-trips the attribute store next to the vectors
    with tempfile.TemporaryDirectory() as td:
        index.save(f"{td}/products.idx")
        reloaded = load_index(f"{td}/products.idx", device=dev)
        again = reloaded.query(queries[0], spec)
        assert np.array_equal(res.ids, again.ids)

    print(f"matching rows      : {len(match)} / {n} "
          f"(estimated selectivity {stage['selectivity']:.4f})")
    print(f"chosen strategy    : {plan['filter']} "
          f"(columns {stage['columns']}, ~{stage['est_rows']} rows)")
    print(f"filtered top-5     : ids {res.ids.tolist()} (verified vs brute force)")
    print(f"after live insert  : ids {fresh.ids.tolist()}")
    print("save/load          : filtered results identical  OK")

    return summary(
        exact={"matching_rows": int(len(match)), "strategy": plan["filter"], "stage": stage,
               "top5": res.ids.tolist(), "after_insert": fresh.ids.tolist()},
        close={"top5_distances": res.distances.tolist()},
        counts={"original_calls": res.stats.original_calls,
                "postfilter_original_calls": forced.stats.original_calls},
        margins={"postfilter_original_calls": postfilter_margin},
        seconds={"build": build_s, "query": query_s},
    )


if __name__ == "__main__":
    main()
