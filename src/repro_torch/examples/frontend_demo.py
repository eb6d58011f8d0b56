"""Production front end demo: two tenants over a live HTTP/JSON boundary.

    python -m repro_torch.examples.frontend_demo                # on the card
    python -m repro_torch.examples.frontend_demo --device cpu   # on the host

Registers two named corpora in an ``IndexRegistry`` (each with its own
``SearchService``, admission controller, and telemetry, sharing one worker
budget), starts the stdlib-HTTP ``Frontend`` on an ephemeral port of
127.0.0.1, and exercises the serving stack end to end over the wire (the
JAX package's ``examples/frontend_demo.py``):

  * per-tenant k-NN answers bit-identical to direct in-process calls
    (tenant isolation — different corpora never share a fused batch),
  * per-request deadlines: an infeasible one is shed at admission
    (HTTP 429 + Retry-After) before it can waste a batch slot,
  * telemetry-calibrated planning: after a handful of served queries the
    planner's auto-mode cost estimate flips from the static 2% prior to
    the tenant's measured refine fraction (visible in ``explain()``),
  * hot tenant ops: PUT a saved index directory in as a new tenant, query
    it, DELETE it.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.api import Query, build_index
from repro_torch.data import load_or_generate_colors
from repro_torch.examples.summary import knn_margin, parse, summary
from repro_torch.metrics import get_metric
from repro_torch.serve import Frontend, FrontendClient, FrontendError, IndexRegistry


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    X = load_or_generate_colors(n=9_000, seed=42)
    metric = get_metric("jensen_shannon")     # expensive metric: fusion pays
    t0 = time.perf_counter()
    products = build_index(X[:6_000], metric, kind="nsimplex", n_pivots=16, seed=0, device=dev)
    reviews = build_index(X[6_000:8_500], metric, kind="nsimplex", n_pivots=16, seed=1, device=dev)
    build_s = time.perf_counter() - t0
    queries = np.asarray(X[8_500:], np.float64)   # float64: what JSON decodes to

    registry = IndexRegistry(max_concurrent_batches=4, max_wait_s=0.005, device=dev)
    registry.add("products", index=products)
    registry.add("reviews", index=reviews, rate=500.0)   # per-tenant rate cap
    spec = Query.knn(10)
    for name in registry.names():
        registry.tenant(name).warmup(spec, queries[0])

    exact, seconds = {}, {"build": build_s}
    t0 = time.perf_counter()
    with Frontend(registry, port=0) as fe:
        host, port = fe.address
        client = FrontendClient(host, port)
        exact["tenants"] = client.tenants()
        print(f"frontend           : http://{host}:{port} serving {client.tenants()}")

        # -- tenant isolation: answers bit-identical over the wire ----------
        for name, idx in (("products", products), ("reviews", reviews)):
            got = client.query(name, queries[0], k=10)
            want = idx.knn_batch(queries[:1], 10).results[0]
            assert got["ids"] == [int(i) for i in want.ids]
            assert got["distances"] == [float(d) for d in want.distances]
            exact[f"{name}_ids"] = got["ids"]
        print("isolation          : per-tenant HTTP answers == direct Index.query")

        # -- deadlines: infeasible ones are shed cheaply at admission -------
        client.query("products", queries[1], k=10)        # warm the wait EWMA
        try:
            client.query("products", queries[2], k=10, deadline_ms=0.05)
        except FrontendError as e:
            seconds["deadline_shed_status"] = e.status
            print(
                f"deadline shed      : HTTP {e.status} ({e.body['reason']}), "
                f"retry after {e.retry_after_s:.3f}s — never queued"
            )

        # -- telemetry calibrates the planner -------------------------------
        for q in queries[3:19]:                           # warm past min_samples
            client.query("products", q, k=10)
        cal = products.plan(Query.knn(10, budget=100_000)).explain()["calibration"]
        print(
            f"calibrated planner : prior {cal['prior_evals']} evals -> measured "
            f"{cal['calibrated_evals']} evals (source: {cal['source']})"
        )

        # -- hot tenant ops over HTTP ---------------------------------------
        with tempfile.TemporaryDirectory() as tmp:
            saved = f"{tmp}/products_idx"
            products.save(saved)
            client.add_tenant("products-v2", saved, budget=50_000)
            got = client.query("products-v2", queries[0], k=10)
            assert got["ids"] == [
                int(i) for i in products.knn_batch(queries[:1], 10).results[0].ids
            ]
            client.remove_tenant("products-v2")
            exact["tenants_after"] = client.tenants()
            print(f"hot add/remove     : products-v2 served and retired, "
                  f"tenants now {client.tenants()}")

        st = client.stats()
        for name in sorted(st["tenants"]):
            ts = st["tenants"][name]
            seconds[f"{name}_requests"] = ts["service"]["n_requests"]
            seconds[f"{name}_p50_ms"] = ts["service"]["latency_p50_ms"]
            print(
                f"tenant {name:<12}: {ts['service']['n_requests']} requests, "
                f"p50 {ts['service']['latency_p50_ms']:.1f} ms, "
                f"shed {ts['admission']['rejected']}, "
                f"degraded {ts['admission']['degraded']}"
            )
    seconds["served"] = time.perf_counter() - t0

    exact.update(prior_evals=cal["prior_evals"], calibration_source=cal["source"])
    served = np.concatenate([queries[:2], queries[3:19]])   # what products' telemetry measured
    return summary(
        exact=exact,
        counts={"calibrated_evals": cal["calibrated_evals"]},
        margins={"calibrated_evals": knn_margin(products._inner, served,
                                                [r.distances[-1] for r in products.knn_batch(served, 10)], 10)},
        seconds=seconds,
    )


if __name__ == "__main__":
    main()
