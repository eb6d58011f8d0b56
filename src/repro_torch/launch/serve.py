"""Serving CLI: the paper's pipeline as a service loop, on PyTorch.

    python -m repro_torch.launch.serve --n-objects 20000 --queries 64
    python -m repro_torch.launch.serve --engine batch --workload frontend --device cpu

The JAX package's ``python -m repro.launch.serve`` with every flag and
workload, plus ``--device`` ("cuda" by default: without a card it raises,
it never falls back to the CPU; "cpu" runs the plain PyTorch path).  The
printed lines keep the reference's words.

Build phase (offline): sample the corpus, pick pivots, fit the projector,
compute the apex table (pivot distances through K5 for JSD, the projection
through K4), split it over the device grid.  Serve phase (online): per
query batch the pivot distances, K4's projection and the distributed
filter (K3 per grid position, ``build_serve_step``), then an exact recheck
of the straddlers.  ``--engine batch`` serves every workload through
``repro_torch.api`` indexes instead (threshold, knn, online, approx, the
micro-batched ``SearchService`` and the multi-tenant HTTP front end).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A host numpy array of ``x`` (a tensor on any device, or an array)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on(device, x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


def _pick_threshold(args, data, X, metric, n_objects=None) -> float:
    """Threshold hitting the requested selectivity, from a small distance
    sample (shared by both serving engines so their numbers are comparable)."""
    n_objects = args.n_objects if n_objects is None else n_objects
    qs = X[n_objects : n_objects + 256]
    d_sample = _host(metric.cross(_on(args.device, qs[:8]), _on(args.device, data[:2000]))).ravel()
    threshold = float(np.quantile(d_sample, args.selectivity))
    print(f"[serve] threshold {threshold:.5f} (~{100 * args.selectivity:.3f}% selectivity)")
    return threshold


def _resolve_corpus(n_objects_cli, n_extra, X, index):
    """(data, X, n_objects) the serving loops should use for ``index``.

    When serving a loaded index whose corpus size differs from the CLI's
    ``--n-objects``, the SAVED corpus wins: the query pool is drawn again
    long enough to hold ``n_extra`` rows past it.  Never mutates the parsed
    args.  The index's rows may lie on the card; the returned corpus is a
    host copy.
    """
    n_loaded = int(index.stats()["n_objects"])
    if n_loaded != n_objects_cli:
        print(
            f"[serve] loaded corpus has {n_loaded} objects; "
            f"overriding --n-objects {n_objects_cli}"
        )
        from repro_torch.data import load_or_generate_colors

        X = load_or_generate_colors(n=n_loaded + n_extra, seed=99)
    return _host(index.data), X, n_loaded


def _serve_batch(args, data, X, metric, t0):
    """Single-host batched serving as a thin dispatcher over
    ``repro_torch.api``: any index that ``build_index`` / ``load_index`` /
    ``open_durable`` returns serves every workload through ``Index.query``."""
    from repro_torch.api import build_index, load_index

    n_objects = args.n_objects
    if args.load_index:
        index = load_index(args.load_index, device=args.device)
        print(f"[serve] loaded index from {args.load_index}: {index.stats()}")
        data, X, n_objects = _resolve_corpus(args.n_objects, args.queries * args.batches, X, index)
    elif args.durable and args.wal_dir and os.path.exists(os.path.join(args.wal_dir, "CURRENT")):
        # the WAL dir already holds a store: recover (checkpoint + tail
        # replay) and serve it instead of building a fresh corpus
        from repro_torch.store import open_durable

        index = open_durable(args.wal_dir, device=args.device)
        print(f"[serve] recovered durable store from {args.wal_dir}: {index.stats()}")
        data, X, n_objects = _resolve_corpus(args.n_objects, args.queries * args.batches, X, index)
    else:
        apex_dims = args.apex_dims
        if apex_dims is None and args.workload == "approx":
            apex_dims = max(2, args.pivots // 2)
        index = build_index(
            data,
            metric,
            kind=args.kind,
            n_pivots=args.pivots,
            seed=0,
            mutable=args.mutable or args.workload == "online",
            shards=args.shards or None,
            apex_dims=apex_dims,
            refine=args.refine,
            durable=args.durable,
            wal_dir=args.wal_dir,
            device=args.device,
        )
        print(
            f"[serve] built {args.kind} index: {index.stats()} "
            f"({time.perf_counter() - t0:.1f}s build)"
        )
    if args.save_index:
        index.save(args.save_index)
        print(f"[serve] saved index to {args.save_index}")

    n_pivots = index.stats().get("n_pivots", 0)
    if args.workload == "online":
        if not hasattr(index, "add"):
            raise SystemExit(
                "[serve] --workload online needs a mutable index; this one is "
                f"kind={index.kind!r}. Re-save it with --mutable (or pass "
                "--mutable when building)."
            )
        _serve_online(args, index, X, n_pivots)
        if callable(getattr(index, "close", None)):
            index.close()                       # durable: fsync + release WAL
        return
    if args.workload == "approx":
        _serve_approx(args, index, data, X, metric, n_objects)
        return
    if args.workload == "service":
        _serve_service(args, index, X, n_objects)
        return
    if args.workload == "frontend":
        _serve_frontend(args, index, data, X, metric, n_objects)
        return

    from repro_torch.api import Query

    if args.workload == "knn":
        spec = Query.knn(args.k)
        print(f"[serve] plan: {index.plan(spec).explain()}")
        total_results = total_evals = 0
        lat = []
        for b in range(args.batches):
            lo = n_objects + b * args.queries
            queries = X[lo : lo + args.queries]
            t1 = time.perf_counter()
            batch = index.query(queries, spec)
            for res in batch:
                total_results += len(res)
                total_evals += res.stats.original_calls - n_pivots
            lat.append((time.perf_counter() - t1) / args.queries * 1e3)
        nq = args.queries * args.batches
        print(
            f"[serve] {nq} knn queries (k={args.k}): {total_results} results, "
            f"{total_evals / nq:.1f} true-metric evals/query vs "
            f"{n_objects} brute-force, {np.mean(lat):.2f} ms/query"
        )
        return

    threshold = _pick_threshold(args, data, X, metric, n_objects)
    spec = Query.range(threshold)
    print(f"[serve] plan: {index.plan(spec).explain()}")
    total_results = total_recheck = total_admitted = 0
    lat = []
    for b in range(args.batches):
        lo = n_objects + b * args.queries
        queries = X[lo : lo + args.queries]
        t1 = time.perf_counter()
        batch = index.query(queries, spec)
        for res in batch:
            total_results += len(res)
            total_recheck += res.stats.original_calls - n_pivots
            total_admitted += res.stats.accepted_no_check
        lat.append((time.perf_counter() - t1) / args.queries * 1e3)
    nq = args.queries * args.batches
    print(
        f"[serve] {nq} queries: {total_results} results "
        f"({total_admitted} admitted bound-only), "
        f"{total_recheck} rechecks ({total_recheck / nq:.1f}/query vs "
        f"{n_objects} brute-force), {np.mean(lat):.2f} ms/query"
    )


def _serve_service(args, index, X, n_objects):
    """Micro-batched service workload: a Poisson open-loop client fires
    single-query k-NN requests at ``--arrival-rate`` (default 4x the
    measured sequential single-request QPS); the ``SearchService``
    coalesces them into fused batches.  Reports latency percentiles and
    occupancy beside the sequential baseline."""
    from repro_torch.api import Query
    from repro_torch.launch.service import SearchService, run_poisson_open_loop

    spec = Query.knn(args.k)
    n_requests = args.queries * args.batches
    queries = X[n_objects : n_objects + n_requests]
    print(f"[serve] plan: {index.plan(spec).explain()}")

    # build the kernels on the single-query path, then run every padded
    # bucket shape, so the baseline and the service measure steady serving
    index.query(queries[0], spec)

    with SearchService(index, max_batch=args.max_batch, max_wait_s=args.max_wait_ms * 1e-3) as service:
        service.warmup(spec, queries[0])

        # sequential baseline: one request at a time through the same plan
        t0 = time.perf_counter()
        for q in queries[: min(32, n_requests)]:
            index.query(q, spec)
        seq_qps = min(32, n_requests) / (time.perf_counter() - t0)

        rate = args.arrival_rate if args.arrival_rate > 0 else 4.0 * seq_qps
        results = run_poisson_open_loop(service, queries, spec, arrival_rate=rate, seed=7)
        st = service.stats()
    total = sum(len(r) for r in results)
    print(
        f"[serve] service: {st['n_requests']} requests at {rate:.0f}/s arrival "
        f"-> {st['n_batches']} fused batches "
        f"(occupancy mean {st['mean_batch_occupancy']:.1f} / max {st['max_batch_occupancy']}), "
        f"{total} results"
    )
    print(
        f"[serve] latency p50 {st['latency_p50_ms']:.2f} ms / "
        f"p99 {st['latency_p99_ms']:.2f} ms, service {st['qps']:.0f} QPS "
        f"vs sequential {seq_qps:.0f} QPS"
    )


def _serve_frontend(args, index, data, X, metric, n_objects):
    """Multi-tenant HTTP/JSON front end: registers ``--tenants`` corpora
    (the built index plus smaller slices of the corpus under fresh pivot
    draws), serves them on ``--port`` and drives an open-loop HTTP client
    across the tenants with per-request deadlines; sheds (429) and expiries
    (504) are reported beside the served latency percentiles, and one
    response per tenant is checked bit-identical to a direct
    ``Index.query``."""
    from repro_torch.api import Query, build_index
    from repro_torch.serve import Frontend, FrontendClient, FrontendError, IndexRegistry

    spec = Query.knn(args.k)
    registry = IndexRegistry(
        max_concurrent_batches=4, max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms * 1e-3, max_queue=args.max_queue, device=args.device,
    )
    tenants = {"tenant0": index}
    for t in range(1, max(1, args.tenants)):
        # smaller corpora under fresh pivot draws: visibly distinct tenants
        block = data[: max(256, len(data) // (t + 1))]
        tenants[f"tenant{t}"] = build_index(
            block, metric, kind=args.kind, n_pivots=args.pivots, seed=t, device=args.device,
        )
    for name, idx in tenants.items():
        registry.add(name, index=idx, rate=args.rate_limit or None)
        registry.tenant(name).warmup(spec, np.asarray(X[n_objects], np.float64))
    names = sorted(tenants)

    n_requests = args.queries * args.batches
    queries = np.asarray(X[n_objects : n_objects + n_requests], np.float64)
    with Frontend(registry, port=args.port) as fe:
        host, port = fe.address
        print(f"[serve] frontend listening on http://{host}:{port} "
              f"({len(names)} tenants: {', '.join(names)})")
        client = FrontendClient(host, port)

        # bit-identity spot check per tenant (the multi-tenancy contract)
        for name in names:
            got = client.query(name, queries[0], k=args.k)
            want = tenants[name].knn_batch(queries[:1], args.k).results[0]
            if got["ids"] != [int(i) for i in want.ids] or got["distances"] != [float(d) for d in want.distances]:
                raise SystemExit(f"[serve] tenant {name}: the HTTP answer differs from a direct Index.query")
        print("[serve] per-tenant responses bit-identical to direct Index.query")

        served, shed, expired, lat = 0, 0, 0, []
        rng = np.random.default_rng(7)
        gaps = rng.exponential(1.0 / max(args.arrival_rate, 1.0), size=n_requests)
        t_next = time.perf_counter()
        for i in range(n_requests):
            t_next += gaps[i]
            delay = t_next - time.perf_counter()
            if delay > 0.004:
                time.sleep(delay)
            t1 = time.perf_counter()
            try:
                client.query(
                    names[i % len(names)], queries[i], k=args.k,
                    deadline_ms=args.deadline_ms or None,
                )
                served += 1
                lat.append((time.perf_counter() - t1) * 1e3)
            except FrontendError as e:
                if e.status == 429:
                    shed += 1
                elif e.status == 504:
                    expired += 1
                else:
                    raise
        lat.sort()
        p50 = lat[len(lat) // 2] if lat else 0.0
        p99 = lat[int(0.99 * (len(lat) - 1))] if lat else 0.0
        st = client.stats()
        degraded = sum(ts["admission"]["degraded"] for ts in st["tenants"].values())
        print(
            f"[serve] frontend: {served}/{n_requests} served "
            f"({shed} shed, {expired} expired, {degraded} degraded), "
            f"p50 {p50:.2f} ms / p99 {p99:.2f} ms end-to-end"
        )
        for name in names:
            ts = st["tenants"][name]
            print(
                f"[serve]   {name}: {ts['service']['n_requests']} requests, "
                f"occupancy mean {ts['service']['mean_batch_occupancy']:.1f}, "
                f"queue {ts['service']['queue_depth']}, "
                f"rejected {ts['admission']['rejected']}"
            )


def _serve_approx(args, index, data, X, metric, n_objects=None):
    """Approximate workload: quality-dialled k-NN blocks and a measured
    recall line against the brute force on the first batch."""
    from repro_torch.index.knn import knn_select

    n_objects = args.n_objects if n_objects is None else n_objects
    stats = index.stats()
    dims = stats.get("apex_dims")
    if dims is None:
        raise SystemExit(
            "[serve] --workload approx needs an approximate index; build with "
            "--apex-dims (or let the workload default it) or load one saved "
            "with apex_dims"
        )
    # measured recall on the first batch (the quality half of the dial)
    q0 = X[n_objects : n_objects + args.queries]
    batch0 = index.knn_batch(q0, args.k)
    rows = _on(args.device, data)
    hits = total = 0
    for qi, res in enumerate(batch0):
        d = _host(metric.one_to_many(_on(args.device, q0[qi]), rows))
        oracle, _ = knn_select(d, np.arange(len(d), dtype=np.int64), min(args.k, len(d)))
        hits += len(np.intersect1d(res.ids, oracle))
        total += len(oracle)
    lat, widths, evals = [], [], 0
    for b in range(args.batches):
        lo = n_objects + b * args.queries
        queries = X[lo : lo + args.queries]
        t1 = time.perf_counter()
        batch = index.knn_batch(queries, args.k)
        lat.append((time.perf_counter() - t1) / args.queries * 1e3)
        for res in batch:
            widths.append(res.stats.bound_width)
            evals += res.stats.original_calls
    nq = args.queries * args.batches
    print(
        f"[serve] approx knn (k={args.k}, dims={dims}/{stats['n_pivots']}, "
        f"refine={stats.get('refine')}): recall@{args.k} {hits / max(total, 1):.3f}, "
        f"band width {np.mean(widths):.4f}, {evals / nq:.1f} true-metric "
        f"evals/query, {np.mean(lat):.2f} ms/query"
    )


def _serve_online(args, index, X, n_pivots):
    """Online workload: per batch ``--queries`` fresh rows added, then
    ``--queries`` exact k-NN queries; an explicit compaction and a block
    after it show the dirty and compacted costs."""
    from repro_torch.data import load_or_generate_colors

    n0 = index.stats()["n_objects"]
    fresh = load_or_generate_colors(n=args.queries * args.batches, seed=4242)
    ins_t = []
    lat = []
    for b in range(args.batches):
        block = fresh[b * args.queries : (b + 1) * args.queries]
        t1 = time.perf_counter()
        index.add(block)
        ins_t.append(time.perf_counter() - t1)
        lo = n0 + b * args.queries
        queries = X[lo : lo + args.queries]
        t1 = time.perf_counter()
        index.knn_batch(queries, args.k)
        lat.append((time.perf_counter() - t1) / args.queries * 1e3)
    t1 = time.perf_counter()
    index.compact()
    compact_s = time.perf_counter() - t1
    queries = X[n0 : n0 + args.queries]
    t1 = time.perf_counter()
    index.knn_batch(queries, args.k)
    post_ms = (time.perf_counter() - t1) / args.queries * 1e3
    n_ins = args.queries * args.batches
    print(
        f"[serve] online: {n_ins} inserts at {n_ins / sum(ins_t):.0f} rows/s, "
        f"{np.mean(lat):.2f} ms/query dirty, compaction {compact_s * 1e3:.0f} ms, "
        f"{post_ms:.2f} ms/query compacted "
        f"({index.stats()['n_objects']} live objects)"
    )


def _serve_shard_map(args, X, data, metric, t0) -> dict:
    """The default engine: the apex table on the device grid, each batch
    through ``build_serve_step`` (K5 pivot distances for JSD, K4 projection,
    K3 per grid position), then an exact recheck of the straddlers; upper
    bound ACCEPTs come back free.  As in the reference, a query whose
    non-excluded rows outnumber the 256 slots keeps only the slots' rows;
    the overflowing queries are counted and printed.  Returns the per-query
    answers, the histograms and the threshold."""
    from repro_torch.core import ACCEPT, RECHECK, NSimplexProjector, select_pivots
    from repro_torch.search.distributed import build_serve_step
    from repro_torch.sharding import make_scaleout_mesh, place_rows

    dev = args.device
    max_candidates = 256
    pivots = select_pivots(data, args.pivots, seed=0)
    proj = NSimplexProjector(pivots, metric, device=dev)
    rows = _on(dev, data)
    table = proj.project_distances(proj.pivot_distances(rows)).to(torch.float32)
    mesh = make_scaleout_mesh(devices=None if dev.type == "cuda" else [dev])
    n_dev = len(mesh.devices[0])
    serve = build_serve_step(
        mesh, n_pivots=args.pivots, max_candidates=max_candidates,
        projection="gemm", selection="topk",
    )
    # pad table rows to the shard count; sentinel rows can never match
    pad = (-table.shape[0]) % n_dev
    table_p = torch.nn.functional.pad(table, (0, 0, 0, pad))
    if pad:
        table_p[-pad:, -1] = 1e30
    placed = place_rows(mesh, table_p)
    Linv, sq_norms, sigma = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                             for a in (proj.Linv, proj.sq_norms, proj.sigma))
    print(f"[serve] built index: {args.n_objects} objects x {args.pivots} pivots "
          f"({table.numel() * 4 / 2**20:.1f} MiB table, {time.perf_counter() - t0:.1f}s build)")

    threshold = _pick_threshold(args, data, X, metric)

    # ---- serve (online) -------------------------------------------------------
    total_results = total_recheck = overflowing = 0
    lat, answers, hists = [], [], []
    for b in range(args.batches):
        lo = args.n_objects + b * args.queries
        queries = _on(dev, X[lo : lo + args.queries])
        t1 = time.perf_counter()
        qd = proj.pivot_distances(queries).to(torch.float32)
        hist, cand_idx, cand_code = serve(placed, Linv, sq_norms, sigma, qd, threshold)
        hist = _host(hist)
        idxs = _host(cand_idx)      # (shards, Q, K)
        codes = _host(cand_code)
        # exact recheck of straddlers; upper-bound ACCEPTs come back free
        for qi in range(args.queries):
            packed = idxs[:, qi, :].ravel()
            pcodes = codes[:, qi, :].ravel()
            valid = packed >= 0
            accepted = packed[valid & (pcodes == ACCEPT) & (packed < args.n_objects)]
            recheck = packed[valid & (pcodes == RECHECK) & (packed < args.n_objects)]
            if len(recheck):
                d = _host(metric.one_to_many(queries[qi], rows[_on(dev, recheck)]))
                accepted = np.concatenate([accepted, recheck[d <= threshold]])
            total_recheck += len(recheck)
            total_results += len(accepted)
            answers.append(np.sort(accepted))
        lat.append((time.perf_counter() - t1) / args.queries * 1e3)
        overflowing += int(((hist[:, RECHECK] + hist[:, ACCEPT]) > max_candidates * n_dev).sum())
        hists.append(hist)
    nq = args.queries * args.batches
    print(f"[serve] {nq} queries: {total_results} results, "
          f"{total_recheck} rechecks ({total_recheck/nq:.1f}/query vs "
          f"{args.n_objects} brute-force), {np.mean(lat):.2f} ms/query")
    print(f"[serve] {overflowing} of {nq} queries had more candidates than the "
          f"{max_candidates} slots per shard hold (their answers keep the slots' rows)")
    return dict(threshold=threshold, answers=answers, hist=np.concatenate(hists),
                ms_per_query=float(np.mean(lat)), rechecks=total_recheck, results=total_results,
                overflowing=overflowing, max_candidates=max_candidates)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-objects", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--pivots", type=int, default=20)
    ap.add_argument("--metric", default="jensen_shannon")
    ap.add_argument("--selectivity", type=float, default=1e-4)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument(
        "--engine",
        choices=("shard_map", "batch"),
        default="shard_map",
        help="shard_map: the distributed device filter over the device grid; "
        "batch: a repro_torch.api index (single-host batched path)",
    )
    ap.add_argument(
        "--kind",
        choices=("nsimplex", "laesa", "tree"),
        default="nsimplex",
        help="index kind for --engine batch (repro_torch.api.build_index)",
    )
    ap.add_argument(
        "--workload",
        choices=("threshold", "knn", "online", "approx", "service", "frontend"),
        default="threshold",
        help="--engine batch workload: threshold search, exact k-NN, the "
        "online mix (interleaved inserts + k-NN on a mutable index), "
        "approx (truncated-apex quality-dialled k-NN with a recall report), "
        "service (micro-batched SearchService runtime driven by a "
        "Poisson open-loop client), or frontend (multi-tenant HTTP/JSON "
        "front end with admission control and deadlines)",
    )
    ap.add_argument("--k", type=int, default=10, help="neighbours for --workload knn")
    ap.add_argument(
        "--apex-dims",
        type=int,
        default=None,
        help="truncate the surrogate to this many of --pivots dimensions "
        "(approximate index; --workload approx defaults it to pivots/2)",
    )
    from repro_torch.api.query import DEFAULT_REFINE

    ap.add_argument(
        "--refine",
        type=int,
        default=DEFAULT_REFINE,
        help="true-metric re-rank budget per approximate query",
    )
    ap.add_argument(
        "--shards",
        type=int,
        default=0,
        help="partition the --engine batch index across this many segments "
        "(0 = single segment); the nsimplex kind serves range batches through "
        "the distributed device filter",
    )
    ap.add_argument(
        "--mutable",
        action="store_true",
        help="build a MutableIndex (add/remove/upsert/compact); implied by "
        "--workload online",
    )
    ap.add_argument(
        "--durable",
        action="store_true",
        help="--engine batch: write-ahead log every mutation under --wal-dir "
        "(build_index(durable=True)); if the directory already holds a "
        "store, recover it (checkpoint + WAL tail replay) and serve that",
    )
    ap.add_argument(
        "--wal-dir",
        default=None,
        help="directory for the durable store's WAL + checkpoints (required "
        "with --durable)",
    )
    ap.add_argument(
        "--arrival-rate",
        type=float,
        default=0.0,
        help="--workload service: Poisson arrival rate in requests/s "
        "(0 = auto: 4x the measured sequential single-query QPS)",
    )
    ap.add_argument(
        "--max-batch",
        type=int,
        default=64,
        help="--workload service: flush a micro-batch at this occupancy",
    )
    ap.add_argument(
        "--max-wait-ms",
        type=float,
        default=2.0,
        help="--workload service: flush an open micro-batch after this long",
    )
    ap.add_argument(
        "--port",
        type=int,
        default=0,
        help="--workload frontend: HTTP port to listen on (0 = ephemeral)",
    )
    ap.add_argument(
        "--tenants",
        type=int,
        default=2,
        help="--workload frontend: number of tenant corpora to register",
    )
    ap.add_argument(
        "--max-queue",
        type=int,
        default=256,
        help="--workload frontend: per-tenant admission queue bound",
    )
    ap.add_argument(
        "--rate-limit",
        type=float,
        default=0.0,
        help="--workload frontend: per-tenant token-bucket rate limit in "
        "requests/s (0 = no rate limit)",
    )
    ap.add_argument(
        "--deadline-ms",
        type=float,
        default=0.0,
        help="--workload frontend: per-request deadline in ms (0 = none)",
    )
    ap.add_argument(
        "--save-index", default=None, help="persist the built index to this directory"
    )
    ap.add_argument(
        "--load-index", default=None, help="serve from a saved index directory (skips build)"
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="device the indexes and kernels run on: cuda (default; raises "
        "without a card) or cpu (the plain PyTorch path)",
    )
    args = ap.parse_args(argv)

    from repro_torch.data import load_or_generate_colors
    from repro_torch.device import resolve_device
    from repro_torch.metrics import get_metric

    args.device = resolve_device(args.device)

    # ---- build (offline) ----------------------------------------------------
    t0 = time.perf_counter()
    X = load_or_generate_colors(n=args.n_objects + args.queries * args.batches, seed=99)
    data = X[: args.n_objects]
    metric = get_metric(args.metric)

    if args.engine == "batch":
        _serve_batch(args, data, X, metric, t0)
        return None
    return _serve_shard_map(args, X, data, metric, t0)


if __name__ == "__main__":
    main()
