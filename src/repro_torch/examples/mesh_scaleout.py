"""Multi-device scale-out: placement layouts, overlapped fan-out, exactness.

    python -m repro_torch.examples.mesh_scaleout                # on the card
    python -m repro_torch.examples.mesh_scaleout --device cpu   # on the host

Walks the scale-out surface of ``ShardedIndex`` on a grid of four device
positions: declare a ``ShardLayout``, run the distributed range filter
under row-partitioned / replica-group / fully-replicated placements, show
the overlapped host fan-out with its shrinking radius hint, and verify the
pivots-measured-once accounting — all while every configuration returns
answers bit-identical to a single-segment rebuild (the JAX package's
``examples/mesh_scaleout.py``).

The reference forces four host devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=4``); here the grid names its four
positions through ``ShardedIndex.configure_grid``: four slots of the one
card (``[cuda] * 4``), or of the host under ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.api import build_index
from repro_torch.data import load_or_generate_colors
from repro_torch.examples.summary import parse, summary
from repro_torch.metrics import get_metric
from repro_torch.sharding.rules import ShardLayout, make_scaleout_mesh

#: grid positions, as the reference's forced host device count
GRID_POSITIONS = 4


def check_identical(batch_a, batch_b, what):
    for a, b in zip(batch_a.results, batch_b.results):
        assert np.array_equal(a.ids, b.ids), f"{what}: ids diverged!"
        assert np.array_equal(a.distances, b.distances), f"{what}: distances!"
    print(f"{what:<22}: bit-identical")


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    grid = [dev] * GRID_POSITIONS
    n_dev = len(grid)
    X = load_or_generate_colors(n=4_096, seed=42)
    data, queries = X[:4_000], X[4_000:4_016]
    metric = get_metric("euclidean")

    # the exactness oracle: one flat segment over the same rows
    flat = build_index(data, metric, kind="nsimplex", n_pivots=12, seed=0, device=dev)
    threshold = float(np.median(flat.knn(queries[0], 10).distances)) * 1.2

    # -- placement layouts --------------------------------------------------
    # rows="partitioned": apex table split over the grid's `data` axis.
    # replicas=R:         leading `replica` axis — the QUERY stream splits
    #                     across R groups, each scanning a full row-partition.
    # rows="replicated":  every position holds the whole table (query
    #                     parallelism only).
    layouts = {
        "partitioned rows": {"rows": "partitioned", "replicas": 1},
        "replica groups": {"rows": "partitioned", "replicas": 2},
        "replicated rows": {"rows": "replicated"},
    }
    want = flat.search_batch(queries, threshold)
    shapes = []
    t0 = time.perf_counter()
    for name, layout in layouts.items():
        mesh = make_scaleout_mesh(ShardLayout.from_dict(layout), grid)
        sharded = build_index(
            data, metric, kind="nsimplex", n_pivots=12, seed=0,
            shards=4, layout=layout, device=dev,
        )
        sharded.configure_grid(grid)
        got = sharded.search_batch(queries, threshold)
        shape = dict(mesh.shape)
        check_identical(want, got, f"{name} {shape}")
        shapes.append(shape)
    layouts_s = time.perf_counter() - t0

    # -- overlapped host fan-out -------------------------------------------
    # knn on the host path fans shards out to a worker pool; each finished
    # shard shrinks the global kth distance, which still-pending shards pick
    # up as a radius hint.  Sequential (workers=0) is the reference.
    sharded = build_index(
        data, metric, kind="nsimplex", n_pivots=12, seed=0, shards=4, device=dev,
    )
    sharded.configure_grid(grid)
    sharded.configure_fanout(0)                   # legacy sequential
    t0 = time.perf_counter()
    seq = sharded.knn_batch(queries, 10)
    t_seq = time.perf_counter() - t0
    sharded.configure_fanout(4)                   # private 4-worker pool
    t0 = time.perf_counter()
    ovl = sharded.knn_batch(queries, 10)
    t_ovl = time.perf_counter() - t0
    check_identical(seq, ovl, "sequential vs overlap")
    stats = sharded.stats()
    print(f"fan-out            : workers={stats['fanout_workers']} "
          f"overlap={stats['fanout_overlap']} "
          f"({t_ovl / max(t_seq, 1e-9):.2f}x sequential wall here; the "
          f"benchmark's refinement-heavy workload shows the real win)")

    # -- pivots measured once -----------------------------------------------
    # the shared pivot set is measured exactly once per query and the
    # distances are threaded to every shard — stats prove it.  The f32 scan's
    # guard band (its squared-domain error over 2t) is wide at t = 1e-9, so
    # the rows it leaves to recheck (candidates less bound-only admits) are
    # taken out; the JAX package's kernel path (use_kernel=True) counts the
    # same 4,000 rechecks a query here
    tiny = sharded.search_batch(queries, 1e-9)
    calls = {r.stats.original_calls - (r.stats.candidates - r.stats.accepted_no_check) for r in tiny.results}
    n_pivots = sharded.stats()["n_pivots"]
    assert calls == {n_pivots}, calls
    print(f"pivot accounting   : original_calls == n_pivots == {n_pivots} "
          f"per query across {stats['n_shards']} shards on {n_dev} devices")

    return summary(
        exact={"grid_shapes": shapes, "range_ids": [r.ids.tolist() for r in want],
               "knn_ids": [r.ids.tolist() for r in seq], "pivot_calls": sorted(calls),
               "n_shards": stats["n_shards"], "devices": n_dev},
        close={"threshold_f32": threshold},
        seconds={"layouts": layouts_s, "knn_sequential": t_seq, "knn_overlapped": t_ovl},
    )


if __name__ == "__main__":
    main()
