"""Online updates: a mutable index through its whole lifecycle.

    python -m repro_torch.examples.online_updates                # on the card
    python -m repro_torch.examples.online_updates --device cpu   # on the host

Walks add -> query -> remove/upsert -> compact -> save/load on a
``MutableIndex``, verifying at every step that the answers are bit-identical
to a fresh rebuild over the same logical rows — the online contract.  Then
the same traffic on a sharded mutable index (the multi-device layout), and
finally the durable store: WAL-logged writes, a simulated crash + recovery,
and a distribution-drift burst that triggers a pivot refit (the JAX
package's ``examples/online_updates.py``).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from repro_torch.api import build_index, load_index
from repro_torch.data import load_or_generate_colors
from repro_torch.examples.summary import parse, summary
from repro_torch.metrics import get_metric


def verify(index, oracle, metric, queries, device, k=10):
    """Index answers == fresh rebuild over the logical rows (id-mapped)."""
    live = np.array(sorted(oracle), dtype=np.int64)
    logical = np.stack([oracle[int(i)] for i in live])
    fresh = build_index(logical, metric, kind="nsimplex", n_pivots=12, seed=9, device=device)
    batch = index.knn_batch(queries, k)
    for qi, q in enumerate(queries):
        want = fresh.knn(q, k)
        assert np.array_equal(batch[qi].ids, live[want.ids]), "exactness violated!"
    return batch


def main(argv=None) -> dict:
    args, dev = parse(argparse.ArgumentParser(description=__doc__.splitlines()[0]), argv)
    X = load_or_generate_colors(n=6_000, seed=42)
    data, stream, queries = X[:4_000], X[4_000:5_000], X[5_000:5_016]
    metric = get_metric("euclidean")
    oracle = {i: row for i, row in enumerate(data)}
    exact, seconds = {}, {}
    t_run = time.perf_counter()

    # mutable=True wraps the fitted segment in an LSM-style MutableIndex
    index = build_index(
        data, metric, kind="nsimplex", n_pivots=12, seed=0,
        mutable=True, compact_threshold=0.5, device=dev,
    )

    # -- add: new rows are solved against the existing pivot simplex -------
    ids = index.add(stream[:300])
    for i, row in zip(ids, stream[:300]):
        oracle[int(i)] = row
    verify(index, oracle, metric, queries, dev)
    st = index.stats()
    exact["after_add"] = [st["n_objects"], st["delta_rows"]]
    print(f"after add          : {st['n_objects']} live "
          f"({st['delta_rows']} delta rows, no refit)")

    # -- remove / upsert: tombstones, ids stay stable ----------------------
    index.remove(np.arange(100, 200))
    for i in range(100, 200):
        oracle.pop(i)
    index.upsert([7, 8], stream[300:302])
    oracle[7], oracle[8] = stream[300], stream[301]
    verify(index, oracle, metric, queries, dev)
    st = index.stats()
    exact["after_remove_upsert"] = [st["n_objects"], st["tombstones"]]
    print(f"after remove/upsert: {st['n_objects']} live "
          f"({st['tombstones']} tombstones)")

    # -- compact: fold delta + tombstones into one segment -----------------
    index.compact()
    verify(index, oracle, metric, queries, dev)
    exact["after_compact"] = index.stats()["base_rows"]
    print(f"after compact      : {index.stats()['base_rows']} base rows, "
          f"0 delta, ids unchanged")

    # -- save / load: nothing re-measured, dirty or clean ------------------
    new_ids = index.add(stream[302:350])
    for i, row in zip(new_ids, stream[302:350]):
        oracle[int(i)] = row
    with tempfile.TemporaryDirectory() as td:
        index.save(f"{td}/online.idx")
        reloaded = load_index(f"{td}/online.idx", device=dev)
        verify(reloaded, oracle, metric, queries, dev)
        print("save/load          : dirty round-trip verified (identical ids)")

    # -- the same traffic, sharded across segments -------------------------
    sharded = build_index(
        data, metric, kind="nsimplex", n_pivots=12, seed=0,
        shards=4, mutable=True, device=dev,
    )
    oracle2 = {i: row for i, row in enumerate(data)}
    ids = sharded.add(stream[:200])
    for i, row in zip(ids, stream[:200]):
        oracle2[int(i)] = row
    sharded.remove(np.arange(50))
    for i in range(50):
        oracle2.pop(i)
    verify(sharded, oracle2, metric, queries, dev)
    exact["shard_objects"] = sharded.stats()["shard_objects"]
    print(f"sharded mutable    : {sharded.stats()['shard_objects']} rows/shard, "
          "same exact answers")
    seconds["mutable_and_sharded"] = time.perf_counter() - t_run

    t0 = time.perf_counter()
    durable = durable_walkthrough(data, stream, queries, metric, dev)
    seconds["durable"] = time.perf_counter() - t0
    return summary(exact={**exact, **durable["exact"]}, close=durable["close"], seconds=seconds)


def durable_walkthrough(data, stream, queries, metric, device) -> dict:
    """Durability: crash mid-stream, recover from the WAL, refit on drift."""
    from repro_torch.store import open_durable

    with tempfile.TemporaryDirectory() as td:
        wal_dir = os.path.join(td, "wal")

        # -- every mutation is WAL-logged BEFORE it is applied -------------
        index = build_index(
            data, metric, kind="nsimplex", n_pivots=12, seed=0,
            durable=True, wal_dir=wal_dir, drift_threshold=0.1, device=device,
        )
        index.add(stream[:200])
        index.remove(np.arange(40))
        index.upsert([50, 51], stream[200:202])
        index.flush()                                # fsync the tail
        want = index.knn_batch(queries, 10)
        wal_records, live = index.stats()["wal_records"], index.stats()["n_objects"]
        print(f"durable writes     : {wal_records} WAL records, {live} live")

        # -- crash: copy the store dir as a downed process left it --------
        crashed = os.path.join(td, "crashed")
        shutil.copytree(wal_dir, crashed)
        index.close()

        # -- recover: checkpoint + idempotent WAL tail replay --------------
        recovered = open_durable(crashed, device=device)
        got = recovered.knn_batch(queries, 10)
        for w, g in zip(want.results, got.results):
            assert np.array_equal(w.ids, g.ids), "recovery changed answers!"
            assert np.array_equal(w.distances, g.distances)
        recovered_live = recovered.stats()["n_objects"]
        print("crash recovery     : recovered index bit-identical "
              f"({recovered_live} live)")

        # -- drift: a shifted burst trips the detector; refit re-picks pivots
        shifted = np.roll(load_or_generate_colors(n=1_500, seed=7),
                          data.shape[1] // 3, axis=1)
        recovered.add(shifted)
        assert recovered.drift_pending, "burst should have tripped the detector"
        stat = recovered.stats()["drift_stat"]
        before = recovered.knn_batch(queries, 10)
        action = recovered.tick()                    # maintenance: refit + swap
        after = recovered.knn_batch(queries, 10)
        for b, a in zip(before.results, after.results):
            assert np.array_equal(b.ids, a.ids), "refit changed answers!"
        refits = recovered.stats()["refits"]
        print(f"drift refit        : JSD {stat:.3f} tripped, tick() -> "
              f"{action!r}, answers unchanged, "
              f"{refits} refit(s)")
        recovered.close()
    return {"exact": {"wal_records": wal_records, "durable_live": live, "recovered_live": recovered_live,
                      "durable_knn_ids": [r.ids.tolist() for r in want], "drift_action": action,
                      "refits": refits, "after_refit_ids": [r.ids.tolist() for r in after]},
            "close": {"drift_stat": stat, "durable_knn_distances_f32": [r.distances.tolist() for r in want]}}


if __name__ == "__main__":
    main()
