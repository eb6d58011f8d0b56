"""The durable store on the card.

Marked ``gpu``; without a CUDA device every test skips (decided inside the
``cuda`` fixture).  Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_durable.py

Held: a durable index built on the card (euclidean and jensen_shannon, with
attributes) answering k-NN, range and filtered k-NN as the same index on the
CPU, with the same counts, before and after a refit; recovery on the card
(checkpoint + WAL tail, replayed through K5/K4) bit-equal to the live index,
a torn tail dropping exactly its record; the drift witness call (K5 for
Jensen-Shannon, at its (8, R, 112, f64) class) equal to its plain version at
1e-12; a reader racing a ``BackgroundCompactor`` refit and compaction never
seeing a torn answer.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.api import Query, build_index
from repro_torch.data import colors_like
from repro_torch.filter import AttributeStore, Predicate
from repro_torch.kernels import LAUNCHES, ref
from repro_torch.metrics import get_metric
from repro_torch.store import BackgroundCompactor, DriftDetector, open_durable, scan_segment

pytestmark = pytest.mark.gpu

SCHEMA = {"bucket": "int"}
KW = dict(n_pivots=12, seed=3, fsync_every=4, checkpoint_every=None, compact_threshold=None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


def _attrs(ids):
    return {"bucket": np.asarray(ids, dtype=np.int64) % 5}


def _store(n):
    s = AttributeStore(SCHEMA)
    s.put(np.arange(n), _attrs(np.arange(n)))
    return s


def _mutate(idx, pool, base_n):
    ids = np.arange(base_n, base_n + 256)
    idx.add(pool[:256], ids=ids, attrs=_attrs(ids))
    idx.remove(np.arange(10, 74))
    idx.upsert(np.arange(100, 132), pool[256:288], attrs=_attrs(np.arange(100, 132)))
    idx.flush()


def _specs():
    return [Query.knn(10), Query.knn(10, where=Predicate.eq("bucket", 2), filter_mode="pushdown"),
            Query.knn(10, where=Predicate.eq("bucket", 2))]


def _same(got, want, bits=False):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert (g.distances is None) == (w.distances is None)
        if g.distances is None:
            pass
        elif bits:
            np.testing.assert_array_equal(g.distances, w.distances)
        else:
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-12, atol=1e-12)
        assert g.stats.original_calls == w.stats.original_calls
        assert g.stats.candidates == w.stats.candidates


@pytest.mark.parametrize("metric", ["euclidean", "jensen_shannon"])
def test_durable_on_card_equals_cpu(cuda, tmp_path, metric):
    X = colors_like(n=6016, seed=7, dtype=np.float64)
    data, queries = X[:6000], X[6000:]
    pool = colors_like(n=288, seed=8, dtype=np.float64)
    idx = {dev: build_index(data, metric, durable=True, wal_dir=os.fspath(tmp_path / dev), attributes=_store(6000),
                            drift_threshold=0.2, device=dev, **KW) for dev in ("cuda", "cpu")}
    for i in idx.values():
        _mutate(i, pool, 6000)
    d = np.sort(get_metric(metric).one_to_many(torch.as_tensor(queries[0]), torch.as_tensor(data)).numpy())
    t = float(0.5 * (d[40] + d[41]))
    for stage in ("dirty", "refit"):
        for spec in _specs() + [Query.range(t)]:
            _same(idx["cuda"].query(queries, spec), idx["cpu"].query(queries, spec))
        assert idx["cuda"].drift_stat() == pytest.approx(idx["cpu"].drift_stat(), abs=1e-9)
        for i in idx.values():
            i.refit()
    for i in idx.values():
        i.close()


def test_recovery_on_card_is_bit_equal_and_drops_a_torn_tail(cuda, tmp_path):
    X = colors_like(n=20_016, seed=9)
    data, queries = X[:20_000], X[20_000:]
    pool = colors_like(n=288, seed=10)
    live = build_index(data, "jensen_shannon", durable=True, wal_dir=os.fspath(tmp_path / "w"),
                       attributes=_store(20_000), device="cuda", **KW)
    live.checkpoint()
    _mutate(live, pool, 20_000)
    for name in ("a", "b"):
        shutil.copytree(live.wal_dir, tmp_path / name)
    before = LAUNCHES["apex_project"], LAUNCHES["jsd_pairwise"]
    back = open_durable(tmp_path / "a")
    back._snapshot()        # the replayed delta's entries: K5 + K4 on the card
    assert LAUNCHES["apex_project"] > before[0] and LAUNCHES["jsd_pairwise"] > before[1]
    assert back.stats()["wal_records"] == live.stats()["wal_records"]
    for spec in _specs():
        _same(back.query(queries, spec), live.query(queries, spec), bits=True)
    # cut the newest segment's last record (the upsert) in half
    seg = sorted(f for f in os.listdir(tmp_path / "b") if f.startswith("wal-"))[-1]
    path = os.path.join(tmp_path / "b", seg)
    records, _, _ = scan_segment(path)
    start, end = records[-2][4], records[-1][4]
    with open(path, "r+b") as f:
        f.truncate(start + (end - start) // 2)
    torn = open_durable(tmp_path / "b")
    assert torn.stats()["wal_records"] == live.stats()["wal_records"] - 1
    upserted = np.arange(100, 132)
    rows = torn.data[torch.as_tensor(np.searchsorted(torn.ids(), upserted), device=cuda)]
    assert torch.equal(rows.cpu(), torch.as_tensor(data[upserted]))
    for i in (live, back, torn):
        i.close()


@pytest.mark.parametrize("R", [128, 2048])
def test_drift_witness_call_equals_plain(cuda, R):
    X = colors_like(n=R + 20, seed=11)
    metric = get_metric("jensen_shannon")
    det = DriftDetector(X[:20], metric, X[20:], device="cuda")
    before = LAUNCHES["jsd_pairwise"]
    got = metric.cross(det._witness, torch.as_tensor(X[20:], device=cuda))
    assert LAUNCHES["jsd_pairwise"] == before + 1
    w = det._witness.double().cpu()
    want = ref.jsd_pairwise_ref(ref.l1_normalise(w), ref.l1_normalise(torch.as_tensor(X[20:]).double()))
    assert got.shape == (8, R)
    assert float((got.cpu() ** 2 - want ** 2).abs().max()) <= 1e-12
    host = DriftDetector(X[:20], metric, X[20:], device="cpu")
    np.testing.assert_array_equal(det._ref_counts, host._ref_counts)


def test_reader_never_tears_against_a_background_refit(cuda, tmp_path):
    X = colors_like(n=50_064, seed=12)
    data, queries = X[:50_000], X[50_000:]
    stream = np.roll(colors_like(n=4096, seed=13), 112 // 3, axis=1)
    idx = build_index(data, "euclidean", durable=True, wal_dir=os.fspath(tmp_path / "w"), device="cuda",
                      drift_threshold=0.25, **KW)
    ever, failures, stop = set(range(50_000)), [], threading.Event()

    def reader():
        try:
            while not stop.is_set():
                for r in idx.knn_batch(queries, 10):
                    assert len(r.ids) == 10 and bool(np.all(np.diff(r.distances) >= 0))
                    assert set(r.ids.tolist()) <= ever
        except Exception as e:  # noqa: BLE001 — surfaced after join
            failures.append(e)

    with BackgroundCompactor(idx, interval_s=0.005) as bg:
        t = threading.Thread(target=reader)
        t.start()
        g0, cursor = idx.generation, 0
        while not idx.drift_pending and cursor < len(stream):
            ids = np.arange(60_000 + cursor, 60_128 + cursor)
            ever.update(ids.tolist())
            idx.add(stream[cursor:cursor + 128], ids=ids)
            cursor += 128
        assert idx.drift_pending or bg.counters["refits"] >= 1
        deadline = time.monotonic() + 120
        while bg.counters["refits"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        idx.compact()
        stop.set()
        t.join()
    assert not failures, failures
    assert bg.counters["refits"] == 1 and bg.last_error is None and idx.generation > g0
    fresh = build_index(idx.data.cpu().numpy(), "euclidean", n_pivots=12, seed=3, device="cuda")
    live = idx.ids()
    for a, b in zip(idx.knn_batch(queries, 10), fresh.knn_batch(queries, 10)):
        np.testing.assert_array_equal(a.ids, live[b.ids])
    idx.close()
