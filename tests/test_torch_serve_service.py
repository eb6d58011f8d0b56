"""The port's micro-batching ``SearchService`` on the CPU.

Twins every test of the JAX package's ``tests/test_service.py`` on
``device="cpu"`` (coalescing, bit-identity with direct calls, the plan
cache's freshness, lifecycle, deadlines, close semantics, the queue bound,
the wait estimate, per-spec accounting, ``serve._resolve_corpus``).  Where
the reference races sleeps against the dispatcher, the twin waits on an
event the index sets when a batch starts, or holds the batch until the test
has arranged the queue, with a 20 s deadline; the contracts asserted are
the same.  Then parity with the JAX package: the same open-loop traffic
answers with the same ids (and distances within 1e-12) and counts in both
services, and both services report the same counters for the same queue.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.compat import enable_x64
from repro.launch import service as rservice
from repro_torch.api import Query, build_index
from repro_torch.data import colors_like
from repro_torch.launch.service import (
    DeadlineExceeded,
    SearchService,
    ServiceClosed,
    ServiceOverloaded,
    run_poisson_open_loop,
)
from repro_torch.metrics import get_metric

torch.set_num_threads(1)

#: how long a twin waits for an event the dispatcher must reach
WAIT_S = 20.0


class _SlowIndex:
    """Index wrapper whose query() sleeps."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self.delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def query(self, *args, **kwargs):
        time.sleep(self.delay_s)
        return self._inner.query(*args, **kwargs)


class _GatedIndex:
    """Index wrapper whose query() sets ``entered`` and then waits until
    ``release()`` holds (an event, or a predicate polled every ms), so a test
    knows the dispatcher is inside a batch and decides when it leaves."""

    def __init__(self, inner, release=None):
        self._inner = inner
        self.entered = threading.Event()
        self.opened = threading.Event()
        self._release = release or self.opened.is_set

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def query(self, *args, **kwargs):
        self.entered.set()
        deadline = time.perf_counter() + WAIT_S
        while not self._release() and time.perf_counter() < deadline:
            time.sleep(0.001)
        return self._inner.query(*args, **kwargs)


@pytest.fixture(scope="module")
def served_index():
    X = colors_like(n=700, seed=5)
    data, queries = X[:600], X[600:632]
    idx = build_index(data, get_metric("euclidean"), kind="nsimplex", n_pivots=8, seed=1, device="cpu")
    return idx, data, queries


class TestCoalescing:
    def test_concurrent_requests_fuse_into_one_batch(self, served_index):
        idx, _, queries = served_index
        spec = Query.knn(10)
        qs = queries[:8]
        with SearchService(idx, max_batch=64, max_wait_s=1.0) as service:
            futures = [service.submit(q, spec) for q in qs]
            results = [f.result(timeout=30) for f in futures]
            st = service.stats()
        assert st["n_requests"] == len(qs)
        assert st["n_batches"] == 1
        assert st["max_batch_occupancy"] >= 2
        assert st["mean_batch_occupancy"] == len(qs)
        direct = idx.knn_batch(qs, 10)
        for got, want in zip(results, direct):
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.distances, want.distances)

    def test_bit_identity_under_poisson_load(self, served_index):
        idx, _, queries = served_index
        spec = Query.knn(5)
        with SearchService(idx, max_batch=4, max_wait_s=0.01) as service:
            results = run_poisson_open_loop(service, queries, spec, arrival_rate=2000.0, seed=3)
            st = service.stats()
        assert st["n_requests"] == len(queries)
        direct = idx.query(queries, spec)
        for got, want in zip(results, direct):
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.distances, want.distances)

    def test_max_batch_respected(self, served_index):
        idx, _, queries = served_index
        with SearchService(idx, max_batch=3, max_wait_s=1.0) as service:
            futures = [service.submit(q, Query.knn(3)) for q in queries[:9]]
            [f.result(timeout=30) for f in futures]
            st = service.stats()
        assert st["max_batch_occupancy"] <= 3
        assert st["n_batches"] == 3

    def test_different_specs_do_not_fuse(self, served_index):
        idx, data, queries = served_index
        t = float(np.quantile(
            get_metric("euclidean").one_to_many(torch.as_tensor(queries[0]), torch.as_tensor(data)).numpy(), 0.05
        ))
        knn_spec, range_spec = Query.knn(4), Query.range(t)
        with SearchService(idx, max_batch=64, max_wait_s=0.25) as service:
            futs = [service.submit(queries[i], knn_spec if i % 2 == 0 else range_spec) for i in range(8)]
            results = [f.result(timeout=30) for f in futs]
            st = service.stats()
        assert st["n_batches"] >= 2
        for i, r in enumerate(results):
            if i % 2 == 0:
                assert len(r.ids) == 4 and r.distances is not None
            else:
                want = idx.query(queries[i], range_spec)
                np.testing.assert_array_equal(r.ids, want.ids)

    def test_approx_spec_through_service(self, served_index):
        idx, _, queries = served_index
        spec = Query.knn(5, mode="approx", dims=4, refine=16)
        with SearchService(idx, max_batch=8, max_wait_s=0.2) as service:
            futs = [service.submit(q, spec) for q in queries[:6]]
            results = [f.result(timeout=30) for f in futs]
        direct = idx.query(queries[:6], spec)
        for got, want in zip(results, direct):
            assert got.approx == {"dims": 4, "refine": 16}
            np.testing.assert_array_equal(got.ids, want.ids)


class TestPlanCacheFreshness:
    def test_replans_after_index_mutation(self):
        X = colors_like(n=1700, seed=11)
        idx = build_index(X[:500], get_metric("euclidean"), kind="nsimplex", n_pivots=8, seed=1,
                          mutable=True, compact_threshold=None, device="cpu")
        # estimate = 8 + max(5, 0.02 * n): fits budget 20 at n=500, not at 1500
        spec = Query.knn(5, budget=20)
        q = X[1600]
        with SearchService(idx, max_batch=4, max_wait_s=0.01) as service:
            before = service.submit(q, spec).result(timeout=30)
            assert before.approx is None
            idx.add(X[500:1500])
            after = service.submit(q, spec).result(timeout=30)
            assert after.approx is not None
        assert idx.plan(spec).mode == "approx"


class TestLifecycle:
    def test_submit_validates(self, served_index):
        idx, _, queries = served_index
        with SearchService(idx) as service:
            with pytest.raises(TypeError, match="Query"):
                service.submit(queries[0], {"task": "knn"})
            with pytest.raises(ValueError, match="1-D"):
                service.submit(queries[:2], Query.knn(3))

    def test_close_drains_then_rejects(self, served_index):
        idx, _, queries = served_index
        service = SearchService(idx, max_batch=4, max_wait_s=0.01)
        futs = [service.submit(q, Query.knn(3)) for q in queries[:8]]
        service.close()
        assert all(f.done() for f in futs)
        with pytest.raises(RuntimeError, match="closed"):
            service.submit(queries[0], Query.knn(3))

    def test_executor_error_propagates_to_futures(self, served_index):
        idx, _, queries = served_index
        bad = Query.knn(3, mode="approx")        # the planner raises: no dims anywhere
        with SearchService(idx, max_batch=4, max_wait_s=0.1) as service:
            futs = [service.submit(q, bad) for q in queries[:3]]
            for f in futs:
                with pytest.raises(ValueError, match="truncation dimension"):
                    f.result(timeout=30)

    def test_threaded_clients(self, served_index):
        idx, _, queries = served_index
        spec = Query.knn(3)
        out = {}

        def client(i):
            out[i] = service.submit(queries[i], spec).result(timeout=30)

        with SearchService(idx, max_batch=16, max_wait_s=0.05) as service:
            threads = [threading.Thread(target=client, args=(i,)) for i in range(10)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            st = service.stats()
        assert st["n_requests"] == 10
        direct = idx.query(queries[:10], spec)
        for i in range(10):
            np.testing.assert_array_equal(out[i].ids, direct.results[i].ids)


class TestDeadlines:
    def test_deadline_none_unchanged(self, served_index):
        idx, _, queries = served_index
        spec = Query.knn(4)
        with SearchService(idx, max_batch=8, max_wait_s=0.05) as service:
            futs = [service.submit(q, spec) for q in queries[:6]]
            results = [f.result(timeout=30) for f in futs]
            st = service.stats()
        assert st["expired"] == 0 and st["rejected"] == 0
        direct = idx.knn_batch(queries[:6], 4)
        for got, want in zip(results, direct):
            np.testing.assert_array_equal(got.ids, want.ids)

    def test_deadline_must_be_positive(self, served_index):
        idx, _, queries = served_index
        with SearchService(idx) as service:
            with pytest.raises(ValueError, match="deadline_s"):
                service.submit(queries[0], Query.knn(3), deadline_s=0.0)
            with pytest.raises(ValueError, match="deadline_s"):
                service.submit(queries[0], Query.knn(3), deadline_s=-1.0)

    def test_expired_while_queued_never_executes(self, served_index):
        idx, _, queries = served_index
        gated = _GatedIndex(idx)
        blocker_spec, doomed_spec = Query.knn(3), Query.knn(7)
        with SearchService(gated, max_batch=4, max_wait_s=0.001) as service:
            blocker = service.submit(queries[0], blocker_spec)
            assert gated.entered.wait(WAIT_S)          # the dispatcher is inside the blocker's batch
            doomed = service.submit(queries[1], doomed_spec, deadline_s=0.01)
            time.sleep(0.05)                           # the doomed deadline passes in queue
            gated.opened.set()
            with pytest.raises(DeadlineExceeded, match="in queue"):
                doomed.result(timeout=30)
            blocker.result(timeout=30)
            st = service.stats()
        assert st["expired_queued"] == 1
        assert st["expired_in_flight"] == 0
        assert not [k for k in st["per_spec"] if '"k": 7' in k]
        assert st["n_requests"] == 1

    def test_expired_in_flight_discarded_peers_unaffected(self, served_index):
        idx, _, queries = served_index
        spec = Query.knn(5)
        # the batch stays open for 1 s, far past the doomed 0.2 s deadline
        with SearchService(idx, max_batch=8, max_wait_s=1.0) as service:
            doomed = service.submit(queries[0], spec, deadline_s=0.2)
            peer = service.submit(queries[1], spec)
            with pytest.raises(DeadlineExceeded, match="mid-batch"):
                doomed.result(timeout=30)
            got = peer.result(timeout=30)
            st = service.stats()
        assert st["expired_in_flight"] == 1
        assert st["expired_queued"] == 0
        assert st["n_batches"] == 1 and st["n_requests"] == 2
        want = idx.knn_batch(queries[1:2], 5).results[0]
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.distances, want.distances)

    def test_admitted_requests_bit_identical_under_deadlines(self, served_index):
        idx, _, queries = served_index
        spec = Query.knn(6)
        with SearchService(idx, max_batch=8, max_wait_s=0.02) as service:
            futs = [service.submit(q, spec, deadline_s=30.0) for q in queries[:12]]
            results = [f.result(timeout=30) for f in futs]
        direct = idx.knn_batch(queries[:12], 6)
        for got, want in zip(results, direct):
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.distances, want.distances)


class TestCloseSemantics:
    def test_close_drains_queued_requests_with_results(self, served_index):
        idx, _, queries = served_index
        slow = _SlowIndex(idx, delay_s=0.05)
        service = SearchService(slow, max_batch=4, max_wait_s=0.001)
        futs = [service.submit(q, Query.knn(3)) for q in queries[:10]]
        service.close()
        assert all(f.done() for f in futs)
        assert not any(f.cancelled() for f in futs)
        for f, want in zip(futs, idx.knn_batch(queries[:10], 3)):
            np.testing.assert_array_equal(f.result().ids, want.ids)

    def test_close_no_drain_fails_explicitly_never_cancels(self, served_index):
        idx, _, queries = served_index
        holder = {}
        # the in-flight batch leaves only once close() has begun
        gated = _GatedIndex(idx, release=lambda: holder["service"]._closing)
        service = holder["service"] = SearchService(gated, max_batch=1, max_wait_s=0.001)
        in_flight = service.submit(queries[0], Query.knn(3))
        assert gated.entered.wait(WAIT_S)
        queued = [service.submit(q, Query.knn(3)) for q in queries[1:5]]
        service.close(drain=False)
        assert in_flight.result(timeout=30) is not None
        for f in queued:
            assert not f.cancelled()
            with pytest.raises(ServiceClosed, match="before this request"):
                f.result(timeout=1)
        assert service.stats()["closed_rejects"] == len(queued)

    def test_submit_after_close_raises_service_closed(self, served_index):
        idx, _, queries = served_index
        service = SearchService(idx)
        service.close()
        with pytest.raises(ServiceClosed):
            service.submit(queries[0], Query.knn(3))


class TestStatsCounters:
    def test_bounded_queue_rejects_and_counts(self, served_index):
        idx, _, queries = served_index
        gated = _GatedIndex(idx)
        with SearchService(gated, max_batch=1, max_wait_s=0.001, max_queue=2) as service:
            head = service.submit(queries[0], Query.knn(3))
            assert gated.entered.wait(WAIT_S)          # head popped into its batch
            q1 = service.submit(queries[1], Query.knn(3))
            q2 = service.submit(queries[2], Query.knn(3))
            assert service.queue_depth() == 2
            with pytest.raises(ServiceOverloaded, match="queue is full"):
                service.submit(queries[3], Query.knn(3))
            assert service.stats()["rejected"] == 1
            gated.opened.set()
            for f in (head, q1, q2):
                f.result(timeout=30)
        st = service.stats()
        assert st["rejected"] == 1
        assert st["queue_depth"] == 0

    def test_estimated_wait_warms_after_first_batch(self, served_index):
        idx, _, queries = served_index
        with SearchService(idx, max_batch=4, max_wait_s=0.01) as service:
            assert service.estimated_wait_s() == 0.0
            service.submit(queries[0], Query.knn(3)).result(timeout=30)
            # the future resolves just before the batch is recorded
            deadline = time.perf_counter() + WAIT_S
            while service.stats()["n_batches"] < 1 and time.perf_counter() < deadline:
                time.sleep(0.001)
            assert service.estimated_wait_s() > 0.0
            st = service.stats()
        assert st["ewma_batch_ms"] > 0.0

    def test_per_spec_occupancy_accounting(self, served_index):
        idx, _, queries = served_index
        knn, rng_spec = Query.knn(4), Query.knn(9)
        with SearchService(idx, max_batch=64, max_wait_s=0.2) as service:
            futs = [service.submit(q, knn) for q in queries[:6]]
            futs += [service.submit(queries[6], rng_spec)]
            [f.result(timeout=30) for f in futs]
        st = service.stats()
        assert len(st["per_spec"]) == 2
        k4 = next(v for k, v in st["per_spec"].items() if '"k": 4' in k)
        k9 = next(v for k, v in st["per_spec"].items() if '"k": 9' in k)
        assert k4["n_requests"] == 6 and k4["max_occupancy"] >= 2
        assert k4["mean_occupancy"] == k4["n_requests"] / k4["n_batches"]
        assert k9 == {"n_batches": 1, "n_requests": 1, "mean_occupancy": 1.0, "max_occupancy": 1}


class TestResolveCorpus:
    class _FakeArgs:
        def __init__(self):
            self.n_objects = 999

    class _FakeIndex:
        def __init__(self, data):
            self._data = data

        def stats(self):
            return {"n_objects": len(self._data)}

        @property
        def data(self):
            return self._data

    def test_loaded_corpus_wins_without_mutating_args(self):
        from repro_torch.launch.serve import _resolve_corpus

        rows = colors_like(n=300, seed=8)
        idx = self._FakeIndex(rows[:250])
        args = self._FakeArgs()
        data, X, n_objects = _resolve_corpus(args.n_objects, 64, rows[:100], idx)
        assert args.n_objects == 999
        assert n_objects == 250
        np.testing.assert_array_equal(data, rows[:250])
        assert len(X) >= n_objects + 64

    def test_matching_sizes_keep_cli_pool(self):
        from repro_torch.launch.serve import _resolve_corpus

        rows = colors_like(n=120, seed=8)
        idx = self._FakeIndex(rows[:100])
        data, X, n_objects = _resolve_corpus(100, 16, rows, idx)
        assert n_objects == 100
        np.testing.assert_array_equal(X, rows)
        np.testing.assert_array_equal(data, rows[:100])

    def test_device_rows_come_back_to_the_host(self):
        """A port index keeps its rows on its device (a tensor); the
        resolved corpus is a host array of the same rows."""
        from repro_torch.launch.serve import _resolve_corpus

        rows = colors_like(n=120, seed=8)
        idx = self._FakeIndex(torch.as_tensor(rows[:100]))
        data, _, _ = _resolve_corpus(100, 16, rows, idx)
        assert isinstance(data, np.ndarray)
        np.testing.assert_array_equal(data, rows[:100])


# -- parity with the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    X = colors_like(n=732, seed=5).astype(np.float64)
    data, queries = X[:700], X[700:]
    with enable_x64(True):
        ref = rapi.build_index(data, "euclidean", n_pivots=8, seed=1, use_kernel=True)
    port = build_index(data, "euclidean", n_pivots=8, seed=1, device="cpu")
    return port, ref, queries


@pytest.mark.parametrize("k", [1, 5, 10])
def test_open_loop_answers_equal_reference(pair, k):
    """The same Poisson traffic through both packages' services: ids equal,
    distances within 1e-12, cost counts equal, every request served."""
    port, ref, queries = pair
    with SearchService(port, max_batch=8, max_wait_s=0.005) as svc:
        got = run_poisson_open_loop(svc, queries, Query.knn(k), arrival_rate=4000.0, seed=1)
        st = svc.stats()
    with enable_x64(True):
        with rservice.SearchService(ref, max_batch=8, max_wait_s=0.005) as rsvc:
            want = rservice.run_poisson_open_loop(rsvc, queries, rapi.Query.knn(k), arrival_rate=4000.0, seed=1)
            rst = rsvc.stats()
    assert st["n_requests"] == rst["n_requests"] == len(queries)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.distances, w.distances, rtol=0, atol=1e-12)
        assert g.stats.original_calls == w.stats.original_calls


def test_overload_counters_equal_reference(pair):
    """The same held queue in both services: the same depth, the same
    ServiceOverloaded rejection count, the same stats keys (less the
    reference's ``coalesced_fraction``, which the port does not report)."""
    port, ref, queries = pair
    out = []
    for svc_mod, idx, spec in ((None, port, Query.knn(3)), (rservice, ref, rapi.Query.knn(3))):
        gated = _GatedIndex(idx)
        cls = SearchService if svc_mod is None else svc_mod.SearchService
        with enable_x64(True):
            with cls(gated, max_batch=1, max_wait_s=0.001, max_queue=3) as svc:
                futs = [svc.submit(queries[0], spec)]
                assert gated.entered.wait(WAIT_S)
                futs += [svc.submit(q, spec) for q in queries[1:4]]
                rejected = 0
                for q in queries[4:7]:
                    try:
                        svc.submit(q, spec)
                    except RuntimeError:
                        rejected += 1
                depth = svc.queue_depth()
                gated.opened.set()
                [f.result(timeout=30) for f in futs]
            st = svc.stats()
        out.append((depth, rejected, st["rejected"], st["n_requests"], sorted(st)))
    # the port's stats() drops the reference's coalesced_fraction, which
    # nothing read; every other key is the reference's
    ref_keys = out[1][4]
    out[1] = out[1][:4] + ([key for key in ref_keys if key != "coalesced_fraction"],)
    assert "coalesced_fraction" in ref_keys
    assert out[0] == out[1]
