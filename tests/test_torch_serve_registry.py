"""The port's multi-tenant registry (``repro_torch.serve.registry``) on the
CPU.

Twins every test of the JAX package's ``tests/test_registry.py`` on
``IndexRegistry(device="cpu")`` (tenant isolation under concurrent traffic,
hot add / remove, per-tenant defaults and telemetry, admission, the durable
write path and recovery by ``add(path=...)``), then the witness of the
durable telemetry repair: a durable tenant's telemetry calibrates from its
queries, as a plain tenant's does, and the registry's default device is the
card (it raises without one).
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.api import Query, QueryOptions, build_index
from repro_torch.data import colors_like
from repro_torch.metrics import get_metric
from repro_torch.serve import AdmissionRejected, IndexRegistry as _Registry, UnknownTenant

torch.set_num_threads(1)


def IndexRegistry(**kw):
    """The registry on the host path (its default device is the card)."""
    return _Registry(device="cpu", **kw)


@pytest.fixture(scope="module")
def corpora():
    X = colors_like(n=1000, seed=13)
    metric = get_metric("euclidean")
    idx_a = build_index(X[:500], metric, kind="nsimplex", n_pivots=8, seed=1, device="cpu")
    idx_b = build_index(X[500:900], metric, kind="nsimplex", n_pivots=8, seed=2, device="cpu")
    return idx_a, idx_b, X[900:940]


class TestTenantIsolation:
    def test_two_tenants_concurrent_bit_identity(self, corpora):
        """The acceptance check: concurrent traffic across two tenants
        answers bit-identically to direct per-index batched calls."""
        idx_a, idx_b, queries = corpora
        spec = Query.knn(5)
        out = {}
        with IndexRegistry(max_concurrent_batches=2, max_wait_s=0.01) as registry:
            registry.add("alpha", index=idx_a)
            registry.add("beta", index=idx_b)

            def client(name, i):
                fut, _ = registry.submit(name, queries[i], spec)
                out[(name, i)] = fut.result(timeout=30)

            threads = [
                threading.Thread(target=client, args=(name, i))
                for i in range(10)
                for name in ("alpha", "beta")
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        direct_a = idx_a.knn_batch(queries[:10], 5)
        direct_b = idx_b.knn_batch(queries[:10], 5)
        for i in range(10):
            np.testing.assert_array_equal(out[("alpha", i)].ids, direct_a.results[i].ids)
            np.testing.assert_array_equal(
                out[("alpha", i)].distances, direct_a.results[i].distances
            )
            np.testing.assert_array_equal(out[("beta", i)].ids, direct_b.results[i].ids)
            np.testing.assert_array_equal(
                out[("beta", i)].distances, direct_b.results[i].distances
            )

    def test_tenants_never_share_batches(self, corpora):
        idx_a, idx_b, queries = corpora
        with IndexRegistry(max_wait_s=0.2) as registry:
            registry.add("alpha", index=idx_a)
            registry.add("beta", index=idx_b)
            futs = [
                registry.submit("alpha" if i % 2 == 0 else "beta", queries[i], Query.knn(3))[0]
                for i in range(8)
            ]
            [f.result(timeout=30) for f in futs]
            st = registry.stats()
        assert st["tenants"]["alpha"]["service"]["n_requests"] == 4
        assert st["tenants"]["beta"]["service"]["n_requests"] == 4


class TestLifecycle:
    def test_add_requires_exactly_one_source(self, corpora):
        idx_a, _, _ = corpora
        with IndexRegistry() as registry:
            with pytest.raises(ValueError, match="exactly one"):
                registry.add("x")
            with pytest.raises(ValueError, match="exactly one"):
                registry.add("x", index=idx_a, path="/nowhere")

    def test_duplicate_name_rejected(self, corpora):
        idx_a, idx_b, _ = corpora
        with IndexRegistry() as registry:
            registry.add("alpha", index=idx_a)
            with pytest.raises(ValueError, match="already registered"):
                registry.add("alpha", index=idx_b)
            assert registry.names() == ["alpha"]

    def test_unknown_tenant(self, corpora):
        _, _, queries = corpora
        with IndexRegistry() as registry:
            with pytest.raises(UnknownTenant):
                registry.tenant("ghost")
            with pytest.raises(UnknownTenant):
                registry.submit("ghost", queries[0], Query.knn(3))
            with pytest.raises(UnknownTenant):
                registry.remove("ghost")

    def test_hot_add_from_saved_index(self, corpora, tmp_path):
        """PUT-style registration: load a persisted index directory into a
        fresh tenant and serve from it immediately."""
        idx_a, _, queries = corpora
        saved = tmp_path / "alpha_idx"
        idx_a.save(str(saved))
        with IndexRegistry(max_wait_s=0.01) as registry:
            tenant = registry.add("hot", path=str(saved))
            assert tenant.index.stats()["n_objects"] == idx_a.stats()["n_objects"]
            fut, _ = registry.submit("hot", queries[0], Query.knn(5))
            got = fut.result(timeout=30)
        want = idx_a.knn_batch(queries[:1], 5).results[0]
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.distances, want.distances)

    def test_hot_remove_drains_then_name_reusable(self, corpora):
        idx_a, idx_b, queries = corpora
        with IndexRegistry(max_wait_s=0.01) as registry:
            registry.add("t", index=idx_a)
            fut, _ = registry.submit("t", queries[0], Query.knn(3))
            registry.remove("t")               # drains: future resolves
            assert fut.result(timeout=30) is not None
            assert registry.names() == []
            registry.add("t", index=idx_b)     # the name is free again
            assert registry.names() == ["t"]

    def test_close_rejects_further_adds(self, corpora):
        idx_a, _, _ = corpora
        registry = IndexRegistry()
        registry.close()
        with pytest.raises(RuntimeError, match="closed"):
            registry.add("x", index=idx_a)


class TestTenantDefaults:
    def test_per_tenant_budget_applies(self, corpora):
        """A per-tenant eval budget set via QueryOptions flips that tenant's
        auto-mode plans to the truncated path; other tenants are untouched."""
        X = colors_like(n=1100, seed=17)
        metric = get_metric("euclidean")
        idx_small = build_index(X[:1000], metric, kind="nsimplex", n_pivots=8, seed=1, device="cpu")
        idx_plain = build_index(X[:1000], metric, kind="nsimplex", n_pivots=8, seed=1, device="cpu")
        with IndexRegistry(max_wait_s=0.01) as registry:
            # exact estimate = 8 + max(3, 0.02 * 1000) = 28 > budget 10
            registry.add("budgeted", index=idx_small,
                         query_options=QueryOptions(budget=10, dims=4))
            registry.add("plain", index=idx_plain)
            spec = Query.knn(3)
            got_b = registry.submit("budgeted", X[1000], spec)[0].result(timeout=30)
            got_p = registry.submit("plain", X[1000], spec)[0].result(timeout=30)
        assert got_b.approx is not None        # budget forced truncation
        assert got_p.approx is None            # no budget: exact

    def test_telemetry_attached_and_fed(self, corpora):
        idx_a, _, queries = corpora
        with IndexRegistry(max_wait_s=0.01) as registry:
            tenant = registry.add("t", index=idx_a)
            assert tenant.telemetry is not None
            registry.submit("t", queries[0], Query.knn(3))[0].result(timeout=30)
            costs = tenant.stats()["telemetry"]
        assert costs and next(iter(costs.values()))["n_samples"] >= 1

    def test_telemetry_optional(self, corpora):
        idx_a, _, _ = corpora
        with IndexRegistry() as registry:
            tenant = registry.add("t", index=idx_a, telemetry=False)
            assert tenant.telemetry is None
            assert tenant.stats()["telemetry"] is None


class TestAdmissionIntegration:
    def test_rate_limited_submit_raises(self, corpora):
        idx_a, _, queries = corpora
        with IndexRegistry(max_wait_s=0.01) as registry:
            registry.add("t", index=idx_a, rate=1.0, burst=1)
            fut, decision = registry.submit("t", queries[0], Query.knn(3))
            assert decision.admitted
            with pytest.raises(AdmissionRejected) as exc:
                registry.submit("t", queries[1], Query.knn(3))
            assert exc.value.decision.reason == "rate_limited"
            assert exc.value.decision.retry_after_s > 0.0
            fut.result(timeout=30)

    def test_stats_snapshot_shape(self, corpora):
        idx_a, idx_b, queries = corpora
        with IndexRegistry(max_concurrent_batches=3) as registry:
            registry.add("a", index=idx_a)
            registry.add("b", index=idx_b)
            registry.submit("a", queries[0], Query.knn(3))[0].result(timeout=30)
            st = registry.stats()
        assert st["n_tenants"] == 2
        assert st["max_concurrent_batches"] == 3
        assert sorted(st["tenants"]) == ["a", "b"]
        for ts in st["tenants"].values():
            assert {"index", "service", "admission", "telemetry"} <= set(ts)
            assert "shed_fraction" in ts["admission"]
            assert "queue_depth" in ts["service"]


class TestWritePath:
    """Registry write-through: admission-checked upsert/remove on durable
    tenants, WAL flush on drain, and recovery via ``add(path=wal_dir)``."""

    @staticmethod
    def _durable(tmp_path, name="wal", n=200, seed=29):
        from repro_torch.api import load_index  # noqa: F401 — surface check

        X = colors_like(n=n + 8, seed=seed)
        idx = build_index(
            X[:n], get_metric("euclidean"), kind="nsimplex", n_pivots=6,
            seed=1, durable=True, wal_dir=str(tmp_path / name),
            fsync_every=4, checkpoint_every=None, compact_threshold=None, device="cpu",
        )
        return idx, X[n:]

    def test_upsert_and_remove_write_through(self, tmp_path):
        idx, extra = self._durable(tmp_path)
        with IndexRegistry(max_wait_s=0.01) as registry:
            registry.add("t", index=idx)
            ids = registry.upsert("t", extra[:4])
            assert list(ids) == [200, 201, 202, 203]
            registry.upsert("t", extra[4:5], ids=[201])     # targeted replace
            registry.remove_rows("t", [200])
            got = registry.submit("t", extra[1], Query.knn(3))[0].result(timeout=30)
            assert len(got.ids) == 3
            st = registry.tenant("t").stats()
            assert st["index"]["n_objects"] == 203
            assert st["admission"]["writes_admitted"] == 3
        # registry close drains => the WAL is fully synced on disk
        assert idx.stats()["wal_records"] == idx.stats()["wal_synced"]

    def test_write_burst_shed_like_reads(self, tmp_path):
        idx, extra = self._durable(tmp_path)
        with IndexRegistry(max_wait_s=0.01) as registry:
            registry.add("t", index=idx, rate=1.0, burst=1)
            registry.upsert("t", extra[:1])                 # drains the bucket
            with pytest.raises(AdmissionRejected) as exc:
                registry.upsert("t", extra[1:2])
            assert exc.value.decision.reason == "rate_limited"
            assert exc.value.decision.retry_after_s > 0.0
            st = registry.tenant("t").stats()["admission"]
            assert st["writes_rejected"] == 1
        # the shed write never reached the log
        assert idx.stats()["n_objects"] == 201

    def test_immutable_tenant_rejected(self, corpora):
        from repro_torch.serve import ImmutableTenant

        idx_a, _, queries = corpora
        with IndexRegistry() as registry:
            registry.add("frozen", index=idx_a)
            with pytest.raises(ImmutableTenant, match="immutable"):
                registry.upsert("frozen", queries[:1])
            with pytest.raises(ImmutableTenant):
                registry.remove_rows("frozen", [0])

    def test_hot_add_recovers_durable_store(self, tmp_path):
        """``add(path=...)`` pointed at a durable store dir (has CURRENT)
        recovers via WAL replay and serves bit-identically."""
        idx, extra = self._durable(tmp_path, name="walr")
        idx.add(extra[:4])
        idx.remove(np.asarray([0, 7], dtype=np.int64))
        want = idx.knn_batch(np.atleast_2d(extra[5]), 5).results[0]
        idx.close()
        with IndexRegistry(max_wait_s=0.01) as registry:
            tenant = registry.add("rec", path=str(tmp_path / "walr"))
            assert tenant.index.kind == "durable"
            got = registry.submit("rec", extra[5], Query.knn(5))[0].result(timeout=30)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.distances, want.distances)


# -- the durable telemetry repair ----------------------------------------------------


def test_durable_tenant_telemetry_calibrates(tmp_path):
    """A durable index executes each query on one read view; its OWN
    telemetry (not the view's) must observe it, so the planner, which reads
    the durable index's telemetry, flips to the calibrated estimate."""
    X = colors_like(n=1040, seed=29)
    idx = build_index(X[:1000], get_metric("euclidean"), n_pivots=8, seed=1, durable=True,
                      wal_dir=str(tmp_path / "wal"), checkpoint_every=None, device="cpu")
    spec = Query.knn(5, budget=10_000)
    with IndexRegistry(max_wait_s=0.01) as registry:
        tenant = registry.add("t", index=idx)
        assert idx.plan(spec).explain()["calibration"]["source"] == "static_prior"
        for q in X[1000:1008]:
            registry.submit("t", q, spec)[0].result(timeout=30)
        costs = tenant.stats()["telemetry"]
        assert costs["nsimplex/knn/exact"]["n_samples"] == 8
        assert idx.plan(spec).explain()["calibration"]["source"] == "telemetry_ewma"
    direct = idx.query(X[1010], spec)
    assert idx.telemetry.stage_costs()["nsimplex/knn/exact"]["n_samples"] == 9
    assert direct.stats.original_calls > 0
    idx.close()


def test_registry_defaults_to_the_card():
    if torch.cuda.is_available():
        assert _Registry().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            _Registry()


def test_serve_exports_the_reference_names():
    import repro.serve as rserve
    import repro_torch.serve as serve

    assert sorted(serve.__all__) == sorted(rserve.__all__)
    assert all(hasattr(serve, name) for name in serve.__all__)
