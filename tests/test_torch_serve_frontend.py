"""The port's HTTP/JSON front end (``repro_torch.serve.frontend``) end to end
on the CPU.

Twins every test of the JAX package's ``tests/test_serve_frontend.py`` on
``IndexRegistry(device="cpu")``: answers over HTTP bit-identical to the
port's own ``Index.query`` (JSON round trip included), the status mapping
(400 / 404 / 409 / 429 with ``Retry-After`` / 504), deadlines over the wire,
hot tenant operations and the durable write routes.  Every server binds
port 0 on 127.0.0.1.  Then parity with the JAX package: an index saved by
the reference and opened by the port with ``load_index`` (and the other way
round) is served by both packages' front ends; the answers carry equal ids
and counts and distances within 1e-12, and the request bodies the two
clients send are byte-equal.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro import api as rapi
from repro import serve as rserve
from repro.compat import enable_x64
from repro_torch.api import Query, build_index, load_index
from repro_torch.data import colors_like
from repro_torch.metrics import get_metric
from repro_torch.serve import Frontend, FrontendClient, FrontendError, IndexRegistry as _Registry
from repro_torch.serve.frontend import _result_payload, _spec_from_body

torch.set_num_threads(1)


def IndexRegistry(**kw):
    """The registry on the host path (its default device is the card)."""
    return _Registry(device="cpu", **kw)


class _SlowIndex:
    """Index wrapper whose query() sleeps: makes deadlines expire in flight
    and warms the service's wait estimate deterministically."""

    def __init__(self, inner, delay_s):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "delay_s", delay_s)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def query(self, *args, **kwargs):
        time.sleep(self.delay_s)
        return self._inner.query(*args, **kwargs)


@pytest.fixture(scope="module")
def stack():
    """Two-tenant registry behind a live frontend on an ephemeral port."""
    X = colors_like(n=1000, seed=43)
    metric = get_metric("euclidean")
    idx_a = build_index(X[:500], metric, kind="nsimplex", n_pivots=8, seed=1, device="cpu")
    idx_b = build_index(X[500:900], metric, kind="nsimplex", n_pivots=8, seed=2, device="cpu")
    registry = IndexRegistry(max_concurrent_batches=2, max_wait_s=0.005)
    registry.add("alpha", index=idx_a)
    registry.add("beta", index=idx_b)
    with Frontend(registry, port=0) as fe:
        host, port = fe.address
        # float64 queries: exactly what the JSON body decodes to
        yield FrontendClient(host, port), idx_a, idx_b, np.asarray(X[900:940], np.float64)


class TestEndToEnd:
    def test_healthz_and_tenants(self, stack):
        client, *_ = stack
        assert client.healthz() == {"status": "ok"}
        assert client.tenants() == ["alpha", "beta"]

    def test_two_tenants_bit_identical_over_http(self, stack):
        """The acceptance check, across the full JSON round-trip."""
        client, idx_a, idx_b, queries = stack
        for name, idx in (("alpha", idx_a), ("beta", idx_b)):
            for i in range(5):
                got = client.query(name, queries[i], k=7)
                want = idx.knn_batch(queries[i : i + 1], 7).results[0]
                assert got["ids"] == [int(x) for x in want.ids]
                assert got["distances"] == [float(d) for d in want.distances]
                assert got["approx"] is None and got["degraded"] is False
                assert got["stats"]["original_calls"] == want.stats.original_calls

    def test_range_query_over_http(self, stack):
        client, idx_a, _, queries = stack
        t = 0.35
        got = client.query("alpha", queries[0], task="range", threshold=t)
        want = idx_a.query(queries[0], Query.range(t))
        assert got["ids"] == [int(x) for x in want.ids]

    def test_approx_spec_fields_over_http(self, stack):
        client, idx_a, _, queries = stack
        got = client.query("alpha", queries[0], k=5, mode="approx", dims=4, refine=16)
        want = idx_a.query(queries[0], Query.knn(5, mode="approx", dims=4, refine=16))
        assert got["approx"] == {"dims": 4, "refine": 16}
        assert got["ids"] == [int(x) for x in want.ids]

    def test_stats_endpoint(self, stack):
        client, *_ = stack
        client.query("alpha", np.zeros(112) + 1e-3, k=3)
        st = client.stats()
        assert st["n_tenants"] == 2
        assert st["tenants"]["alpha"]["service"]["n_requests"] >= 1
        assert "telemetry" in st["tenants"]["alpha"]


class TestStatusMapping:
    def test_unknown_tenant_404(self, stack):
        client, *_, queries = stack
        with pytest.raises(FrontendError) as exc:
            client.query("ghost", queries[0], k=3)
        assert exc.value.status == 404

    def test_unknown_route_404(self, stack):
        client, *_ = stack
        with pytest.raises(FrontendError) as exc:
            client._request("GET", "/v2/nope")
        assert exc.value.status == 404

    def test_malformed_400(self, stack):
        client, *_, queries = stack
        for body in (
            {"q": [0.1], "k": 3},                               # missing tenant
            {"tenant": "alpha", "k": 3},                        # missing q
            {"tenant": "alpha", "q": [], "k": 3},               # empty q
            {"tenant": "alpha", "q": [0.1], "k": -2},           # invalid spec
            {"tenant": "alpha", "q": [0.1], "k": 3, "deadline_ms": -5},
        ):
            with pytest.raises(FrontendError) as exc:
                client._request("POST", "/v1/query", body)
            assert exc.value.status == 400, body

    def test_rate_limited_429_with_retry_after(self, stack):
        _, idx_a, *_ , queries = stack
        with IndexRegistry(max_wait_s=0.005) as registry:
            registry.add("limited", index=idx_a, rate=1.0, burst=1)
            with Frontend(registry, port=0) as fe:
                c2 = FrontendClient(*fe.address)
                c2.query("limited", queries[0], k=3)            # takes the token
                with pytest.raises(FrontendError) as exc:
                    c2.query("limited", queries[1], k=3)
        assert exc.value.status == 429
        assert exc.value.body["reason"] == "rate_limited"
        assert exc.value.retry_after_s > 0.0


class TestDeadlinesOverTheWire:
    @pytest.fixture()
    def slow_stack(self):
        """One deliberately slow tenant (120 ms/batch)."""
        X = colors_like(n=560, seed=47)
        idx = build_index(X[:512], get_metric("euclidean"), n_pivots=8, seed=1, device="cpu")
        registry = IndexRegistry(max_wait_s=0.005)
        registry.add("slow", index=_SlowIndex(idx, 0.12))
        with Frontend(registry, port=0) as fe:
            yield FrontendClient(*fe.address), idx, np.asarray(X[512:], np.float64)

    def test_expires_in_flight_504_peers_unaffected(self, slow_stack):
        client, idx, queries = slow_stack
        out, errs = {}, {}

        def call(i, deadline_ms):
            try:
                out[i] = client.query("slow", queries[i], k=3, deadline_ms=deadline_ms)
            except FrontendError as e:
                errs[i] = e

        # same spec, submitted together: they fuse; only the tight deadline dies
        threads = [
            threading.Thread(target=call, args=(0, 50)),
            threading.Thread(target=call, args=(1, None)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errs[0].status == 504
        assert errs[0].body["reason"] == "deadline_exceeded"
        want = idx.knn_batch(queries[1:2], 3).results[0]
        assert out[1]["ids"] == [int(x) for x in want.ids]
        assert out[1]["distances"] == [float(d) for d in want.distances]

    def test_infeasible_deadline_shed_429_never_queued(self, slow_stack):
        """Once the wait estimate is warm, a deadline it already breaks is
        shed at admission (429 + reason) without consuming a batch slot."""
        client, _, queries = slow_stack
        client.query("slow", queries[0], k=3)                  # warm the EWMA
        before = client.stats()["tenants"]["slow"]["service"]["n_requests"]
        with pytest.raises(FrontendError) as exc:
            client.query("slow", queries[1], k=3, deadline_ms=5)
        assert exc.value.status == 429
        assert exc.value.body["reason"] == "deadline_unmeetable"
        assert exc.value.retry_after_s > 0.0
        after = client.stats()["tenants"]["slow"]["service"]["n_requests"]
        assert after == before                                 # never executed


class TestHotTenantOps:
    def test_put_query_delete_cycle(self, stack, tmp_path):
        client, idx_a, *_ , queries = stack
        saved = tmp_path / "hot_idx"
        idx_a.save(str(saved))
        made = client.add_tenant("hot", str(saved), budget=10_000)
        assert made["tenant"] == "hot"
        assert made["index"]["n_objects"] == idx_a.stats()["n_objects"]
        got = client.query("hot", queries[0], k=5)
        want = idx_a.knn_batch(queries[:1], 5).results[0]
        assert got["ids"] == [int(x) for x in want.ids]
        # duplicate name -> 409
        with pytest.raises(FrontendError) as exc:
            client.add_tenant("hot", str(saved))
        assert exc.value.status == 409
        assert client.remove_tenant("hot") == {"removed": "hot"}
        assert "hot" not in client.tenants()
        with pytest.raises(FrontendError) as exc:
            client.query("hot", queries[0], k=5)
        assert exc.value.status == 404

    def test_put_missing_path_400(self, stack):
        client, *_ = stack
        with pytest.raises(FrontendError) as exc:
            client._request("PUT", "/v1/tenants/x", {})
        assert exc.value.status == 400

    def test_delete_unknown_404(self, stack):
        client, *_ = stack
        with pytest.raises(FrontendError) as exc:
            client.remove_tenant("never-existed")
        assert exc.value.status == 404


class TestWriteRoutes:
    """POST /v1/tenants/<name>/upsert and /remove: durable write-through
    over the wire, plus the full status mapping for the write path."""

    @pytest.fixture()
    def write_stack(self, tmp_path):
        X = colors_like(n=208, seed=47)
        idx = build_index(
            X[:200], get_metric("euclidean"), kind="nsimplex", n_pivots=6,
            seed=1, durable=True, wal_dir=str(tmp_path / "wal"),
            fsync_every=1, checkpoint_every=None, compact_threshold=None, device="cpu",
        )
        registry = IndexRegistry(max_wait_s=0.005)
        registry.add("online", index=idx)
        with Frontend(registry, port=0) as fe:
            yield FrontendClient(*fe.address), idx, np.asarray(X[200:], np.float64)

    def test_upsert_then_query_then_remove(self, write_stack):
        client, idx, extra = write_stack
        out = client.upsert("online", extra[:4])
        assert out["ids"] == [200, 201, 202, 203]
        assert out["n_objects"] == 204
        client.upsert("online", extra[4:5], ids=[201])      # targeted replace
        got = client.query("online", extra[4], k=1)
        assert got["ids"] == [201]
        out = client.remove_rows("online", [200, 203])
        assert out["removed"] == [200, 203]
        assert out["n_objects"] == 202
        # fsync_every=1: every acknowledged write is synced before the response
        assert out["wal_synced"] == idx.stats()["wal_records"]

    def test_unknown_tenant_404(self, write_stack):
        client, _, extra = write_stack
        with pytest.raises(FrontendError) as exc:
            client.upsert("ghost", extra[:1])
        assert exc.value.status == 404

    def test_immutable_tenant_409(self, stack):
        client, *_, queries = stack
        with pytest.raises(FrontendError) as exc:
            client.upsert("alpha", queries[:1])
        assert exc.value.status == 409
        assert "immutable" in exc.value.body["error"]

    def test_malformed_400(self, write_stack):
        client, *_ = write_stack
        for route, body in (
            ("upsert", {}),                                  # missing rows
            ("upsert", {"rows": []}),                        # empty rows
            ("upsert", {"rows": [[0.1, 0.2], [0.3]]}),       # ragged rows
            ("upsert", {"rows": [[0.1] * 3]}),               # wrong dim
            ("upsert", {"rows": [[0.1] * 112], "ids": ["a"]}),
            ("remove", {}),                                  # missing ids
            ("remove", {"ids": [999999]}),                   # unknown id
        ):
            with pytest.raises(FrontendError) as exc:
                client._request("POST", "/v1/tenants/online/" + route, body)
            assert exc.value.status == 400, (route, body)

    def test_write_shed_429_with_retry_after(self, write_stack, tmp_path):
        _, __, extra = write_stack
        X = colors_like(n=60, seed=48)
        idx = build_index(
            X, get_metric("euclidean"), kind="nsimplex", n_pivots=5, seed=2,
            durable=True, wal_dir=str(tmp_path / "wal2"),
            checkpoint_every=None, compact_threshold=None, device="cpu",
        )
        with IndexRegistry(max_wait_s=0.005) as registry:
            registry.add("limited", index=idx, rate=1.0, burst=1)
            with Frontend(registry, port=0) as fe:
                c2 = FrontendClient(*fe.address)
                c2.upsert("limited", extra[:1])              # takes the token
                with pytest.raises(FrontendError) as exc:
                    c2.upsert("limited", extra[1:2])
        assert exc.value.status == 429
        assert exc.value.body["reason"] == "rate_limited"
        assert exc.value.retry_after_s > 0.0
        assert idx.stats()["n_objects"] == 61                # shed write dropped


# -- parity with the JAX package ---------------------------------------------------


@pytest.fixture(scope="module")
def both_stacks(tmp_path_factory):
    """A JSD index built by the reference, saved, and opened by the port with
    ``load_index``; a euclidean index built by the port and opened by the
    reference.  Each package serves both behind its own front end."""
    tmp = tmp_path_factory.mktemp("fe_parity")
    X = colors_like(n=1232, seed=53).astype(np.float64)
    data, queries = X[:1200], X[1200:]
    with enable_x64(True):
        rapi.build_index(data, "jensen_shannon", n_pivots=10, seed=3, use_kernel=True).save(str(tmp / "jsd"))
        ref_jsd = rapi.load_index(str(tmp / "jsd"))
    build_index(data, "euclidean", n_pivots=10, seed=4, device="cpu").save(str(tmp / "eu"))
    with enable_x64(True):
        ref_eu = rapi.load_index(str(tmp / "eu"))
    port_reg = IndexRegistry(max_wait_s=0.005)
    port_reg.add("jsd", index=load_index(str(tmp / "jsd"), device="cpu"))
    port_reg.add("eu", path=str(tmp / "eu"))
    ref_reg = rserve.IndexRegistry(max_wait_s=0.005)
    ref_reg.add("jsd", index=ref_jsd)
    ref_reg.add("eu", index=ref_eu)
    with Frontend(port_reg, port=0) as pfe, rserve.Frontend(ref_reg, port=0) as rfe:
        yield FrontendClient(*pfe.address), rserve.FrontendClient(*rfe.address), port_reg, queries


def _same_answer(got, want):
    assert got["ids"] == want["ids"]
    assert (got["distances"] is None) == (want["distances"] is None)
    if got["distances"] is not None:
        np.testing.assert_allclose(got["distances"], want["distances"], rtol=0, atol=1e-12)
    for key in ("original_calls", "surrogate_calls", "candidates"):
        assert got["stats"][key] == want["stats"][key], key
    assert (got["approx"], got["degraded"]) == (want["approx"], want["degraded"])


@pytest.mark.parametrize("tenant", ["jsd", "eu"])
@pytest.mark.parametrize("fields", [
    dict(k=1), dict(k=10), dict(k=5, mode="approx", dims=5, refine=16), dict(task="range", threshold=0.08),
])
def test_http_answers_equal_reference(both_stacks, tenant, fields):
    pclient, rclient, _, queries = both_stacks
    for q in queries[:4]:
        with enable_x64(True):
            want = rclient.query(tenant, q, **fields)
        _same_answer(pclient.query(tenant, q, **fields), want)


def test_http_answer_bit_equal_to_own_query(both_stacks):
    """The port's HTTP answer equals its own index.query bit for bit."""
    pclient, _, port_reg, queries = both_stacks
    for name in ("jsd", "eu"):
        got = pclient.query(name, queries[5], k=7)
        want = port_reg.tenant(name).index.query(queries[5], Query.knn(7))
        assert got["ids"] == [int(i) for i in want.ids]
        assert got["distances"] == [float(d) for d in want.distances]


def test_wire_bodies_equal_reference():
    """The two packages parse the same bodies to equal specs and render equal
    results to byte-equal JSON (apart from the wall time)."""
    from repro.serve import frontend as rfrontend
    from repro.api.types import QueryResult as RResult, QueryStats as RStats
    from repro_torch.api.types import QueryResult, QueryStats

    bodies = [
        {"tenant": "t", "q": [0.1], "k": 3},
        {"tenant": "t", "q": [0.1], "task": "range", "threshold": 0.2, "mode": "exact"},
        {"tenant": "t", "q": [0.1], "k": 4, "mode": "approx", "dims": 3, "refine": 9, "budget": 50},
        {"tenant": "t", "q": [0.1], "k": 2, "where": {"clauses": [{"attr": "a", "op": "eq", "values": [1]}]}},
    ]
    for body in bodies:
        assert _spec_from_body(body).to_dict() == rfrontend._spec_from_body(body).to_dict()
    ids, dists = np.array([3, 1, 7]), np.array([0.1, 0.2 + 1e-17, 1 / 3])
    kw = dict(original_calls=12, surrogate_calls=300, candidates=5, bound_width=0.25)
    decision = type("D", (), {"degraded": True})()
    got = _result_payload(QueryResult(ids=ids, distances=dists, stats=QueryStats(**kw), approx=None), decision, 0.0)
    want = rfrontend._result_payload(RResult(ids=ids, distances=dists, stats=RStats(**kw), approx=None), decision, 0.0)
    got.pop("elapsed_ms"), want.pop("elapsed_ms")
    assert json.dumps(got) == json.dumps(want)
