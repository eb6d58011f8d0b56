"""Serving on the card.

Marked ``gpu``; without a CUDA device every test skips (decided inside the
``cuda`` fixture).  Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_serve.py

Held: a registry on the card (euclidean and jensen_shannon tenants, a
durable tenant written through the registry) answering concurrent requests
with the ids, counts and (within 1e-12) distances of the same registry on
the CPU, its telemetry calibrating the planner; the HTTP front end on the
card equal to the CPU's; the serving step's K3 slots bit-equal to its plain
selection (``selection="sort"``: K1 and a stable sort) for both projections;
the CLI's shard_map engine on the card answering as on the CPU.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.api import Query, build_index
from repro_torch.core import NSimplexProjector, select_pivots
from repro_torch.data import colors_like
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.metrics import get_metric
from repro_torch.search.distributed import build_serve_step
from repro_torch.serve import Frontend, FrontendClient, IndexRegistry
from repro_torch.sharding import make_scaleout_mesh

pytestmark = pytest.mark.gpu

N, NQ = 3000, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m gpu")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def corpus():
    X = colors_like(n=N + NQ + 64, seed=61).astype(np.float64)
    return X[:N], X[N:N + NQ], X[N + NQ:]


def _same(got, want):
    """Ids equal and distances within 1e-12.  The cost counts are not held:
    concurrent requests fuse into blocks that differ from run to run, and the
    kernel path's f32 slack (so a query's count) hangs on its block."""
    np.testing.assert_array_equal(got.ids, want.ids)
    if want.distances is not None:
        np.testing.assert_allclose(got.distances, want.distances, rtol=0, atol=1e-12)


def _serve_all(registry, name, queries, spec):
    out = [None] * len(queries)

    def client(i):
        out[i] = registry.submit(name, queries[i], spec)[0].result(timeout=120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("metric", ["euclidean", "jensen_shannon"])
def test_registry_on_card_equals_cpu(cuda, corpus, metric, tmp_path):
    data, queries, extra = corpus
    answers = {}
    for dev in ("cpu", "cuda"):
        reg = IndexRegistry(max_concurrent_batches=4, max_wait_s=0.005, device=dev)
        reg.add("plain", index=build_index(data, metric, n_pivots=12, seed=3, device=dev))
        reg.add("durable", index=build_index(data, metric, n_pivots=12, seed=3, durable=True,
                                             wal_dir=str(tmp_path / dev), checkpoint_every=None, device=dev))
        reg.upsert("durable", extra[:32])
        reg.remove_rows("durable", [5, 7, N + 3])
        reset_launches()
        answers[dev] = {name: _serve_all(reg, name, queries, Query.knn(10)) for name in ("plain", "durable")}
        if dev == "cuda":
            assert LAUNCHES["apex_topk"] > 0 or LAUNCHES["apex_bounds_batch"] > 0
            # a fused block counts its padded rows as samples
            costs = reg.tenant("durable").stats()["telemetry"]
            assert costs["nsimplex/knn/exact"]["n_samples"] >= NQ
            spec = Query.knn(10, budget=10_000)
            assert reg.tenant("durable").index.plan(spec).explain()["calibration"]["source"] == "telemetry_ewma"
        reg.close()
    for name in ("plain", "durable"):
        for g, w in zip(answers["cuda"][name], answers["cpu"][name]):
            _same(g, w)


def test_frontend_on_card_equals_cpu(cuda, corpus):
    data, queries, _ = corpus
    got = {}
    for dev in ("cpu", "cuda"):
        reg = IndexRegistry(max_wait_s=0.005, device=dev)
        reg.add("jsd", index=build_index(data, "jensen_shannon", n_pivots=12, seed=3, device=dev))
        with Frontend(reg, port=0) as fe:
            client = FrontendClient(*fe.address)
            got[dev] = [client.query("jsd", q, k=7) for q in queries[:8]]
            got[dev] += [client.query("jsd", q, k=5, mode="approx", dims=6, refine=32) for q in queries[8:]]
    for g, w in zip(got["cuda"], got["cpu"]):
        assert g["ids"] == w["ids"] and g["approx"] == w["approx"]
        np.testing.assert_allclose(g["distances"], w["distances"], rtol=0, atol=1e-12)
        assert g["stats"]["original_calls"] == w["stats"]["original_calls"]


@pytest.mark.parametrize("projection", ["gemm", "paper"])
def test_serve_step_k3_slots_bit_equal_to_sort(cuda, corpus, projection):
    data, queries, _ = corpus
    m = get_metric("jensen_shannon")
    proj = NSimplexProjector(select_pivots(data, 20, seed=0), m, device=cuda)
    rows = torch.as_tensor(data, device=cuda)
    table = proj.project_distances(proj.pivot_distances(rows)).float()
    qd = proj.pivot_distances(torch.as_tensor(queries, device=cuda)).float()
    consts = [torch.as_tensor(a, dtype=torch.float32, device=cuda) for a in (proj.Linv, proj.sq_norms, proj.sigma)]
    mesh = make_scaleout_mesh()
    t = float(np.quantile(m.cross(torch.as_tensor(queries[:4], device=cuda), rows[:2000]).cpu().numpy(), 0.01))
    outs = {}
    for selection in ("topk", "sort"):
        serve = build_serve_step(mesh, n_pivots=20, max_candidates=256, projection=projection, selection=selection)
        reset_launches()
        outs[selection] = serve(table, *consts, qd, t)
        if selection == "topk":
            assert LAUNCHES["apex_threshold"] == len(mesh.devices[0])
            assert (LAUNCHES["apex_project"] > 0) == (projection == "gemm")
    for g, w in zip(outs["topk"], outs["sort"]):
        assert torch.equal(g, w)
    assert (outs["topk"][0][:, 1] + outs["topk"][0][:, 2] > 0).any()


def test_cli_shard_map_on_card_equals_cpu(cuda):
    from repro_torch.launch import serve

    argv = ["--n-objects", "20000", "--queries", "16", "--batches", "2", "--metric", "jensen_shannon",
            "--selectivity", "1e-4"]
    got = serve.main(argv)
    want = serve.main(argv + ["--device", "cpu"])
    assert got["threshold"] == pytest.approx(want["threshold"], rel=1e-12)
    assert got["overflowing"] == want["overflowing"]
    fits = (want["hist"][:, 1] + want["hist"][:, 2]) <= want["max_candidates"]
    assert fits.any()
    for g, w, ok in zip(got["answers"], want["answers"], fits):
        if ok:          # an overflowing query keeps the slots' rows, an f32 tie may pick others
            np.testing.assert_array_equal(g, w)
