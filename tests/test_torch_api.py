"""The port's unified API against the JAX package's, on the CPU: build and
query, plans, id filters, persistence both ways, the serving runtime, the
device policy, and the port's isolation from jax and ``repro``."""

import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.compat import enable_x64
from repro_torch.api import Query, build_index, load_index
from repro_torch.launch.service import SearchService

# small shapes: one intra-op thread keeps these tests from crowding the
# other pytest workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _stats(s):
    return (s.original_calls, s.surrogate_calls, s.accepted_no_check, s.candidates)


@pytest.fixture(scope="module")
def pair():
    from repro.data import colors_like

    X = colors_like(n=1212, seed=31).astype(np.float64)
    data, queries = X[:1200], X[1200:]
    with enable_x64(True):
        ref = rapi.build_index(data, "jensen_shannon", n_pivots=12, seed=3, use_kernel=True)
    port = build_index(data, "jensen_shannon", n_pivots=12, seed=3, device="cpu")
    return port, ref, data, queries


def _same(got, want, dists=True):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got.ids, want.ids)
    if dists:
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-12, atol=1e-12)
    assert _stats(got.stats) == _stats(want.stats)


@pytest.mark.parametrize("spec", [Query.knn(1), Query.knn(10), Query.range(0.12)])
def test_query_batch_and_single(pair, spec):
    port, ref, _, queries = pair
    rspec = rapi.Query(task=spec.task, k=spec.k, threshold=spec.threshold)
    for g, w in zip(port.query(queries, spec), ref.query(queries, rspec)):
        _same(g, w, dists=spec.task == "knn")
    _same(port.query(queries[0], spec), ref.query(queries[0], rspec), dists=spec.task == "knn")


EXPLAIN_SPECS = [
    dict(task="knn", k=10),
    dict(task="range", threshold=0.1),
    dict(task="range", threshold=(0.1, 0.2)),
    dict(task="knn", k=5, mode="exact"),
    dict(task="knn", k=5, budget=10),
    dict(task="knn", k=5, budget=10_000),
    dict(task="knn", k=5, mode="approx", dims=4),
    dict(task="range", threshold=0.1, mode="approx", dims=3, refine=7),
    dict(task="knn", k=5, deny=(3, 1)),
    dict(task="range", threshold=0.1, deny=(2,)),
    dict(task="knn", k=5, allow=(1, 2, 3)),
]


@pytest.mark.parametrize("kw", EXPLAIN_SPECS)
def test_explain_equals_reference(pair, kw):
    port, ref, _, _ = pair
    assert port.plan(Query(**kw)).explain() == ref.plan(rapi.Query(**kw)).explain()


def test_allow_and_deny(pair):
    port, ref, _, queries = pair
    for kw in (dict(allow=(4, 9, 17, 1500)), dict(deny=(5, 6, 7))):
        spec, rspec = Query.knn(4, **kw), rapi.Query.knn(4, **kw)
        for g, w in zip(port.query(queries, spec), ref.query(queries, rspec)):
            _same(g, w)
        spec, rspec = Query.range(0.15, **kw), rapi.Query.range(0.15, **kw)
        for g, w in zip(port.query(queries, spec), ref.query(queries, rspec)):
            _same(g, w, dists="allow" in kw)


def test_cross_load_both_ways(pair, tmp_path):
    port, ref, _, queries = pair
    ref.save(tmp_path / "ref")
    port.save(tmp_path / "port")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    with enable_x64(True):
        from_port = rapi.load_index(tmp_path / "port")
    np.testing.assert_array_equal(from_ref.table.numpy(), ref.table)
    np.testing.assert_array_equal(from_port.table, port.table.numpy())
    spec, rspec = Query.knn(10), rapi.Query.knn(10)
    want = ref.query(queries, rspec)
    for g, w in zip(from_ref.query(queries, spec), want):
        _same(g, w)
    for g, w in zip(from_port.query(queries, rspec), port.query(queries, spec)):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.distances, w.distances, rtol=1e-12, atol=1e-12)
    assert from_ref.stats() == ref.stats()


def test_search_service_coalesces_bit_identically(pair):
    port, _, _, queries = pair
    spec = Query.knn(7)
    direct = port._inner.knn_batch(queries, 7)
    with SearchService(port, max_batch=8, max_wait_s=0.05) as svc:
        svc.warmup(spec, queries[0])
        futures = [svc.submit(q, spec) for q in queries]
        results = [f.result(timeout=60) for f in futures]
        st = svc.stats()
    assert st["max_batch_occupancy"] >= 2
    for r, (ids, d, s) in zip(results, direct):
        np.testing.assert_array_equal(r.ids, ids)
        np.testing.assert_array_equal(r.distances, d)
        assert _stats(r.stats) == _stats(s)


def test_search_service_deadlines_and_close(pair):
    from repro_torch.launch.service import DeadlineExceeded, ServiceClosed

    port, _, _, queries = pair
    svc = SearchService(port, max_batch=4, max_wait_s=0.01)
    late = svc.submit(queries[0], Query.knn(3), deadline_s=1e-9)
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=60)
    assert svc.submit(queries[1], Query.knn(3)).result(timeout=60).ids.shape == (3,)
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit(queries[2], Query.knn(3))
    st = svc.stats()
    assert st["expired"] == 1 and st["n_requests"] == 1


def test_default_device_raises_without_a_card(pair):
    _, _, data, _ = pair
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(data[:50], n_pivots=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(ROOT / "does-not-matter")


@pytest.mark.parametrize("kw", [dict(durable=True), dict(durable=True, mutable=True)])
def test_unported_options_raise(pair, kw, tmp_path):
    """Every option of the JAX package's ``build_index`` is ported now; the
    durable composite (tests/test_torch_store.py) raises as the JAX
    package's does without its ``wal_dir=``, and builds with it."""
    _, _, data, _ = pair
    with pytest.raises(ValueError, match="requires wal_dir"):
        build_index(data[:50], n_pivots=4, device="cpu", **kw)
    idx = build_index(data[:50], n_pivots=4, device="cpu", wal_dir=str(tmp_path / "w"), **kw)
    assert idx.kind == "durable" and idx.stats()["n_objects"] == 50
    idx.close()


@pytest.fixture(scope="module", params=["sharded", "sharded-mutable"])
def composite(request, pair):
    """The reference suite's composite kinds: the same corpus as ``pair``
    in three shards, plain or mutable, fan-out sequential (the counts of an
    overlapped fan-out depend on completion order in both packages)."""
    _, _, data, queries = pair
    kw = dict(n_pivots=12, seed=3, shards=3, mutable=request.param == "sharded-mutable", fanout_workers=0)
    with enable_x64(True):
        ref = rapi.build_index(data, "jensen_shannon", use_kernel=True, **kw)
    port = build_index(data, "jensen_shannon", device="cpu", **kw)
    # the device filter on as many CPU positions as the reference's mesh has
    # devices (four when a module forcing a 4-device host platform was
    # imported first): slot overflows, so the counts, follow them
    port.configure_grid([torch.device("cpu")] * jax.device_count())
    return port, ref, data, queries


@pytest.mark.parametrize("spec", [Query.knn(1), Query.knn(10), Query.range(0.12)])
def test_composite_query_batch_and_single(composite, spec):
    port, ref, _, queries = composite
    rspec = rapi.Query(task=spec.task, k=spec.k, threshold=spec.threshold)
    for g, w in zip(port.query(queries, spec), ref.query(queries, rspec)):
        _same(g, w, dists=spec.task == "knn")
    _same(port.query(queries[0], spec), ref.query(queries[0], rspec), dists=spec.task == "knn")


@pytest.mark.parametrize("kw", EXPLAIN_SPECS)
def test_composite_explain_equals_reference(composite, kw):
    port, ref, _, _ = composite
    assert port.plan(Query(**kw)).explain() == ref.plan(rapi.Query(**kw)).explain()


def test_composite_cross_load_both_ways(composite, tmp_path):
    port, ref, _, queries = composite
    ref.save(tmp_path / "ref")
    port.save(tmp_path / "port")
    from_ref = load_index(tmp_path / "ref", device="cpu")
    from_ref.configure_grid([torch.device("cpu")] * jax.device_count())
    with enable_x64(True):
        from_port = rapi.load_index(tmp_path / "port")
    assert from_ref.stats()["n_shards"] == 3 and from_port.stats()["n_shards"] == 3
    spec, rspec = Query.knn(10), rapi.Query.knn(10)
    for g, w in zip(from_ref.query(queries, spec), ref.query(queries, rspec)):
        _same(g, w)
    for g, w in zip(from_port.query(queries, rspec), port.query(queries, spec)):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_allclose(g.distances, w.distances, rtol=1e-12, atol=1e-12)


def test_sharded_mutable_approx_smoke(tmp_path):
    """mode='approx' composes through both composite layers: the config
    propagates, mutations keep serving, persistence nests it; answers equal
    the reference's where every straddler is re-ranked (refine = corpus)."""
    from repro.data import colors_like

    data = colors_like(n=900, seed=21).astype(np.float64)
    queries = colors_like(n=8, seed=22).astype(np.float64)
    idx = build_index(data, "euclidean", n_pivots=10, seed=5, shards=3, mutable=True, apex_dims=5, refine=40,
                      device="cpu")
    r = idx.knn(queries[0], 10)
    assert r.approx == {"dims": 5, "refine": 40} and r.stats.bound_width > 0.0 and len(r) == 10
    assert all(x.approx == {"dims": 5, "refine": 40} for x in idx.search_batch(queries, 0.08))
    new_ids = idx.add(queries[:3])
    idx.remove(new_ids[:1])
    assert all(x.approx == {"dims": 5, "refine": 40} for x in idx.knn_batch(queries, 5))
    idx.save(tmp_path / "shmu.idx")
    loaded = load_index(tmp_path / "shmu.idx", device="cpu")
    assert loaded.approx == {"dims": 5, "refine": 40}
    r3 = loaded.knn(queries[0], 5)
    assert r3.approx == {"dims": 5, "refine": 40}
    np.testing.assert_array_equal(r3.ids, idx.knn(queries[0], 5).ids)
    kw = dict(n_pivots=10, seed=5, shards=3, mutable=True, apex_dims=5, refine=len(data), fanout_workers=0)
    with enable_x64(True):
        ref = rapi.build_index(data, "euclidean", use_kernel=True, **kw)
    port = build_index(data, "euclidean", device="cpu", **kw)
    for g, w in zip(port.knn_batch(queries, 10), ref.knn_batch(queries, 10)):
        _same(g, w)


def test_where_and_approx_raise(pair):
    """A ``where=`` that is not a predicate (or its dict form) raises, as
    does an attributes= that is not a store; an approx query needs a
    truncation dimension from the query, the index's options or its build."""
    port, _, data, queries = pair
    with pytest.raises(ValueError, match="clauses"):
        Query.knn(3, where={"eq": ["color", 1]})
    with pytest.raises(TypeError, match="AttributeStore"):
        build_index(data[:50], n_pivots=4, device="cpu", attributes=object())
    with pytest.raises(ValueError, match="truncation dimension"):
        port.query(queries, Query.knn(3, mode="approx"))


def test_port_imports_neither_jax_nor_repro(tmp_path):
    code = (
        "import sys, numpy as np\n"
        "from repro_torch.api import build_index, Query\n"
        "from repro_torch.launch.service import SearchService\n"
        "x = np.random.default_rng(0).random((300, 8))\n"
        "idx = build_index(x, n_pivots=5, device='cpu')\n"
        "assert len(idx.query(x[:2], Query.knn(3))) == 2\n"
        "from repro_torch.store import open_durable\n"
        f"wal = {str(tmp_path / 'wal')!r}\n"
        "live = build_index(x, n_pivots=5, durable=True, wal_dir=wal, device='cpu')\n"
        "live.add(x[:3] * 0.5); live.flush(); live.close()\n"
        "back = open_durable(wal, device='cpu')\n"
        "assert back.stats()['n_objects'] == 303 and back.query(x[:2], Query.knn(3)).results[0].ids.size == 3\n"
        "import torch\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.data import token_stream\n"
        "from repro_torch.models import transformer as tf\n"
        "cfg = get_arch('qwen2-1.5b').smoke_cfg\n"
        "toks, _ = token_stream(1, 8, cfg.vocab, seed=0)\n"
        "logits, cache = tf.prefill(tf.init_params(cfg, device='cpu'), cfg, torch.as_tensor(toks))\n"
        "assert logits.shape == (1, cfg.vocab) and bool(torch.isfinite(logits).all())\n"
        "import repro_torch.train, repro_torch.launch.steps, repro_torch.launch.train, repro_torch.launch.mesh\n"
        "from repro_torch.models.params import value_and_grad\n"
        "params = tf.init_params(cfg, device='cpu')\n"
        "opt = repro_torch.train.init_state(repro_torch.train.AdamWConfig(), params)\n"
        "t = torch.as_tensor(toks)\n"
        "loss, g = value_and_grad(lambda p: tf.loss_fn(p, cfg, t, t)[0], params)\n"
        "repro_torch.train.apply_updates(repro_torch.train.AdamWConfig(), params, g, opt)\n"
        "plan = repro_torch.launch.steps.build_cell('qwen2-1.5b', 'train_4k', repro_torch.launch.mesh.make_production_mesh())\n"
        "assert plan.kind == 'train' and bool(torch.isfinite(loss))\n"
        "from repro_torch.core import NSimplexProjector, measure_distortion\n"
        "from repro_torch.baselines import jl_project\n"
        "from repro_torch.launch import dryrun, op_walk, roofline\n"
        "from repro_torch.kernels import tuning\n"
        "proj = NSimplexProjector(x[:5], __import__('repro_torch.metrics').metrics.get_metric('euclidean'), mode='solve', device='cpu')\n"
        "assert measure_distortion(proj.metric, x, proj, n_pairs=100, device='cpu')[0] >= 1.0\n"
        "assert tuning.lookup('apex_topk', 20, 10, torch.float32) == tuning.DEFAULT_CONFIG\n"
        "assert roofline.roofline_terms(flops_per_device=1.0, bytes_per_device=1.0, collective_bytes_per_chip=0.0, n_chips=1, model_flops=1.0)['dominant']\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "isolated" in out.stdout, out.stderr


def test_sources_name_no_jax_or_repro_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro(\s|$|\.|,)|from repro(\s|\.))", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
