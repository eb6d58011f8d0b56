"""``python -m repro_torch.launch.serve`` as a subprocess, on the CPU.

Mirrors ``tests/test_api.py::test_serve_batch_smoke`` for the port's CLI at
the sizes of the verify recipe: the default shard_map engine, and
``--engine batch`` with every workload (threshold, knn with a save / load
round trip, online on a sharded mutable index, approx, service, frontend),
the sharded device filter and a durable store recovered from its WAL
directory.  Each run passes ``--device cpu``; without it and without a card
the CLI raises instead of falling back to the CPU.  The shard_map engine's
answers equal the JAX package's CLI at the same size (the same results and
rechecks line); the flags are the reference's plus ``--device``; serving
imports neither jax nor ``repro``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _serve(*argv, module="repro_torch.launch.serve", timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True, env=env,
                         cwd=str(ROOT), timeout=timeout)
    return out


def _ok(*argv):
    out = _serve(*argv, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _line(stdout, needle):
    return next(line for line in stdout.splitlines() if needle in line)


def test_shard_map_engine_equals_reference():
    argv = ("--n-objects", "3000", "--queries", "16", "--batches", "1", "--metric", "euclidean")
    got = _ok(*argv)
    want = _serve(*argv, module="repro.launch.serve")
    assert want.returncode == 0, want.stderr[-4000:]
    for needle in ("threshold", "16 queries:"):
        # the same words and numbers up to the wall time
        assert _line(got, needle).split(", ")[0] == _line(want.stdout, needle).split(", ")[0]
    assert _line(got, "rechecks").split("), ")[0] == _line(want.stdout, "rechecks").split("), ")[0]
    assert "had more candidates than the 256 slots" in got


@pytest.mark.parametrize("metric", ["euclidean", "jensen_shannon"])
def test_batch_threshold(metric):
    out = _ok("--engine", "batch", "--n-objects", "4000", "--queries", "32", "--batches", "2", "--metric", metric)
    assert "admitted bound-only" in out and "[serve] plan:" in out


def test_batch_knn_save_then_load(tmp_path):
    common = ("--engine", "batch", "--workload", "knn", "--k", "10", "--n-objects", "4000", "--queries", "32",
              "--batches", "1", "--metric", "euclidean")
    saved = _ok(*common, "--save-index", str(tmp_path / "srv.idx"))
    assert (tmp_path / "srv.idx" / "manifest.json").exists()
    loaded = _ok(*common, "--load-index", str(tmp_path / "srv.idx"))
    # persistence restores bit-identical state: the same evals per query
    evals = [_line(o, "knn queries").split(", ")[1] for o in (saved, loaded)]
    assert evals[0] == evals[1] and "true-metric evals/query" in evals[0]


def test_batch_online_sharded():
    out = _ok("--engine", "batch", "--workload", "online", "--n-objects", "2500", "--queries", "16", "--batches",
              "2", "--pivots", "10", "--shards", "2", "--metric", "euclidean")
    assert "[serve] online: 32 inserts" in out and "(2532 live objects)" in out


def test_batch_sharded_device_filter():
    out = _ok("--engine", "batch", "--n-objects", "3000", "--queries", "16", "--batches", "2", "--metric",
              "euclidean", "--selectivity", "1e-2", "--shards", "4")
    line = _line(out, "admitted bound-only")
    assert int(line.split("(")[1].split()[0]) > 0, line


def test_batch_approx():
    out = _ok("--engine", "batch", "--workload", "approx", "--n-objects", "3000", "--queries", "16", "--batches",
              "2", "--pivots", "12", "--metric", "euclidean")
    assert "[serve] approx knn (k=10, dims=6/12, refine=" in out and "recall@10" in out


def test_batch_service():
    out = _ok("--engine", "batch", "--workload", "service", "--n-objects", "3000", "--queries", "16", "--batches",
              "2", "--pivots", "10", "--metric", "euclidean")
    assert "[serve] service: 32 requests" in out and "latency p50" in out


def test_batch_frontend():
    out = _ok("--engine", "batch", "--workload", "frontend", "--n-objects", "3000", "--queries", "16", "--batches",
              "2", "--pivots", "10", "--metric", "euclidean", "--deadline-ms", "5000", "--arrival-rate", "500")
    assert "per-tenant responses bit-identical to direct Index.query" in out
    assert "[serve] frontend: 32/32 served (0 shed, 0 expired" in out


def test_batch_durable_recovers(tmp_path):
    wal = str(tmp_path / "wal")
    common = ("--engine", "batch", "--n-objects", "2000", "--queries", "8", "--batches", "1", "--pivots", "8",
              "--metric", "euclidean", "--durable", "--wal-dir", wal)
    built = _ok(*common, "--workload", "online")
    assert "[serve] online: 8 inserts" in built
    back = _ok(*common, "--workload", "knn")
    assert f"recovered durable store from {wal}" in back and "'n_objects': 2008" in back


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    out = _serve("--n-objects", "600", "--queries", "4", "--batches", "1", "--metric", "euclidean")
    assert out.returncode != 0 and "CUDA device" in out.stderr


def test_flags_are_the_reference_flags_plus_device():
    flags = {}
    for module in ("repro.launch.serve", "repro_torch.launch.serve"):
        out = _serve("--help", module=module)
        assert out.returncode == 0, out.stderr[-2000:]
        flags[module] = set(re.findall(r"(--[a-z][a-z-]*)", out.stdout))
    assert flags["repro_torch.launch.serve"] == flags["repro.launch.serve"] | {"--device"}


def test_serving_imports_neither_jax_nor_repro():
    code = (
        "import sys, numpy as np\n"
        "from repro_torch.api import Query, build_index\n"
        "from repro_torch.serve import Frontend, FrontendClient, IndexRegistry\n"
        "import repro_torch.launch.serve\n"
        "x = np.random.default_rng(0).random((300, 8))\n"
        "reg = IndexRegistry(device='cpu')\n"
        "reg.add('t', index=build_index(x, n_pivots=5, device='cpu'))\n"
        "with Frontend(reg, port=0) as fe:\n"
        "    assert len(FrontendClient(*fe.address).query('t', x[0], k=3)['ids']) == 3\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "isolated" in out.stdout, out.stderr[-2000:]
