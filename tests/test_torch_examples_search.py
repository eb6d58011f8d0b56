"""The port's search walkthroughs (``repro_torch.examples``: quickstart,
expensive_metric_search, quality_tradeoff, filtered_search, kernel_tuning)
against the JAX package's ``examples/`` scripts, on the CPU; the checks and
their tolerances are ``tests/examples_parity.py``'s.  Also: no module of
``repro_torch.examples`` imports jax or the JAX package, or works at import,
and a walkthrough runs as ``python -m``."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import examples_parity as parity
import pytest

NAMES = ("quickstart", "expensive_metric_search", "quality_tradeoff", "filtered_search", "kernel_tuning")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    yield from parity.reference_runs(NAMES, tmp_path_factory)


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    return parity.PortRuns(tmp_path_factory.mktemp("port"))


@pytest.mark.parametrize("name", NAMES)
def test_port_equals_reference(name, reference, ported):
    parity.port_equals_reference(name, reference, ported)


@pytest.mark.parametrize("name", NAMES)
def test_reference_summaries_json_is_a_fresh_reference_run(name, reference):
    parity.json_is_a_fresh_reference_run(name, reference)


@pytest.mark.parametrize("name", NAMES)
def test_port_prints_the_reference_labels(name, reference, ported):
    parity.port_prints_the_reference_labels(name, reference, ported)


@pytest.mark.parametrize("name", NAMES)
def test_device_defaults_to_cuda(name, monkeypatch, tmp_path):
    parity.device_defaults_to_cuda(name, monkeypatch, tmp_path)


def test_examples_import_neither_jax_nor_the_jax_package():
    """No module of ``repro_torch.examples`` names ``jax`` or ``repro`` in
    an import statement (at any depth); every one imports in a fresh
    process with no such module loaded, and does no work at import (the
    reference's quality_tradeoff and kernel_tuning run theirs there)."""
    import ast
    import glob

    from repro_torch.examples import WALKTHROUGHS

    for path in glob.glob(os.path.join(ROOT, "src", "repro_torch", "examples", "*.py")):
        with open(path) as f:
            for node in ast.walk(ast.parse(f.read())):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")], (path, names)

    code = (
        "import sys, time; t0 = time.perf_counter()\n"
        f"for n in {list(WALKTHROUGHS) + ['summary']!r}: __import__('repro_torch.examples.' + n)\n"
        "dt = time.perf_counter() - t0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(dt)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert float(r.stdout.split()[-1]) < 20.0


def test_quickstart_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.examples.quickstart", "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "all verified vs brute force" in r.stdout and time.perf_counter() - t0 < 120


def test_k6_decisions_lie_clear_of_the_threshold(reference, ported):
    """expensive_metric_search's K6 decisions hang on f32 bounds (one ulp
    apart between the packages for 15-35% of rows): no row's f64 bound lies
    within the f32 band of t, so the decision counts must be equal."""
    got, _ = ported("expensive_metric_search")
    want, _ = reference["expensive_metric_search"].result()
    assert got["margins"]["k6_decisions"] == 0
    assert got["counts"]["k6_decisions"] == want["counts"]["k6_decisions"] == [7445, 0, 55]
