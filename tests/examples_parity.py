"""The checks the three ``tests/test_torch_examples_*.py`` files share: the
port's walkthroughs (``repro_torch.examples``) held to the JAX package's
``examples/`` scripts on the CPU.

Each reference script runs in a subprocess of its own
(``tests/examples_reference.py``); a file's runs all start at once, from a
module-scoped fixture (``reference_runs``), while the port's
``main(["--device", "cpu", ...])`` runs in the test process, once per
walkthrough (``PortRuns``).  The tolerances are
``repro_torch.examples.summary``'s: ids, counts, plan stages, shard rows,
WAL and live counts and grid shapes exact; f64 distances and thresholds
1e-12 relative; values measured in f32 on an f32 corpus (``*_f32``) 1e-6;
losses and the drift statistic 1e-5 of their magnitude.  On the CPU every
count holds exactly, whatever its margin.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import re

import examples_reference as er
import pytest
import torch

from repro_torch.examples import summary as S

#: the reference script's label that names the JAX package's kernel; the
#: port names its own (K6 is a CUDA kernel)
RENAMED = {"Pallas fused-bounds kernel decisions": "fused-bounds kernel decisions"}


def argv(name: str, workdir) -> list:
    """The port's flags for ``name``: the reference run's, a fresh
    checkpoint directory for ``train_lm``, and ``--device cpu``."""
    extra = ["--ckpt-dir", str(workdir / "port_ckpt")] if name == "train_lm" else []
    return ["--device", "cpu", *er.RUNS[name]["argv"], *extra]


class PortRuns:
    """The port's walkthroughs on the CPU, each run once: (summary, stdout)."""

    def __init__(self, workdir):
        self.workdir, self._done = workdir, {}

    def __call__(self, name: str) -> tuple:
        if name not in self._done:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                got = importlib.import_module(f"repro_torch.examples.{name}").main(argv(name, self.workdir))
            self._done[name] = (got, out.getvalue())
        return self._done[name]


def reference_runs(names, tmp_path_factory):
    """Every reference run of ``names`` started at once (a generator for a
    module-scoped fixture: the runs left are killed at its end)."""
    runs = {name: er.Run(name, str(tmp_path_factory.mktemp(f"ref_{name}"))) for name in names}
    try:
        yield runs
    finally:
        for run in runs.values():
            run.stop()


def labels(stdout: str) -> set:
    """The labels of a walkthrough's lines: the text before each line's
    first ':' (and before any '('), digits left out."""
    out = set()
    for line in stdout.splitlines():
        if ":" in line:
            label = re.sub(r"\d", "", line.split(":")[0].split("(")[0]).strip()
            out.add(RENAMED.get(label, label))
    return out


def _jsonable(v):
    return json.loads(json.dumps(v))


# -- the shared checks ---------------------------------------------------------
def port_equals_reference(name, reference, ported):
    """The port's own run against the reference's: every section, or for a
    ``BRIDGED`` walkthrough (its own random parameters) the exact one."""
    want, _ = reference[name].result()
    got, _ = ported(name)
    if name in S.BRIDGED:
        assert S.compare(got, want, sections=("exact",)) == []
        return
    assert S.compare(got, want) == []
    assert _jsonable(got["counts"]) == _jsonable(want["counts"])


def reference_params(run) -> dict:
    """The parameter tree a ``BRIDGED`` reference run initialised, as
    nested dicts of numpy arrays (``examples_reference``'s ``--params``)."""
    import numpy as np

    run.result()
    tree = {}
    with np.load(run.params) as npz:
        for key in npz.files:
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = npz[key]
    return tree


def json_is_a_fresh_reference_run(name, reference):
    fresh, _ = reference[name].result()
    stored = S.load_reference()[name]
    assert stored["reference_run"] == er.RUNS[name]
    assert _jsonable(fresh["exact"]) == stored["exact"]
    assert _jsonable(fresh["counts"]) == stored["counts"]
    assert S.compare(fresh, stored, sections=("close",)) == []


def port_prints_the_reference_labels(name, reference, ported):
    _, want = reference[name].result()
    _, got = ported(name)
    assert labels(got) == labels(want)


def device_defaults_to_cuda(name, monkeypatch, workdir):
    """Without ``--device`` the walkthrough asks for the card, and without
    one it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = [a for a in argv(name, workdir) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA device"):
        importlib.import_module(f"repro_torch.examples.{name}").main(flags)
