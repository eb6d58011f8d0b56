"""The port's serving and model walkthroughs (``repro_torch.examples``:
service_demo, frontend_demo, retrieval_recsys, train_lm at ``--steps 3``)
against the JAX package's ``examples/`` scripts, on the CPU; the checks and
their tolerances are ``tests/examples_parity.py``'s.  Timings (QPS, p50,
p99, the deadline shed) are not compared.  retrieval_recsys and train_lm
initialise from ``jax.random.PRNGKey(0)`` in the reference: their ``run``
takes the reference's own parameters (``repro_torch.models.convert``), and
the losses step by step (1e-5 of their magnitude), each user's top-10 ids
and its scored and pruned counts must equal the reference's."""

from __future__ import annotations

import argparse

import examples_parity as parity
import pytest
import torch

from repro_torch.examples import retrieval_recsys, summary as S, train_lm
from repro_torch.models.convert import from_reference

NAMES = ("service_demo", "frontend_demo", "retrieval_recsys", "train_lm")
CPU = torch.device("cpu")


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


def test_retrieval_recsys_on_the_reference_parameters(reference):
    from repro_torch.configs import get_arch

    cfg = get_arch("sasrec").smoke_cfg
    got = retrieval_recsys.run(from_reference(cfg, parity.reference_params(reference["retrieval_recsys"]),
                                              device=CPU), cfg, CPU)
    want, _ = reference["retrieval_recsys"].result()
    assert S.compare(got, want) == []


def test_train_lm_on_the_reference_parameters(reference, tmp_path):
    cfg = train_lm.config(False)
    args = argparse.Namespace(steps=3, batch=8, seq=128, ckpt_dir=str(tmp_path / "ckpt"))
    got = train_lm.run(from_reference(cfg, parity.reference_params(reference["train_lm"]), device=CPU),
                       cfg, args, CPU)
    want, _ = reference["train_lm"].result()
    assert S.compare(got, want) == []


def test_train_lm_has_its_own_checkpoint_directory():
    """TrainLoop resumes from the newest checkpoint in its directory: the
    port's default is its own, never the reference's."""
    assert train_lm.DEFAULT_CKPT_DIR != "/tmp/repro_lm_ckpt"
    assert "repro_torch" in train_lm.DEFAULT_CKPT_DIR
