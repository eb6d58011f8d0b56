"""The port's online and scale-out walkthroughs (``repro_torch.examples``:
online_updates, mesh_scaleout) against the JAX package's ``examples/``
scripts, on the CPU; the checks and their tolerances are
``tests/examples_parity.py``'s.  mesh_scaleout's grid names four positions
of the host through ``ShardedIndex.configure_grid``, where the reference
forces four host devices; the grid shapes printed must be the reference's."""

from __future__ import annotations

import examples_parity as parity
import pytest

NAMES = ("online_updates", "mesh_scaleout")


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


def test_mesh_scaleout_grids_are_the_references_four_device_layouts(ported):
    got, _ = ported("mesh_scaleout")
    assert got["exact"]["grid_shapes"] == [{"data": 4}, {"replica": 2, "data": 2}, {"replica": 4, "data": 1}]
    assert got["exact"]["devices"] == 4
