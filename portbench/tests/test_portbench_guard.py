import sys
import types

import pytest

from portbench import bench


def test_the_port_is_not_the_jax_package():
    import repro_torch.api  # noqa: F401

    assert "repro_torch" in {m.split(".")[0] for m in sys.modules}
    assert bench.forbidden_loaded() == []


@pytest.mark.parametrize("name", ["repro", "repro.api", "jax", "jaxlib", "flax"])
def test_a_forbidden_module_is_named(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bench.forbidden_loaded() == [name.split(".")[0]]


def test_no_card_no_result(capsys):
    from portbench import run

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would proceed")
    assert run.main(["--workload", "colors112k-eu.knn-exact", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "CUDA device" in out.err
