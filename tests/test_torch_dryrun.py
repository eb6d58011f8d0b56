"""The port's dry run (``python -m repro_torch.launch.dryrun``) on the CPU,
on one card (``--mesh card``): cells of a smoke arch (the registry arch
with its ``smoke_cfg`` and its shapes cut to 256 tokens and 4 sequences)
walked on meta tensors.  The production meshes are
``tests/test_torch_dryrun_mesh.py``'s.

* Train, prefill and decode cells of qwen2-1.5b (dense) and mixtral-8x7b
  (MoE) give ``status="ok"`` records with the argument, output and
  peak-live bytes and the roofline terms, and counted FLOPs within the
  reference's convention for ``model_flops`` (6·N·T to train, 2·N·T to
  prefill, 2·N per decoded token: the model's matmuls): at least 95% of it
  (the embedding gather is in N but is no matmul) and at most 4x (the
  counted matmuls add attention's scores and values, the remat forward and
  MoE capacity slots).
* The shallow-variant extrapolation (``calibrate_cell``, the reference's
  roofline v3) equals a direct walk of the full cell: the cost is linear in
  layers and microbatches, and an eager walk is exact.
* The paper's serve cell, whose step launches K4 and K3, cannot run on
  meta tensors and is recorded as an error with its reason.
"""

import dataclasses
import json

import pytest
import torch

import repro_torch.launch.steps as steps_mod
from repro_torch import configs as configs_mod
from repro_torch.launch import dryrun

torch.set_num_threads(1)

SMOKE_SEQ, SMOKE_BATCH = 256, 4


def _smoke_arch(get, layers=None):
    def get_smoke(arch_id):
        arch = get(arch_id)
        cfg = arch.smoke_cfg if layers is None else dataclasses.replace(arch.smoke_cfg, n_layers=layers)
        shapes = {}
        for name, sh in arch.shapes.items():
            sizes = dict(sh.sizes)
            if "seq_len" in sizes:
                sizes["seq_len"] = min(sizes["seq_len"], SMOKE_SEQ)
            if "global_batch" in sizes:
                sizes["global_batch"] = min(sizes["global_batch"], SMOKE_BATCH)
            shapes[name] = dataclasses.replace(sh, sizes=sizes)
        return dataclasses.replace(arch, model_cfg=cfg, shapes=shapes)
    return get_smoke


@pytest.fixture
def smoke(monkeypatch):
    get = _smoke_arch(configs_mod.get_arch)
    monkeypatch.setattr(steps_mod, "get_arch", get)
    monkeypatch.setattr(configs_mod, "get_arch", get)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
@pytest.mark.parametrize("shape,kind", [("train_4k", "train"), ("prefill_32k", "prefill"),
                                        ("decode_32k", "decode")])
def test_smoke_cell_record(smoke, tmp_path, arch, shape, kind):
    rec = dryrun.run_cell(arch, shape, "card", str(tmp_path), verbose=False, accum=1)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["kind"] == kind and rec["n_chips"] == 1
    flops, model = rec["op_walk"]["flops"], rec["model_flops"]
    assert 0.95 * model <= flops <= 4.0 * model, (flops, model)
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0 and mem["peak_live_bytes"] > 0
    roof = rec["roofline"]
    assert roof["compute_s"] == pytest.approx(flops / 989e12)
    assert roof["memory_s"] == pytest.approx(rec["op_walk"]["bytes_hbm"] / 3.35e12)
    assert roof["collective_s"] == 0.0 and roof["dominant"] in ("compute", "memory")
    assert rec["op_walk"]["collective_bytes"]["total"] == 0.0
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__card.json").read_text())
    assert on_disk["op_walk"] == rec["op_walk"]


def test_cut_accumulation_scales_model_flops(smoke):
    one = dryrun.run_cell("qwen2-1.5b", "train_4k", verbose=False, accum=1)
    two = dryrun.run_cell("qwen2-1.5b", "train_4k", verbose=False, accum=2)
    assert two["model_flops"] == 2 * one["model_flops"]
    # no matmul outside the microsteps: the optimizer step counts none
    assert two["op_walk"]["flops"] == 2 * one["op_walk"]["flops"]


def test_calibration_equals_the_full_walk(monkeypatch, tmp_path):
    get = _smoke_arch(configs_mod.get_arch, layers=6)
    monkeypatch.setattr(steps_mod, "get_arch", get)
    monkeypatch.setattr(configs_mod, "get_arch", get)
    cal = dryrun.calibrate_cell("qwen2-1.5b", "train_4k", "card", str(tmp_path))
    full = dryrun.run_cell("qwen2-1.5b", "train_4k", verbose=False)
    assert cal["status"] == "ok" and full["status"] == "ok"
    assert cal["accum_full"] == SMOKE_BATCH
    assert cal["extrapolated"]["flops"] == pytest.approx(full["op_walk"]["flops"], rel=1e-9)
    assert cal["extrapolated"]["bytes"] == pytest.approx(full["op_walk"]["bytes_hbm"], rel=1e-9)
    assert cal["roofline_v3"]["model_flops"] == full["model_flops"]
    assert (tmp_path / "qwen2-1.5b__train_4k__card__calib.json").exists()


def test_serve_cell_needs_the_card(smoke):
    rec = dryrun.run_cell("nsimplex-colors", "serve_1m", verbose=False)
    assert rec["status"] == "error" and rec["error"]


def test_main_walks_the_selected_cells(smoke, tmp_path, capsys):
    rc = dryrun.main(["--mesh", "card", "--arch", "qwen2-1.5b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[dryrun] OK qwen2-1.5b/decode_32k/card" in out and "0 failures" in out
