"""``python -m repro_torch.launch.train`` on the CPU (``--device cpu
--smoke``): the JAX package's ``launch/train.py`` flags plus ``--device``,
the loss falling over the run, a resume from the run's checkpoints, the
reference's closing line, and the default device (the card) raising
without one."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train
from repro_torch.train import loop as loop_mod

ROOT = Path(__file__).resolve().parent.parent


class FakeClock:
    """A stand-in for the ``time`` module of ``repro_torch.train.loop``:
    every ``perf_counter`` call advances one tick, so every step lasts the
    same and the straggler count does not hang on the host's load."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        t = self.now
        self.now += 1e-3
        return t


def test_smoke_run_lowers_the_loss_and_resumes(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(loop_mod, "time", FakeClock())
    args = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "12", "--seq", "32", "--batch", "4",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--checkpoint-every", "5"]
    m = train.main(args)
    assert m.steps_run == 12 and m.failures_recovered == 0 and m.restored_from is None
    assert m.losses[-1] < m.losses[0]
    assert sorted(os.listdir(tmp_path)) == ["step_0000000005", "step_0000000010", "step_0000000012"]
    out = capsys.readouterr().out
    assert "[train] qwen2-1.5b-smoke:" in out and "1 device (cpu)" in out
    assert "[train] done: 12 steps, loss" in out and "recoveries=0, stragglers=0" in out
    # a second run over more steps resumes from step 12 and runs only the rest
    m2 = train.main(args[:4] + ["16"] + args[5:])
    assert m2.restored_from == 12 and m2.steps_run == 4


def test_cli_as_a_subprocess(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mixtral-8x7b", "--smoke", "--steps", "6",
         "--seq", "16", "--batch", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("[train] done: 6 steps, loss ") and "recoveries=0" in lines[-1]
    assert not any(m in out.stderr for m in ("import jax", "No module named"))


def test_non_lm_arch_is_refused():
    with pytest.raises(SystemExit, match="trains LM archs"):
        train.main(["--arch", "fm", "--smoke", "--steps", "1", "--device", "cpu"])


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
