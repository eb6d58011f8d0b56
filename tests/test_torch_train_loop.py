"""The fault-tolerant loop of the port (``repro_torch.train.TrainLoop``) on
the CPU: the ``tests/test_train_infra.py::TestFaultTolerantLoop`` cases on
the same toy (a 3-weight least-squares fit, AdamW lr 0.05, checkpoints
every 5 steps) with the same failure hooks, run by both packages on the
same batches.  ``steps_run``, ``failures_recovered``, ``straggler_steps``
and ``restored_from`` are equal, and the losses agree at rtol 1e-5.

Both loops read one deterministic clock (``FakeClock``, patched in as the
``time`` of both loop modules): every ``perf_counter`` call advances it one
tick, so every step lasts one tick and the straggler watchdog's count is
exact, not a matter of the host's load."""

import jax
import jax.numpy as jnp
import repro.train.loop as ref_loop_mod
import numpy as np
import pytest
import torch

from repro.train import AdamWConfig as RAdamW, LoopConfig as RLoopConfig, TrainLoop as RTrainLoop
from repro.train import apply_updates as rapply, init_state as rinit
import repro_torch.train.loop as port_loop_mod
from repro_torch.models.params import value_and_grad
from repro_torch.train import AdamWConfig, LoopConfig, LoopMetrics, TrainLoop, apply_updates, init_state

LOSS_RTOL = 1e-5
TARGET = np.array([1.0, -2.0, 3.0], np.float32)


class FakeClock:
    """A stand-in for the ``time`` module: ``perf_counter`` returns the
    current reading and then advances it one tick; ``stall(n)`` adds n ticks
    to the step in progress."""

    TICK = 1e-3

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        t = self.now
        self.now += self.TICK
        return t

    def stall(self, ticks):
        self.now += ticks * self.TICK


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(ref_loop_mod, "time", fake)
    monkeypatch.setattr(port_loop_mod, "time", fake)
    return fake


def _batch(step):
    x = np.array(jax.random.normal(jax.random.PRNGKey(step), (32, 3)))
    return x, (x @ TARGET).astype(np.float32)


def _ref_loop(tmp_path, failure_hook=None, total=20):
    cfg = RAdamW(lr=0.05, warmup_steps=0, total_steps=total, moment_dtype="float32", weight_decay=0.0)

    @jax.jit
    def step_fn(state, batch):
        params, opt = state
        l, g = jax.value_and_grad(lambda p: jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2))(params)
        params, opt, _ = rapply(cfg, params, g, opt)
        return (params, opt), {"loss": l}

    def data_fn(step):
        x, y = _batch(step)
        return {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    params = {"w": jnp.zeros((3,))}
    return RTrainLoop(RLoopConfig(total_steps=total, checkpoint_every=5, checkpoint_dir=str(tmp_path / "ref"),
                                  max_retries=5),
                      step_fn, data_fn, (params, rinit(cfg, params)), failure_hook=failure_hook)


def _port_loop(tmp_path, failure_hook=None, total=20):
    cfg = AdamWConfig(lr=0.05, warmup_steps=0, total_steps=total, moment_dtype="float32", weight_decay=0.0)

    def step_fn(state, batch):
        params, opt = state
        l, g = value_and_grad(lambda p: torch.mean((batch["x"] @ p["w"] - batch["y"]) ** 2), params)
        params, opt, _ = apply_updates(cfg, params, g, opt)
        return (params, opt), {"loss": l}

    def data_fn(step):
        x, y = _batch(step)
        return {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}

    params = {"w": torch.zeros(3)}
    return TrainLoop(LoopConfig(total_steps=total, checkpoint_every=5, checkpoint_dir=str(tmp_path / "port"),
                                max_retries=5),
                     step_fn, data_fn, (params, init_state(cfg, params)), failure_hook=failure_hook)


def _both(tmp_path, make_hook=lambda: None, total=20):
    return (_ref_loop(tmp_path, make_hook(), total).run(), _port_loop(tmp_path, make_hook(), total).run())


def _agree(ref: LoopMetrics, got: LoopMetrics):
    for f in ("steps_run", "failures_recovered", "restored_from"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.straggler_steps == 0 and ref.straggler_steps == 0
    np.testing.assert_allclose(got.losses, ref.losses, rtol=LOSS_RTOL)


def test_loss_decreases(tmp_path):
    ref, got = _both(tmp_path)
    _agree(ref, got)
    assert got.steps_run == 20 and got.losses[-1] < got.losses[0]


def test_injected_failure_recovers(tmp_path):
    def make_hook():
        fired = {"done": False}

        def bomb(step):
            if step == 12 and not fired["done"]:
                fired["done"] = True
                raise RuntimeError("simulated chip failure")
        return bomb

    ref, got = _both(tmp_path, make_hook)
    _agree(ref, got)
    # restored to step 10 then replayed: more steps executed than total
    assert got.failures_recovered == 1 and got.steps_run >= 20
    assert got.losses[-1] < got.losses[0]


def test_restart_resumes_from_checkpoint(tmp_path):
    _both(tmp_path, total=10)
    ref, got = _both(tmp_path, total=15)
    _agree(ref, got)
    assert got.restored_from == 10 and got.steps_run == 5  # only the remaining steps


def test_one_slow_step_is_one_straggler(tmp_path, clock):
    """Step 12 lasts ten ticks against a median of one: both watchdogs count
    exactly one straggler (the straggler factor is 3)."""
    def make_hook():
        def slow(step):
            if step == 12:
                clock.stall(9)
        return slow

    ref, got = _both(tmp_path, make_hook)
    for f in ("steps_run", "failures_recovered", "restored_from"):
        assert getattr(got, f) == getattr(ref, f), f
    assert ref.straggler_steps == 1 and got.straggler_steps == 1
    np.testing.assert_allclose(got.losses, ref.losses, rtol=LOSS_RTOL)


def test_repeated_failure_aborts(tmp_path):
    def always_bomb(step):
        if step >= 3:
            raise RuntimeError("persistent fault")

    for loop in (_ref_loop(tmp_path, always_bomb), _port_loop(tmp_path, always_bomb)):
        with pytest.raises(RuntimeError, match="failed 6 times"):
            loop.run()


def test_non_finite_loss_restores(tmp_path):
    """A NaN loss counts as a failure and restores the newest checkpoint."""
    loop = _port_loop(tmp_path, total=8)
    inner = loop.step_fn
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        state, m = inner(state, batch)
        return state, ({"loss": torch.tensor(float("nan"))} if calls["n"] == 7 else m)

    loop.step_fn = flaky
    m = loop.run()
    assert m.failures_recovered == 1 and m.steps_run == 8 + 1 and np.isfinite(m.losses).all()


def test_default_checkpoint_dir_is_under_the_temp_dir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert LoopConfig(total_steps=1).checkpoint_dir.startswith(str(tmp_path))
