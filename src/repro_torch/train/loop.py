"""Fault-tolerant training loop, the JAX package's host code as it is:

  * periodic checkpointing through ``CheckpointManager`` (atomic, keep-k),
  * failure handling: any exception inside a step (injected in tests via
    ``failure_hook``) triggers restore-from-latest + continue; repeated
    failures at the same step abort after ``max_retries``,
  * straggler watchdog: per-step wall times tracked; steps slower than
    ``straggler_factor`` x running median are logged and counted,
  * resume: ``run()`` restores the newest checkpoint onto the devices of
    the initial state (or ``sharding_tree``'s placements).

Reading the step's loss to the host is the loop's one host sync per step.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.train.checkpoint import CheckpointManager

__all__ = ["LoopConfig", "LoopMetrics", "TrainLoop"]

log = logging.getLogger("repro_torch.train")


def _default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(default_factory=_default_checkpoint_dir)
    keep_checkpoints: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0


@dataclasses.dataclass
class LoopMetrics:
    steps_run: int = 0
    failures_recovered: int = 0
    straggler_steps: int = 0
    restored_from: Optional[int] = None
    losses: list = dataclasses.field(default_factory=list)


class TrainLoop:
    def __init__(
        self,
        cfg: LoopConfig,
        step_fn: Callable,                 # (state, batch) -> (state, metrics)
        data_fn: Callable[[int], Any],     # step -> batch
        init_state: Any,
        *,
        sharding_tree: Any = None,
        failure_hook: Optional[Callable[[int], None]] = None,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.state = init_state
        self.sharding_tree = sharding_tree
        self.failure_hook = failure_hook
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
        self.metrics = LoopMetrics()
        self._durations: list = []

    # -- resume -----------------------------------------------------------------
    def resume(self) -> int:
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        self.state, step = self.ckpt.restore(self.state, sharding_tree=self.sharding_tree)
        self.metrics.restored_from = step
        log.info("resumed from checkpoint step %d", step)
        return step

    # -- main -------------------------------------------------------------------
    def run(self, start_step: Optional[int] = None) -> LoopMetrics:
        step = self.resume() if start_step is None else start_step
        retries = 0
        while step < self.cfg.total_steps:
            batch = self.data_fn(step)
            t0 = time.perf_counter()
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)  # may raise (injected fault)
                self.state, m = self.step_fn(self.state, batch)
                loss = float(m.get("loss", np.nan))
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
            except Exception as e:  # noqa: BLE001 - any device/host fault
                retries += 1
                self.metrics.failures_recovered += 1
                log.warning("step %d failed (%s); restoring (retry %d)", step, e, retries)
                if retries > self.cfg.max_retries:
                    raise RuntimeError(f"step {step} failed {retries} times") from e
                latest = self.ckpt.latest_step()
                if latest is not None:
                    self.state, step = self.ckpt.restore(self.state, sharding_tree=self.sharding_tree)
                continue
            retries = 0
            dt = time.perf_counter() - t0
            self._durations.append(dt)
            med = float(np.median(self._durations[-50:]))
            if len(self._durations) > 5 and dt > self.cfg.straggler_factor * med:
                self.metrics.straggler_steps += 1
                log.warning("straggler step %d: %.3fs vs median %.3fs", step, dt, med)
            self.metrics.losses.append(loss)
            self.metrics.steps_run += 1
            step += 1
            if step % self.cfg.checkpoint_every == 0 or step == self.cfg.total_steps:
                self.ckpt.save(step, self.state)
        return self.metrics
