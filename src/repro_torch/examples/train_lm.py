"""End-to-end LM training: a ~100M-parameter transformer for a few
hundred steps with the full production loop (checkpointing,
fault-tolerant restart, straggler watchdog).

    python -m repro_torch.examples.train_lm --steps 300                  # on the card
    python -m repro_torch.examples.train_lm --steps 3 --device cpu       # on the host
    python -m repro_torch.examples.train_lm --full-100m --steps 20       # lm-100m on the card

The reduced ~5M config (lm-10m) by default; ``--full-100m`` is lm-100m
(12 layers, d_model 768), the walkthrough's full width (the JAX package's
``examples/train_lm.py``).  ``TrainLoop`` resumes from the newest
checkpoint it finds in ``--ckpt-dir``, so the default directory is the
port's own (never the reference's ``/tmp/repro_lm_ckpt``); pass a fresh one
for a run from step 0.  ``main`` draws the initial parameters from a seeded
``torch.Generator``; ``run`` takes any parameters, such as the JAX
package's own carried across by ``repro_torch.models.convert.from_reference``.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.data.synthetic import token_stream
from repro_torch.examples.summary import parse, summary
from repro_torch.models import transformer as tf
from repro_torch.models.params import value_and_grad
from repro_torch.train import AdamWConfig, LoopConfig, TrainLoop, apply_updates, init_state

#: the port's own checkpoint directory (``--ckpt-dir``'s default)
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt")


def config(full_100m: bool) -> tf.TransformerConfig:
    if full_100m:
        return tf.TransformerConfig(
            name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv=4,
            d_head=64, d_ff=2048, vocab=32_000, dtype="float32",
        )
    return tf.TransformerConfig(
        name="lm-10m", n_layers=4, d_model=256, n_heads=8, n_kv=4,
        d_head=32, d_ff=768, vocab=4_096, dtype="float32",
    )


def run(params, cfg, args, device) -> dict:
    """``args.steps`` AdamW steps of ``TrainLoop`` from ``params``
    (checkpoints under ``args.ckpt_dir``); the walkthrough's summary."""
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    state = (params, init_state(opt_cfg, params))

    def step_fn(state, batch):
        params, opt = state
        l, g = value_and_grad(lambda p: tf.loss_fn(p, cfg, batch["tokens"], batch["labels"])[0], params)
        params, opt, om = apply_updates(opt_cfg, params, g, opt)
        return (params, opt), {"loss": l, **om}

    def data_fn(step):
        toks, labs = token_stream(args.batch, args.seq, cfg.vocab, seed=step)
        return {"tokens": torch.as_tensor(toks, device=device), "labels": torch.as_tensor(labs, device=device)}

    loop = TrainLoop(
        LoopConfig(
            total_steps=args.steps,
            checkpoint_every=50,
            checkpoint_dir=args.ckpt_dir,
        ),
        step_fn,
        data_fn,
        state,
    )
    t0 = time.perf_counter()
    metrics = loop.run()
    run_s = time.perf_counter() - t0
    losses = np.asarray(metrics.losses)
    print(f"steps: {metrics.steps_run}  loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"failures recovered: {metrics.failures_recovered}, "
          f"stragglers flagged: {metrics.straggler_steps}")
    assert losses[-1] < losses[0], "training should reduce loss"
    return summary(
        exact={"config": cfg.name, "params_m": round(cfg.param_count() / 1e6, 1), "steps": metrics.steps_run,
               "failures_recovered": metrics.failures_recovered, "restored_from": metrics.restored_from},
        close={"losses": losses.tolist()},
        seconds={"run": run_s, "step_s": run_s / max(metrics.steps_run, 1),
                 "stragglers": metrics.straggler_steps},
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    args, dev = parse(ap, argv)
    cfg = config(args.full_100m)
    print(f"config {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return run(params, cfg, args, dev)


if __name__ == "__main__":
    main()
