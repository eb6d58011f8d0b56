"""Training CLI: ``--arch`` -> a fault-tolerant training run on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20 --smoke
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 20 --smoke --device cpu

The JAX package's ``launch/train.py`` flag for flag, plus ``--device``
(default ``cuda``; it raises without a card).  Wires together: config
registry -> LM loss and its gradients -> AdamW -> ``TrainLoop``
(checkpoint / restart / straggler handling), with batches from
``token_stream``.  Each step runs eagerly; reading its loss is the loop's
one host sync.  Without ``--smoke`` the full config trains with bf16
moments on one device.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", help="use the reduced smoke config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import token_stream
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import value_and_grad
    from repro_torch.train import AdamWConfig, LoopConfig, TrainLoop, apply_updates, init_state

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit(f"--arch {args.arch}: this CLI trains LM archs; "
                         "GNN/recsys cells run through repro_torch.launch.steps")
    dev = resolve_device(args.device)
    cfg = arch.smoke_cfg if args.smoke else arch.model_cfg
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, 1 device ({dev})")

    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=min(20, args.steps // 5), total_steps=args.steps,
                          moment_dtype="float32" if args.smoke else "bfloat16")
    state = (params, init_state(opt_cfg, params))

    def step_fn(state, batch):
        params, opt = state
        l, g = value_and_grad(lambda p: tf.loss_fn(p, cfg, batch["tokens"], batch["labels"])[0], params)
        params, opt, om = apply_updates(opt_cfg, params, g, opt)
        return (params, opt), {"loss": l, **om}

    def data_fn(step):
        toks, labs = token_stream(args.batch, args.seq, cfg.vocab, seed=step)
        return {"tokens": torch.as_tensor(toks, device=dev), "labels": torch.as_tensor(labs, device=dev)}

    loop = TrainLoop(
        LoopConfig(total_steps=args.steps, checkpoint_every=args.checkpoint_every, checkpoint_dir=args.ckpt_dir),
        step_fn, data_fn, state,
    )
    m = loop.run()
    losses = np.asarray(m.losses)
    print(f"[train] done: {m.steps_run} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"recoveries={m.failures_recovered}, stragglers={m.straggler_steps}")
    return m


if __name__ == "__main__":
    main()
