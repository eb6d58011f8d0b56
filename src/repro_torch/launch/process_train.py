"""The LM train step over a mesh of processes, one per rank.

    PYTHONPATH=src python -m repro_torch.launch.process_train --arch mixtral-8x7b --smoke \\
        --d-model 64 --d-ff 128 --vocab 512 --data 2 --model 2 --backend gloo --steps 4 --check

Run without ``RANK`` in the environment, the command is the launcher: it
starts ``--data`` x ``--model`` copies of itself with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR=localhost``, a
free ``MASTER_PORT``), waits for them within ``--timeout`` seconds (and
stops every one on a failure or the timeout), and prints rank 0's JSON
line.  Each rank joins the process mesh (``make_process_mesh``: gloo on
the CPU, NCCL with one card per rank), builds the same parameters from
seed 0, keeps its shards under the reference's ``lm_param_specs`` (every
leaf's shards gathered back must equal the leaf), takes its slice of a
``token_stream`` batch of 8 x 32 tokens and runs ``--steps`` steps of
``steps.lm_train_step`` with AdamW (lr 1e-3 and, by default, f32
moments, as the reference's sharded test; ``--moment-dtype bfloat16``
for bf16).  ``--check``: rank 0 then runs the one-process step on the
same parameters and batch on its own device and reports the largest
parameter difference, both losses and both gradient norms, and the
largest difference of int8 compression of a random tree on shards
against the whole tree's.  ``--out DIR``: rank 0 writes
``DIR/result.npz`` (the losses and every parameter after the last step,
gathered whole, under its path).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

__all__ = ["main", "spawn"]

#: the batch (sequences x tokens) and the seed of the parameters and tokens
BATCH, SEQ, SEED = 8, 32, 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world: int, argv, timeout: float) -> list:
    """Run ``world`` ranks of this module with ``argv``; returns their
    (exit code, output) in rank order.  A rank that fails, or the timeout,
    stops them all."""
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", "repro_torch.launch.process_train", *argv], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.wait(), p.stdout.read()) for p in procs]


def _config(args):
    from repro_torch.configs import get_arch

    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit(f"--arch {args.arch}: the sharded step trains LM archs (GCN and RecSys: ROADMAP item 11c.4)")
    cfg = arch.smoke_cfg if args.smoke else arch.model_cfg
    over = {k: v for k, v in (("d_model", args.d_model), ("d_ff", args.d_ff), ("vocab", args.vocab))
            if v is not None}
    return dataclasses.replace(cfg, **over)


def _run_rank(args) -> None:
    import torch.distributed as dist

    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import tree_flatten, tree_leaves, tree_map
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec, lm_param_specs, to_named_shardings
    from repro_torch.train import AdamWConfig, init_state
    from repro_torch.train.optimizer import compress_tree, decompress_tree

    mesh = make_process_mesh(args.data, args.model, args.backend)
    dev = mesh.device
    if dev.type == "cpu":   # the ranks share the host's cores (and a test run's other workers)
        torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(args)
    params = tf.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    pspecs = lm_param_specs(params, mesh, n_experts=cfg.moe.n_experts if cfg.moe else None)
    shd = to_named_shardings(pspecs, mesh)
    shards = tree_map(lambda p, s: s.place(p), params, shd)
    rebuilt = all(torch.equal(s.gather(sh).cpu(), p) for p, s, sh in zip(
        tree_leaves(params), tree_leaves(shd, is_leaf=lambda x: isinstance(x, NamedSharding)), tree_leaves(shards)))
    opt_cfg = AdamWConfig(moment_dtype=args.moment_dtype, lr=1e-3)
    opt = init_state(opt_cfg, shards)
    toks, labs = token_stream(BATCH, SEQ, cfg.vocab, seed=SEED)
    batch = NamedSharding(mesh, PartitionSpec(None, ("data",), None))
    tokens = batch.place(torch.as_tensor(toks)[None])
    labels = batch.place(torch.as_tensor(labs)[None])
    step = lm_train_step(cfg, opt_cfg, mesh, pspecs)
    losses, norms, seconds = [], [], []
    for _ in range(args.steps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        shards, opt, m = step(shards, opt, tokens, labels)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        seconds.append(time.perf_counter() - t0)
    whole = tree_map(lambda p, s: s.gather(p), shards, shd)
    if args.check:
        # int8 compression of a tree of shards scales by each whole leaf
        noise = tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())), params)
        q, _ = compress_tree(tree_map(lambda t, s: s.place(t), noise, shd),
                             tree_map(lambda t, s: s.place(torch.zeros_like(t)), noise, shd), shd)
        deq = tree_map(lambda t, s: s.gather(t), decompress_tree(q), shd)
    if mesh.rank != 0:
        dist.destroy_process_group()
        return
    paths, leaves = tree_flatten(whole)
    out = {"world": int(np.prod(mesh.sizes)), "mesh": list(mesh.sizes), "backend": args.backend or "default",
           "device": str(dev), "losses": losses, "grad_norms": norms, "step_seconds": seconds,
           "shards_rebuild_leaves": bool(rebuilt)}
    if args.check:
        whole_noise = tree_map(lambda t: t.to(dev), noise)       # the same device as the shards
        q1, _ = compress_tree(whole_noise, tree_map(torch.zeros_like, whole_noise))
        out["compress_max_diff"] = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(deq), tree_leaves(decompress_tree(q1))))
        ref = tf.init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
        ref = tree_map(lambda p: p.to(dev), ref)
        ref_opt = init_state(opt_cfg, ref)
        one = lm_train_step(cfg, opt_cfg)
        ref_losses, ref_norms = [], []
        for _ in range(args.steps):
            ref, ref_opt, m = one(ref, ref_opt, torch.as_tensor(toks)[None].to(dev), torch.as_tensor(labs)[None].to(dev))
            ref_losses.append(float(m["loss"]))
            ref_norms.append(float(m["grad_norm"]))
        out["one_process_losses"] = ref_losses
        out["one_process_grad_norms"] = ref_norms
        out["max_param_diff"] = max(float((a - b).abs().max()) for a, b in zip(leaves, tree_leaves(ref)))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, "result.npz"), losses=np.asarray(losses),
                 **{"param/" + "/".join(map(str, p)): l.detach().cpu().numpy() for p, l in zip(paths, leaves)})
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config")
    ap.add_argument("--d-model", type=int)
    ap.add_argument("--d-ff", type=int)
    ap.add_argument("--vocab", type=int)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), help="default: nccl with a card, else gloo")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--moment-dtype", choices=("float32", "bfloat16"), default="float32",
                    help="AdamW's moment dtype (the reference's sharded test keeps f32)")
    ap.add_argument("--check", action="store_true", help="rank 0 also runs the one-process step")
    ap.add_argument("--out", help="directory for rank 0's result.npz")
    ap.add_argument("--timeout", type=float, default=600.0, help="the launcher's limit, seconds")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:
        _run_rank(args)
        return 0
    results = spawn(args.data * args.model, sys.argv[1:] if argv is None else list(argv), args.timeout)
    bad = [(r, rc, out) for r, (rc, out) in enumerate(results) if rc != 0]
    for r, rc, out in bad:
        print(f"[rank {r}] exit {rc}\n{out[-4000:]}", file=sys.stderr)
    if not bad:
        print(results[0][1].strip().splitlines()[-1])
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
