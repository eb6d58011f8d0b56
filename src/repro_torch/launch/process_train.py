"""Every family's cells over a mesh of processes, one per rank: the LM train,
prefill and decode steps, the RecSys train, serve and retrieval cells, the
GCN train cells and the paper's search serve cell.

    PYTHONPATH=src python -m repro_torch.launch.process_train --arch mixtral-8x7b --smoke \\
        --d-model 64 --d-ff 128 --vocab 512 --data 2 --model 2 --backend gloo --steps 4 --check
    PYTHONPATH=src python -m repro_torch.launch.process_train --arch qwen2-1.5b --smoke \\
        --data 1 --model 4 --backend gloo --mode train,decode --check \\
        --then --arch mixtral-8x7b --smoke --data 2 --model 2 --backend gloo --opt --check
    PYTHONPATH=src python -m repro_torch.launch.process_train --arch fm --smoke --data 1 --model 2 \\
        --backend gloo --mode train,serve,retrieval --size batch=64 --size n_candidates=512 --check
    PYTHONPATH=src python -m repro_torch.launch.process_train --arch gcn-cora --smoke --data 2 --model 1 \\
        --backend gloo --shape ogb_products --size n_nodes=300 --size n_edges=2000 --size d_feat=16 --check
    PYTHONPATH=src python -m repro_torch.launch.process_train --arch nsimplex-colors --smoke --data 2 \\
        --model 1 --backend gloo --mode search --opt --check

Run without ``RANK`` in the environment, the command is the launcher: it
starts ``--data`` x ``--model`` copies of itself with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR=localhost``, a
free ``MASTER_PORT``), waits for them within ``--timeout`` seconds (and
stops every one on a failure or the timeout), and prints one JSON line
per run: rank 0's record with every rank's own figures under ``"ranks"``.
``--then`` separates runs that one start of the ranks takes in turn (each
with its own arguments and mesh, of one world size, backend and device;
the launch's limit is the sum of their ``--timeout``).
``--count-collectives``: after each mode's timed steps or calls, one more
runs under ``launch.op_walk.CollectiveCounter`` (untimed, on copies of what
it updates, its memory left out of the peak), and the record's ``collectives``
gives, per mode, the bytes of every collective's result on the rank by kind
(``"counted"``: what the dry run's meta walk counts for the cell) beside
what the step's ``TensorParallel`` counted (``"moved"``).

Each rank joins the process mesh (``make_process_mesh``: gloo on the CPU,
NCCL with one card per rank, or ``--backend gloo --device cuda`` for
several ranks on one card, whose all-gathers and reduce-scatters are
staged through host memory; ``transport`` names the route), builds the
whole parameters from seed 0 on its device, keeps its shards under the
reference's specs (every leaf's shards gathered back must equal the leaf,
and a split leaf holds 1 / its split of it) and, for each ``--mode``:

* ``train``: takes its slice of a ``token_stream`` batch of ``--batch`` x
  ``--seq`` tokens and runs ``--steps`` steps of ``steps.lm_train_step``
  (tensor-parallel over ``model``) with AdamW (lr 1e-3 and, by default,
  f32 moments, as the reference's sharded test; ``--moment-dtype
  bfloat16`` for bf16);
* ``prefill``: ``steps.lm_prefill_step`` on its slice of the batch's first
  ``--seq`` tokens: logits whole, the cache its ``kv_cache_specs`` shard;
* ``decode``: the prefill, then ``--decode-steps`` steps of
  ``steps.lm_decode_step`` fed the batch's next tokens.

``--opt``: the cells' §Perf levers (``steps.lm_cell_cfg``: chunked
attention and CE, local MoE dispatch with per-shard capacity, expert
weights replicated over ``data`` under ``moe_local`` while their moments
stay sharded).  ``--smoke`` takes the arch's reduced config; without it
the full config, ``--n-layers`` its one cut in depth; ``--d-model``,
``--d-ff``, ``--d-head``, ``--vocab``, ``--n-experts`` and ``--dtype``
replace fields.

The other families run ``steps.build_cell``'s plan of one cell
(``--shape``; by default the mode's: ``train_batch``, ``serve_p99`` and
``retrieval_cand`` for RecSys, ``full_graph_sm`` for GCN, ``serve_1m``
for the search cell) on the arch's config, ``--size KEY=VALUE`` cutting
the cell's sizes.  Each rank builds the cell's whole seeded inputs on its
device (``cell_inputs``) and keeps its slices under the plan's specs:

* ``train`` (RecSys, GCN): ``--steps`` steps of the cell's step;
* ``serve``, ``retrieval`` (RecSys): one call of the cell's step on this
  rank's slice of the batch or of the candidates, gathered whole;
* ``search`` (``nsimplex-colors``; ``--opt`` the opt cell: rows over every
  axis, K4 projection, K3 selection into 8 slots; else rows over the batch
  axes, Algorithm 2, K1 and a sort into 128 slots): the serve step over
  this rank's rows of the table (padded with rows of altitude +inf),
  ``--steps`` timed calls after the first, this rank's K1 / K3 / K4
  launches in the first call, and K3's, K4's and K1's outputs on the
  rank's inputs held against their plain versions.

``--out DIR``: each rank writes ``DIR/rank{r}.pt`` and exits: its
parameter shards after the last step by path (``"train"``), and the
prefill and decode logits whole with its cache shard (``"serve"``), a
RecSys serve or retrieval output gathered whole (under its mode's name),
the search cell's histograms and candidate slots (``"search"``).
``--check``: the launcher then runs the one-process port on the same
parameters and inputs on the ranks' kind of device and compares shard by
shard (the largest differences of the parameters, the prefill and every
decode step's logits and the cache, beside both losses and gradient
norms; a RecSys cell's output; the search cell's histograms and slots
against the one-process grid's, exactly, every rank's alike); each LM
rank also compresses a random tree to int8 on its shards, and the record
gives the largest difference from the whole tree's compression cut to
the shards.  Without ``--out`` the check's files go to a temporary
directory, removed after it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

__all__ = ["launch", "main", "spawn"]

#: separates the runs of one launch
THEN = "--then"

#: the default batch (sequences x tokens) and the seed of the parameters and inputs
BATCH, SEQ, SEED = 8, 32, 0
#: each family's modes, the first its default
MODES = {"lm": ("train", "prefill", "decode"), "recsys": ("train", "serve", "retrieval"), "gnn": ("train",),
         "metricsearch": ("search",)}
#: the cell a mode of another family runs unless --shape names one
CELLS = {"train": {"recsys": "train_batch", "gnn": "full_graph_sm"}, "serve": "serve_p99",
         "retrieval": "retrieval_cand", "search": "serve_1m"}


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


def _family(args) -> str:
    from repro_torch.configs import get_arch

    return get_arch(args.arch).family


def _config(args):
    from repro_torch.configs import get_arch

    arch = get_arch(args.arch)
    cfg = arch.smoke_cfg if args.smoke else arch.model_cfg
    over = {k: v for k, v in (("d_model", args.d_model), ("d_ff", args.d_ff), ("vocab", args.vocab),
                              ("d_head", args.d_head), ("n_layers", args.n_layers), ("dtype", args.dtype))
            if v is not None}
    if arch.family != "lm":
        if over or args.n_experts is not None:
            raise SystemExit(f"--arch {args.arch}: the config overrides are the LM archs'; cut a cell with --size")
        return cfg
    if args.n_experts is not None:
        if cfg.moe is None:
            raise SystemExit(f"--n-experts: {args.arch} has no MoE layers")
        over["moe"] = dataclasses.replace(cfg.moe, n_experts=args.n_experts)
    return dataclasses.replace(cfg, **over)


def _modes(args) -> tuple:
    allowed = MODES[_family(args)]
    if args.mode is None:
        return allowed[:1]
    modes = tuple(m for m in args.mode.split(",") if m)
    if not modes or any(m not in allowed for m in modes):
        raise SystemExit(f"--mode for {args.arch} takes a comma-separated subset of {allowed}; got {args.mode!r}")
    if args.shape and len(modes) > 1:
        raise SystemExit("--shape names the cell of one mode")
    return modes


def _shape(args, mode: str) -> str:
    if args.shape:
        return args.shape
    cell = CELLS[mode]
    return cell[_family(args)] if isinstance(cell, dict) else cell


def _sizes(args) -> dict:
    """``--size KEY=VALUE`` as a dict of ints."""
    out = {}
    for item in args.size or ():
        key, _, value = item.partition("=")
        if not value:
            raise SystemExit(f"--size takes KEY=VALUE; got {item!r}")
        out[key] = int(value)
    return out


def _device(args) -> torch.device:
    """The device of the one-process port: the ranks' kind."""
    if args.device == "cuda" or args.backend == "nccl" or (args.backend is None and torch.cuda.is_available()):
        return torch.device("cuda", 0)
    return torch.device("cpu")


@contextlib.contextmanager
def _exact_math(dev: torch.device):
    """f32 matmuls without TF32 and, on the CPU, one thread (the ranks
    share the host's cores, and a test run's other workers); the settings
    are restored on exit."""
    saved = torch.get_num_threads(), torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    if dev.type == "cpu":
        torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_num_threads(saved[0])
        torch.set_float32_matmul_precision(saved[1])
        torch.backends.cuda.matmul.allow_tf32 = saved[2]


def _whole(cfg, dev):
    """The whole parameters from the seed, drawn on ``dev``."""
    from repro_torch.models import transformer as tf

    return tf.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)


def _tokens(args, cfg, extra: int = 0):
    from repro_torch.data.synthetic import token_stream

    toks, labs = token_stream(args.batch, args.seq + extra, cfg.vocab, seed=SEED)
    return torch.as_tensor(toks), torch.as_tensor(labs)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _paths(tree, cls=None) -> dict:
    from repro_torch.models.params import tree_flatten

    paths, leaves = tree_flatten(tree, is_leaf=None if cls is None else (lambda x: isinstance(x, cls)))
    return {"/".join(map(str, p)): l for p, l in zip(paths, leaves)}


def _leaves(tree, cls=None):
    from repro_torch.models.params import tree_leaves

    return tree_leaves(tree) if cls is None else tree_leaves(tree, is_leaf=lambda x: isinstance(x, cls))


def _copy(tree):
    """A copy of a tree of tensors, each leaf's ``requires_grad`` kept."""
    from repro_torch.models.params import tree_map

    return tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad), tree)


def _diff(pairs) -> tuple:
    """(largest |a - b|, largest |a - b| over max |b| of its leaf) over
    (got, want) pairs of tensors."""
    ab, rel = 0.0, 0.0
    for a, b in pairs:
        if b.numel() == 0:
            continue
        d = float((a.detach().to(b.device, torch.float64) - b.detach().double()).abs().max())
        ab, rel = max(ab, d), max(rel, d / max(float(b.detach().abs().max()), 1e-30))
    return ab, rel


class _Rank:
    """One rank's run of the modes, with what the checks need."""

    def __init__(self, args, mesh, cfg):
        self.args, self.mesh, self.cfg, self.dev = args, mesh, cfg, mesh.device
        self.batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        shards = int(np.prod([mesh.shape[a] for a in self.batch_axes]))
        self.split = args.batch % shards == 0 and args.batch >= shards
        self.rec = {"rank": mesh.rank, "coords": list(mesh.coords), "device": str(self.dev),
                    "transport": mesh.transport}
        self.saved, self.rebuilt, self.counted, self.peak = {}, set(), {}, 0

    def _count(self, mode: str, fn, args) -> None:
        """With ``--count-collectives``, one more call ``fn(*args())`` after
        the mode's timed calls, under ``op_walk.CollectiveCounter``:
        ``counted[mode]`` gets its collective bytes by kind (``"counted"``)
        beside the bytes its ``TensorParallel`` counted over the call
        (``"moved"``).  ``args`` makes the arguments (copies of what the
        call updates in place) after the device's peak so far is kept; the
        outputs are dropped and the peak is reset after the call, so the
        counted call enters neither a timed figure nor
        ``max_memory_allocated``."""
        if not self.args.count_collectives:
            return
        from repro_torch.launch.op_walk import CollectiveCounter

        cuda = self.dev.type == "cuda"
        if cuda:
            self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.dev))
        tp = getattr(fn, "tensor_parallel", None)
        before = dict(tp.moved) if tp else {}
        with CollectiveCounter() as counter:
            fn(*args())
        self.counted[mode] = {"counted": counter.bytes,
                              "moved": {k: v - before.get(k, 0) for k, v in tp.moved.items()} if tp else {}}
        if cuda:
            _sync(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)

    def _place(self, whole, specs):
        """This rank's shards of the whole seeded parameters and their
        shardings; records whether every leaf's shards gather back to it, a
        split leaf holding 1 / its split of it."""
        from repro_torch.models.params import tree_map
        from repro_torch.sharding.rules import NamedSharding, to_named_shardings

        t0 = time.perf_counter()
        shd = to_named_shardings(specs, self.mesh)
        shards = tree_map(lambda p, s: s.place(p), whole, shd)
        layout = tuple(s.spec for s in _leaves(shd, NamedSharding))
        if layout not in self.rebuilt:      # a layout's gathers are checked once
            world = int(np.prod(self.mesh.sizes))
            ok = all(torch.equal(s.gather(sh), p) and sh.numel() * (world // s.replicas) == p.numel()
                     for p, s, sh in zip(_leaves(whole), _leaves(shd, NamedSharding), _leaves(shards)))
            self.rec["shards_rebuild_leaves"] = self.rec.get("shards_rebuild_leaves", True) and ok
            self.rebuilt.add(layout)
        self.rec["place_s"] = self.rec.get("place_s", 0.0) + time.perf_counter() - t0
        return shards, shd

    def _bytes(self, shards, whole) -> None:
        """This rank's parameter bytes beside the whole model's, in the
        first mode's layout (train's under ``moe_local``)."""
        self.rec.setdefault("param_bytes", sum(t.numel() * t.element_size() for t in _leaves(shards)))
        self.rec.setdefault("whole_param_bytes", sum(t.numel() * t.element_size() for t in _leaves(whole)))

    def _batch(self, dims: int):
        """The sharding of a batch-leading tensor: over the batch axes, or
        whole where the batch does not split."""
        from repro_torch.sharding.rules import NamedSharding, PartitionSpec

        return NamedSharding(self.mesh, PartitionSpec(self.batch_axes if self.split else None, *([None] * dims)))

    def train(self):
        from repro_torch.launch import steps
        from repro_torch.models import transformer as tf
        from repro_torch.models.params import tree_map
        from repro_torch.sharding.rules import NamedSharding, PartitionSpec, to_named_shardings
        from repro_torch.train import AdamWConfig, init_state

        args, mesh = self.args, self.mesh
        if not self.split:
            raise SystemExit(f"--batch {args.batch} must split over the batch axes to train")
        cfg = steps.lm_cell_cfg(self.cfg, "train", mesh, opt=args.opt)
        if cfg.moe is not None:
            self.rec["moe_dispatch"] = {"dispatch": cfg.moe.dispatch, "n_batch_shards": cfg.moe.n_batch_shards}
        pspecs, mspecs = steps.lm_step_specs(cfg, mesh)
        shards, shd = self._place(_whole(cfg, self.dev), pspecs)
        self._bytes(shards, tf.init_params_abstract(cfg))
        # the moments' shards (ZeRO over data even under moe_local): zeros of their shapes
        shapes = tree_map(lambda p, s: torch.empty(s.cut(p).shape, dtype=p.dtype, device=self.dev),
                          tf.init_params_abstract(cfg), to_named_shardings(mspecs, mesh))
        opt_cfg = AdamWConfig(moment_dtype=args.moment_dtype, lr=1e-3)
        opt = init_state(opt_cfg, shapes)
        del shapes
        toks, labs = _tokens(args, cfg)
        batch = NamedSharding(mesh, PartitionSpec(None, self.batch_axes, None))
        tokens, labels = batch.place(toks[None].to(self.dev)), batch.place(labs[None].to(self.dev))
        step = steps.lm_train_step(cfg, opt_cfg, mesh, pspecs, mspecs)
        losses, norms, ms = [], [], []
        for _ in range(args.steps):
            _sync(self.dev)
            t0 = time.perf_counter()
            shards, opt, m = step(shards, opt, tokens, labels)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            ms.append(1e3 * (time.perf_counter() - t0))
        self.rec.update(losses=losses, grad_norms=norms, step_ms=ms)
        self._count("train", step, lambda: (_copy(shards), _copy(opt), tokens, labels))
        if args.out:
            self.saved["train"] = {k: v.detach().cpu() for k, v in _paths(shards).items()}
        if args.check:
            self.rec["compress_max_diff"] = self._compress(cfg, shd)

    def _compress(self, cfg, shd) -> float:
        """int8 compression of a random tree on shards against the whole
        tree's cut to this rank's shards, leaf by leaf (a collective: each
        scale is the whole leaf's)."""
        from repro_torch.models import transformer as tf
        from repro_torch.sharding.rules import NamedSharding
        from repro_torch.train.optimizer import compress_tree, decompress_tree

        worst = 0.0
        for p, s in zip(_leaves(tf.init_params_abstract(cfg)), _leaves(shd, NamedSharding)):
            noise = torch.randn(p.shape, generator=torch.Generator(device=self.dev).manual_seed(p.numel()),
                                device=self.dev)
            mine = s.place(noise)
            q, _ = compress_tree({"x": mine}, {"x": torch.zeros_like(mine)}, {"x": s})
            whole, _ = compress_tree({"x": noise}, {"x": torch.zeros_like(noise)})
            worst = max(worst, float((decompress_tree(q)["x"] - s.cut(decompress_tree(whole)["x"])).abs().max()))
        return worst

    def serve(self, modes):
        from repro_torch.launch import steps
        from repro_torch.models import transformer as tf
        from repro_torch.sharding.rules import kv_cache_specs, lm_param_specs, to_named_shardings

        args, mesh, B, S = self.args, self.mesh, self.args.batch, self.args.seq
        n_dec = args.decode_steps if "decode" in modes else 0
        cfg = steps.lm_cell_cfg(self.cfg, "prefill", mesh, opt=args.opt, batch=B, seq=S)
        n_exp = cfg.moe.n_experts if cfg.moe else None
        pspecs = lm_param_specs(tf.init_params_abstract(cfg), mesh, n_experts=n_exp)
        shards, _ = self._place(_whole(cfg, self.dev), pspecs)
        self._bytes(shards, tf.init_params_abstract(cfg))
        toks = self._batch(1).place(_tokens(args, cfg, n_dec)[0])
        prefill = steps.lm_prefill_step(cfg, mesh, B, pspecs)
        _sync(self.dev)
        t0 = time.perf_counter()
        logits, cache = prefill(shards, toks[:, :S])
        _sync(self.dev)
        self.rec["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        self._count("prefill", prefill, lambda: (shards, toks[:, :S]))
        out = {"prefill_logits": self._batch(1).gather(logits).cpu()}
        dcfg = steps.lm_cell_cfg(self.cfg, "decode", mesh, opt=args.opt)
        if n_dec:
            if dcfg.window is None:
                cache = tf.extend_cache(dcfg, cache, S + n_dec)
            decode = steps.lm_decode_step(dcfg, mesh, B, pspecs)
            moved0 = dict(decode.tensor_parallel.moved) if decode.tensor_parallel else {}
            dec_logits, ms = [], []
            for i in range(n_dec):
                pos = torch.full((toks.shape[0],), S + i, dtype=torch.int32, device=self.dev)
                _sync(self.dev)
                t0 = time.perf_counter()
                lg, cache = decode(shards, toks[:, S + i].contiguous(), pos, cache)
                _sync(self.dev)
                ms.append(1e3 * (time.perf_counter() - t0))
                dec_logits.append(self._batch(1).gather(lg).cpu())
            out["decode_logits"] = torch.stack(dec_logits)
            self.rec["decode_ms"] = ms
            if decode.tensor_parallel:
                moved = decode.tensor_parallel.moved
                self.rec["model_collective_bytes_per_decode_step"] = {
                    k: (moved[k] - moved0.get(k, 0)) / n_dec for k in moved}
            pos = torch.full((toks.shape[0],), S, dtype=torch.int32, device=self.dev)
            self._count("decode", decode, lambda: (shards, toks[:, S].contiguous(), pos, _copy(cache)))
        whole = tf.init_cache(dcfg, B, cache["pos"].shape[-1], device="meta")
        cshd = to_named_shardings(kv_cache_specs(whole, mesh, batch=B), mesh)
        self.rec["cache_shard_shapes"] = {k: list(v.shape) for k, v in cache.items()}
        self.rec["cache_is_its_spec_shard"] = all(cache[k].shape == cshd[k].cut(v).shape for k, v in whole.items())
        if self.args.out:
            self.saved["serve"] = dict(out, cache={k: v.cpu() for k, v in cache.items()})

    def cell(self, mode: str) -> None:
        """One mode of a RecSys, GCN or search cell (see the module)."""
        from repro_torch.sharding.rules import NamedSharding
        from repro_torch.train import init_state

        args, mesh = self.args, self.mesh
        plan, opt_cfg, sizes = _cell_plan(args, self.cfg, mode, mesh)
        params, rest = cell_inputs(plan, self.cfg, sizes, self.dev, args.threshold)
        self.rec["cell"] = plan.shape_name
        if plan.kind == "search_serve":
            return self._search(plan, rest)
        shards, _ = self._place(params, plan.in_specs[0])
        self._bytes(shards, params)
        del params
        fixed = 2 if mode == "train" else 1
        placed = [_place_tree(mesh, a, spec) for a, spec in zip(rest, plan.in_specs[fixed:])]
        del rest
        if mode == "train":
            opt = init_state(opt_cfg, shards)
            losses, norms, ms = [], [], []
            for _ in range(args.steps):
                _sync(self.dev)
                t0 = time.perf_counter()
                shards, opt, m = plan.fn(shards, opt, *placed)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                ms.append(1e3 * (time.perf_counter() - t0))
            self.rec.update(losses=losses, grad_norms=norms, step_ms=ms)
            self._count("train", plan.fn, lambda: (_copy(shards), _copy(opt), *placed))
            if args.out:
                self.saved["train"] = {k: v.detach().cpu() for k, v in _paths(shards).items()}
            return
        with torch.no_grad():
            _sync(self.dev)
            t0 = time.perf_counter()
            out = plan.fn(shards, *placed)
            _sync(self.dev)
            self.rec[f"{mode}_ms"] = 1e3 * (time.perf_counter() - t0)
            self._count(mode, plan.fn, lambda: (shards, *placed))
        whole = NamedSharding(mesh, plan.out_specs).gather(out)
        self.rec[f"{mode}_shape"] = list(whole.shape)
        if args.out:
            self.saved[mode] = whole.cpu()

    def _search(self, plan, rest) -> None:
        """The search serve cell on this rank: the first call's launches by
        kernel and shape class, the timed calls, the kernel checks."""
        from repro_torch.kernels import ops
        from repro_torch.sharding.rules import NamedSharding

        args, mesh = self.args, self.mesh
        table, *consts, qd, t = rest
        local = NamedSharding(mesh, plan.in_specs[0]).place(table)
        self.rec.update(rows_padded=table.shape[0], rows_local=local.shape[0], queries=qd.shape[0],
                        pivots=table.shape[1], threshold=float(t), table_bytes=local.numel() * local.element_size(),
                        whole_table_bytes=table.numel() * table.element_size(), note=plan.note)
        del table
        ops.reset_launches()
        _sync(self.dev)
        t0 = time.perf_counter()
        hist, idx, code = plan.fn(local, *consts, qd, t)
        _sync(self.dev)
        self.rec["first_call_ms"] = 1e3 * (time.perf_counter() - t0)
        self.rec["launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        self.rec["shape_launches"] = {k: [[list(c), n] for c, n in by.items()]
                                      for k, by in ops.SHAPE_LAUNCHES.items() if by}
        ms = []
        for _ in range(args.steps):
            _sync(self.dev)
            t0 = time.perf_counter()
            plan.fn(local, *consts, qd, t)
            _sync(self.dev)
            ms.append(1e3 * (time.perf_counter() - t0))
        self.rec["serve_ms"] = ms
        self._count("search", plan.fn, lambda: (local, *consts, qd, t))
        self.rec["kernel_checks"] = _search_kernel_checks(args.opt, local, consts, qd, t)
        if args.out:
            self.saved["search"] = {"hist": hist.cpu(), "idx": idx.cpu(), "code": code.cpu()}


def _place_tree(mesh, tree, spec):
    """This rank's slice of a tensor or a dict of tensors under ``spec``
    (a ``PartitionSpec`` or a dict of them)."""
    from repro_torch.sharding.rules import NamedSharding

    if isinstance(tree, dict):
        return {k: NamedSharding(mesh, spec[k]).place(v) for k, v in tree.items()}
    return NamedSharding(mesh, spec).place(tree)


def _cell_plan(args, cfg, mode: str, mesh):
    """(``steps.build_cell``'s plan of the mode's cell on ``mesh``, the
    AdamW settings of its train step, the cell's sizes)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.train import AdamWConfig

    shape = _shape(args, mode)
    sizes = dict(get_arch(args.arch).shapes[shape].sizes)
    if mode == "search":            # the search cell's sizes are its config's (the smoke config's too)
        sizes.update(n_objects=cfg.n_objects, query_batch=cfg.query_batch, n_pivots=cfg.n_pivots)
    sizes.update(_sizes(args))
    opt_cfg = AdamWConfig(moment_dtype=args.moment_dtype, lr=1e-3)
    plan = steps.build_cell(args.arch, shape, mesh, opt=args.opt, opt_cfg=opt_cfg, model_cfg=cfg, sizes=sizes)
    if plan.kind not in (mode, "search_serve"):
        raise SystemExit(f"--shape {shape} is a {plan.kind} cell, not --mode {mode}")
    return plan, opt_cfg, sizes


def cell_inputs(plan, cfg, sizes: dict, dev, threshold=None):
    """(whole parameters, or None for the search cell; the step's other
    whole arguments) of a RecSys, GCN or search cell ``plan`` of ``sizes``
    on ``dev``, drawn from the seed: RecSys batches from
    ``criteo_like_batch`` / ``user_history_batch`` and candidates of field
    0 (CTR) or items 1, 2, ...; a random graph of the cell's nodes and
    edges (the edge list padded with weight-0 edges, every tenth node
    labelled), random sampled hops, ``molecule_batch``; the search cell's
    ``search_inputs``."""
    import dataclasses

    from repro_torch.models import gcn as gcn_mod
    from repro_torch.models import recsys as rec_mod

    if plan.kind == "search_serve":
        return None, search_inputs(cfg, sizes, dev, threshold)
    g = torch.Generator(device=dev).manual_seed(SEED)
    if isinstance(cfg, gcn_mod.GCNConfig):
        cfg = dataclasses.replace(cfg, d_feat=sizes["d_feat"], n_classes=sizes["n_classes"])
        return gcn_mod.init_params(cfg, g, device=dev), _gcn_inputs(plan, sizes, g, dev)
    params = rec_mod.get_model_fns(cfg)[0](cfg, g, device=dev)
    if plan.kind == "retrieval":
        ids = torch.arange(plan.args[2].shape[0], dtype=torch.int32)
        ctr = cfg.interaction in ("fm-2way", "cin")
        cand = ids % cfg.spec.vocab_sizes[0] if ctr else 1 + ids % (cfg.n_items - 1)
        return params, (_rec_batch(cfg, plan.args[1], dev), cand.to(dev))
    return params, (_rec_batch(cfg, plan.args[2 if plan.kind == "train" else 1], dev),)


def _rec_batch(cfg, abstract: dict, dev) -> dict:
    """A RecSys batch with the leaves and shapes of ``abstract`` (the
    labels' or targets' elements are its rows, microbatches included)."""
    from repro_torch.data.synthetic import criteo_like_batch, user_history_batch

    lead = abstract.get("labels", abstract.get("targets"))
    rows = lead.numel() if lead is not None else next(iter(abstract.values())).shape[0]
    if cfg.interaction in ("fm-2way", "cin"):
        arrays = dict(zip(("dense", "sparse", "labels"), criteo_like_batch(
            rows, n_sparse=cfg.n_sparse, vocab_sizes=np.asarray(cfg.spec.vocab_sizes), n_dense=cfg.n_dense,
            seed=SEED)))
    else:
        arrays = dict(zip(("seqs", "targets"), user_history_batch(rows, cfg.seq_len, cfg.n_items, seed=SEED)))
    return {k: torch.as_tensor(arrays[k]).reshape(v.shape).to(dev) for k, v in abstract.items()}


def _gcn_inputs(plan, sizes: dict, g, dev) -> tuple:
    from repro_torch.data.synthetic import molecule_batch

    n_classes = sizes["n_classes"]
    if plan.shape_name in ("full_graph_sm", "ogb_products"):
        N, E, E_pad = sizes["n_nodes"], sizes["n_edges"], plan.args[3].shape[1]
        feats = torch.randn((N, sizes["d_feat"]), generator=g, device=dev)
        edges = torch.zeros((2, E_pad), dtype=torch.int32, device=dev)
        edges[:, :E] = torch.randint(0, N, (2, E), generator=g, device=dev, dtype=torch.int32)
        weight = (torch.arange(E_pad, device=dev) < E).float()         # 0.0 marks padding edges
        labels = torch.randint(0, n_classes, (N,), generator=g, device=dev, dtype=torch.int32)
        return feats, edges, weight, labels, (torch.arange(N, device=dev) % 10 == 0).float()
    if plan.shape_name == "minibatch_lg":
        hops = tuple(torch.randn(tuple(a.shape), generator=g, device=dev) for a in plan.args[2:5])
        B = plan.args[5].shape[0]
        return hops + (torch.randint(0, n_classes, (B,), generator=g, device=dev, dtype=torch.int32),)
    mol = molecule_batch(batch=sizes["batch"], n_nodes=sizes["n_nodes"], n_edges=sizes["n_edges"],
                         d_feat=sizes["d_feat"], seed=SEED)
    mol["labels"] = mol["labels"] % n_classes
    return tuple(torch.as_tensor(mol[k]).to(dev) for k in ("feats", "src", "dst", "labels"))


def search_inputs(cfg, sizes: dict, dev, threshold=None) -> tuple:
    """The search serve cell's whole arguments on ``dev``: ``colors_like``
    rows (``n_objects`` of them, then ``query_batch`` queries) under the
    config's metric, ``n_pivots`` random pivots (seed 1), the f32 apex
    table padded to the cell's multiple of 8,192 rows with rows of
    altitude +inf (lwb = +inf: never a candidate), the projector's f32
    ``Linv``, ``sq_norms`` and ``sigma``, the queries' f32 pivot distances,
    and the threshold: ``threshold``, or the median over the first 64
    queries of their 3rd-nearest row's distance.  The last call's inputs
    are kept for the next (the runs of one start, and a launcher's checks,
    share them): read-only."""
    return _search_inputs(cfg, tuple(sorted(sizes.items())), torch.device(dev), threshold)


@functools.lru_cache(maxsize=1)
def _search_inputs(cfg, sizes: tuple, dev, threshold) -> tuple:
    from repro_torch.core import NSimplexProjector, select_pivots
    from repro_torch.data.synthetic import colors_like
    from repro_torch.metrics import get_metric

    sizes = dict(sizes)
    N, Q, n = sizes["n_objects"], sizes["query_batch"], sizes["n_pivots"]
    N_pad = ((N + 8191) // 8192) * 8192
    X = colors_like(n=N + Q, dim=cfg.dim, seed=SEED)
    metric = get_metric(cfg.metric)
    proj = NSimplexProjector(select_pivots(X[:N], n, seed=1), metric, device=dev)
    data, queries = torch.as_tensor(X[:N], device=dev), torch.as_tensor(X[N:], device=dev)
    table = torch.zeros((N_pad, n), dtype=torch.float32, device=dev)
    table[:, -1] = float("inf")
    table[:N] = proj.project_distances(proj.pivot_distances(data)).to(torch.float32)
    qd = proj.pivot_distances(queries).to(torch.float32)
    if threshold is None:
        D = metric.cross(queries[:64].double(), data.double())
        threshold = float(D.kthvalue(min(3, N), dim=1).values.median())
    consts = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (proj.Linv, proj.sq_norms, proj.sigma))
    return (table,) + consts + (qd, float(threshold))


def _search_kernel_checks(opt: bool, table, consts, qd, t) -> dict:
    """K4, K3 and K1 called as the search cell calls them on this rank's
    inputs, each held against its plain version: K4 on the query block
    (the opt cell's projection); K3 on the rank's rows (the opt cell's
    selection) against the plain selection over K1's own bounds of the same
    rows (K1-K3 share one bound routine), 64 queries at a time; K1 on each
    row tile for every query (the baseline's sort) or for the queries whose
    count overflows K3's slots, against its plain version.  Largest
    differences; K3's ids, bounds and counts must be equal."""
    from repro_torch.core.simplex import apex_addition
    from repro_torch.kernels import ops, ref
    from repro_torch.search.distributed import _bands, _k1_tiles

    Linv, sq, sigma = consts
    out = {}
    if opt:
        queries = ops.apex_project(qd, Linv, sq)
        out["apex_project"] = _max_diff(queries, ref.apex_project_ref(qd, Linv, sq))
    else:
        queries = apex_addition(sigma, qd)
    t_hi, _ = _bands(t, None, 1e-5, qd.shape[0], table.device)
    over = torch.arange(qd.shape[0], device=table.device)
    if opt:
        cap = min(8, table.shape[0])
        got = ops.apex_bounds_threshold(table, queries, t_hi, cap)
        same = True
        for lo in range(0, qd.shape[0], 64):
            lwb, upb = ops.apex_bounds_batch(table, queries[lo:lo + 64])
            want = ref.threshold_from_bounds(lwb, upb, t_hi[lo:lo + 64], cap)
            same = same and all(torch.equal(g[lo:lo + 64], w) for g, w in zip(got, want))
        out["apex_threshold"] = {"equal_to_plain_selection": bool(same)}
        over = torch.nonzero(got[3].to(torch.int64) > cap).flatten()
    if over.numel():
        err = 0.0
        for lo, lwb, upb in _k1_tiles(table, queries[over]):
            w = ref.apex_bounds_batch_ref(table[lo:lo + lwb.shape[1]], queries[over], table.shape[1])
            err = max(err, _max_diff(lwb, w[0]), _max_diff(upb, w[1]))
        out["apex_bounds_batch"] = {"queries": int(over.numel()), "max_abs_err": err}
    return out


def _max_diff(a, b) -> float:
    """Largest |a - b| over the elements where either is finite (the
    padding rows' bounds are +inf on both sides)."""
    fin = torch.isfinite(a) | torch.isfinite(b)
    if not bool(fin.any()):
        return 0.0
    return float((a[fin].double() - b[fin].double()).abs().max())


def _one_process(args, cfg, modes, dev):
    """The one-process port's results on the seeded parameters and tokens:
    the parameters after ``--steps`` train steps (by path), losses, gradient
    norms, prefill logits, cache and decode logits."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.train import AdamWConfig, init_state

    ref = {}
    if "train" in modes:
        tcfg = steps.lm_cell_cfg(cfg, "train", _one_mesh(args), opt=args.opt)
        params = _whole(tcfg, dev)
        opt_cfg = AdamWConfig(moment_dtype=args.moment_dtype, lr=1e-3)
        opt = init_state(opt_cfg, params)
        toks, labs = _tokens(args, tcfg)
        one = steps.lm_train_step(tcfg, opt_cfg)
        losses, norms = [], []
        for _ in range(args.steps):
            params, opt, m = one(params, opt, toks[None].to(dev), labs[None].to(dev))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        del opt
        ref.update(losses=losses, grad_norms=norms, params=_paths(params))
    if "prefill" in modes or "decode" in modes:
        B, S = args.batch, args.seq
        n_dec = args.decode_steps if "decode" in modes else 0
        pcfg = steps.lm_cell_cfg(cfg, "prefill", _one_mesh(args), opt=args.opt, batch=B, seq=S)
        dcfg = steps.lm_cell_cfg(cfg, "decode", _one_mesh(args), opt=args.opt)
        params = _whole(pcfg, dev)
        toks = _tokens(args, pcfg, n_dec)[0].to(dev)
        with torch.no_grad():
            ref["prefill_logits"], cache = tf.prefill(params, pcfg, toks[:, :S])
            if n_dec:
                if dcfg.window is None:
                    cache = tf.extend_cache(dcfg, cache, S + n_dec)
                dec = []
                for i in range(n_dec):
                    pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
                    lg, cache = tf.decode_step(params, dcfg, toks[:, S + i].contiguous(), pos, cache)
                    dec.append(lg)
                ref["decode_logits"] = torch.stack(dec)
        ref["cache"] = cache
    return ref


def _one_mesh(args):
    """A stand-in of the process mesh's axes and sizes (the cells' configs
    read only those)."""
    from repro_torch.launch.mesh import make_host_mesh

    n = args.data * args.model
    return make_host_mesh(args.data, args.model, devices=[torch.device("meta")] * n)


def _compare_serve(rec, got, ref, cache_pairs) -> None:
    rec["max_prefill_logit_diff"] = _diff([(got["prefill_logits"], ref["prefill_logits"])])[0]
    if "decode_logits" in ref:
        rec["max_decode_logit_diff"] = [_diff([(a, b)])[0] for a, b in zip(got["decode_logits"], ref["decode_logits"])]
    pairs = list(cache_pairs)
    rec["max_cache_diff"] = _diff(p for p in pairs if p[1].is_floating_point())[0]
    rec["cache_pos_equal"] = all(torch.equal(a.to(b.device), b) for a, b in pairs if not b.is_floating_point())


def _run_rank(runs) -> None:
    """This rank's runs in turn, one JSON line each; a mesh of a new shape
    builds its groups (collectives: every rank runs the same runs)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_process_mesh

    # torch.utils.checkpoint (the layers' remat) imports torch._dynamo on its
    # first call, seconds of host time: import it beside the mesh's set-up
    # and the placement instead of inside the first step
    start = time.time()
    threading.Thread(target=importlib.import_module, args=("torch._dynamo",), daemon=True).start()
    meshes = {}
    for i, args in enumerate(runs):
        clock = {"start": start}
        if (args.data, args.model) not in meshes:
            meshes[args.data, args.model] = make_process_mesh(args.data, args.model, args.backend, args.device)
        mesh = meshes[args.data, args.model]
        clock["mesh"] = time.time()
        with _exact_math(mesh.device):
            rec = _rank_record(args, mesh)
        clock["done"] = start = time.time()
        print(json.dumps(dict(rec, run=i, clock=clock)), flush=True)
        del rec
        gc.collect()
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    dist.destroy_process_group()


def _rank_record(args, mesh) -> dict:
    """This rank's run of the modes; its shards and results go to
    ``--out`` for the launcher's check."""
    import torch.distributed as dist

    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    modes = _modes(args)
    run = _Rank(args, mesh, _config(args))
    if _family(args) != "lm":
        for mode in modes:
            run.cell(mode)
    else:
        if "train" in modes:
            run.train()
        if "prefill" in modes or "decode" in modes:
            run.serve(modes)
    if mesh.device.type == "cuda":
        run.rec["max_memory_allocated"] = max(run.peak, torch.cuda.max_memory_allocated(mesh.device))
    rec = run.rec
    if run.counted:
        rec["collectives"] = run.counted
    if args.out:
        t0 = time.perf_counter()
        torch.save(run.saved, os.path.join(args.out, f"rank{mesh.rank}.pt"))
        rec["save_s"] = time.perf_counter() - t0
    if mesh.rank == 0:
        rec.update(world=int(np.prod(mesh.sizes)), mesh=list(mesh.sizes), backend=dist.get_backend())
    return rec


def _check_saved(args, rec: dict) -> None:
    """The one-process port against every rank's saved shards, in the
    launcher after the ranks exit."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec, ProcessMesh, kv_cache_specs

    dev = _device(args)
    cfg, modes = _config(args), _modes(args)
    n = args.data * args.model
    names, sizes = ("data", "model"), (args.data, args.model)
    saved = [torch.load(os.path.join(args.out, f"rank{r}.pt"), mmap=True) for r in range(n)]
    meshes = [ProcessMesh(names, sizes, (torch.device("cpu"),) * n, rank=r) for r in range(n)]
    if _family(args) != "lm":
        for mode in modes:
            _check_cell(args, cfg, mode, dev, rec, saved, meshes)
        return
    t0 = time.perf_counter()
    with _exact_math(dev):
        ref = _one_process(args, cfg, modes, dev)
    rec["one_process_s"] = time.perf_counter() - t0
    if "train" in modes:
        tcfg = steps.lm_cell_cfg(cfg, "train", meshes[0], opt=args.opt)
        specs = _paths(steps.lm_step_specs(tcfg, meshes[0])[0], PartitionSpec)
        rec["one_process_losses"], rec["one_process_grad_norms"] = ref["losses"], ref["grad_norms"]
        rec["max_param_diff"], rec["max_param_rel_diff"] = _diff(
            (s["train"][k], NamedSharding(m, specs[k]).cut(ref["params"][k]))
            for m, s in zip(meshes, saved) for k in specs)
    if "serve" in saved[0]:
        pcfg = steps.lm_cell_cfg(cfg, "prefill", meshes[0], opt=args.opt, batch=args.batch, seq=args.seq)
        cache_len = ref["cache"]["pos"].shape[-1]
        cspecs = kv_cache_specs(tf.init_cache(pcfg, args.batch, cache_len, device="meta"), meshes[0],
                                batch=args.batch)
        _compare_serve(rec, saved[0]["serve"], ref, (
            (s["serve"]["cache"][k], NamedSharding(m, cspecs[k]).cut(ref["cache"][k]))
            for m, s in zip(meshes, saved) for k in cspecs))


def _check_cell(args, cfg, mode: str, dev, rec: dict, saved: list, meshes: list) -> None:
    """One mode of a RecSys, GCN or search cell against the one-process
    port on the same inputs: the parameters after the steps shard by
    shard, the losses and gradient norms; a serve or retrieval output; the
    search cell's histograms and slots against the one-process grid's
    (equal, on every rank), summing to the padded table, no padding row a
    candidate."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import NamedSharding, PartitionSpec
    from repro_torch.train import init_state

    t0 = time.perf_counter()
    n = len(meshes)
    plan, opt_cfg, sizes = _cell_plan(args, cfg, mode, meshes[0])
    one, _, _ = _cell_plan(args, cfg, mode, make_host_mesh(args.data, args.model, devices=[dev] * n)
                           if plan.kind == "search_serve" else make_host_mesh(1, 1, devices=[dev]))
    with _exact_math(dev):
        params, rest = cell_inputs(one, cfg, sizes, dev, args.threshold)
        if mode == "train":
            opt = init_state(opt_cfg, params)
            losses, norms = [], []
            for _ in range(args.steps):
                params, opt, m = one.fn(params, opt, *rest)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            del opt
        else:
            with torch.no_grad():
                out = one.fn(*rest) if params is None else one.fn(params, *rest)
    rec[f"one_process_{mode}_s"] = time.perf_counter() - t0
    if mode == "train":
        specs = _paths(plan.in_specs[0], PartitionSpec)
        whole = _paths(params)
        rec["one_process_losses"], rec["one_process_grad_norms"] = losses, norms
        rec["max_param_diff"], rec["max_param_rel_diff"] = _diff(
            (s["train"][k], NamedSharding(m, specs[k]).cut(whole[k])) for m, s in zip(meshes, saved) for k in specs)
        return
    if mode != "search":
        rec[f"max_{mode}_diff"], rec[f"max_{mode}_rel_diff"] = _diff((s[mode], out) for s in saved)
        return
    hist, idx, code = (o.cpu() for o in out)
    got = [s["search"] for s in saved]
    rec["search_equal_one_process"] = all(
        torch.equal(g["hist"], hist) and torch.equal(g["idx"], idx) and torch.equal(g["code"], code) for g in got)
    N, N_pad = sizes["n_objects"], rest[0].shape[0]
    rec["hist_sums_to_padded_rows"] = bool((hist.sum(dim=1) == N_pad).all())
    rec["padding_never_candidate"] = bool((idx < N).all())
    rec["padding_excluded"] = bool((hist[:, 0] >= N_pad - N).all())
    rec["n_shards"] = idx.shape[0]
    rec["overflowing_queries"] = int(((hist[:, 1] + hist[:, 2]) > idx.shape[0] * idx.shape[2]).sum())
    rec["candidates_per_query"] = float((idx >= 0).sum(dim=(0, 2)).double().mean())


def _runs(argv) -> list:
    """``argv`` split at ``--then`` into the runs' argument lists."""
    runs = [[]]
    for a in argv:
        if a == THEN:
            runs.append([])
        else:
            runs[-1].append(a)
    return runs


def launch(argv) -> tuple:
    """The launcher: (exit code, every run's record, [(rank, exit code,
    output tail)] of the ranks that failed)."""
    runs = _runs(argv)
    parsed = [_parser().parse_args(a) for a in runs]
    first = parsed[0]
    for a in parsed[1:]:
        if (a.data * a.model, a.backend, a.device) != (first.data * first.model, first.backend, first.device):
            raise SystemExit(f"{THEN}: every run takes the first run's world size, --backend and --device")
    with contextlib.ExitStack() as stack:
        for a, run in zip(parsed, runs):
            if a.check and not a.out:
                a.out = stack.enter_context(tempfile.TemporaryDirectory(prefix="process_train_"))
                run += ["--out", a.out]
            if a.out:
                os.makedirs(a.out, exist_ok=True)
        rank_argv = [x for i, run in enumerate(runs) for x in ([THEN] if i else []) + run]
        t0, wall0 = time.perf_counter(), time.time()
        results = spawn(first.data * first.model, rank_argv, sum(a.timeout for a in parsed))
        ranks_s = time.perf_counter() - t0
        bad = [(r, rc, out[-4000:]) for r, (rc, out) in enumerate(results) if rc != 0]
        if bad:
            return 1, [], bad
        # each rank's records, one a run
        lines = [[json.loads(x) for x in out.splitlines() if x.startswith('{"rank"')] for _, out in results]
        recs = []
        for i, a in enumerate(parsed):
            ranks = [mine[i] for mine in lines]
            rec = dict(ranks[0], ranks_s=ranks_s)
            # seconds from the spawn to this run's start (the ranks' imports,
            # or the previous run's end), its mesh, the end of its modes
            rec["timeline_s"] = {k: v - wall0 for k, v in rec.pop("clock").items()}
            if "shards_rebuild_leaves" in rec:
                rec["shards_rebuild_leaves"] = all(r["shards_rebuild_leaves"] for r in ranks)
            if "compress_max_diff" in rec:
                rec["compress_max_diff"] = max(r["compress_max_diff"] for r in ranks)
            if a.check:
                t0 = time.perf_counter()
                _check_saved(a, rec)
                rec["check_s"] = time.perf_counter() - t0
                gc.collect()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
            rec["ranks"] = [{k: r[k] for k in ("rank", "coords", "transport", "param_bytes", "whole_param_bytes",
                                               "table_bytes", "max_memory_allocated", "step_ms", "prefill_ms",
                                               "decode_ms", "serve_ms", "retrieval_ms", "first_call_ms",
                                               "launches", "shape_launches", "kernel_checks", "collectives")
                             if k in r} for r in ranks]
            recs.append(rec)
    return 0, recs, []


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced smoke config (else its full config)")
    ap.add_argument("--n-layers", type=int, help="the one cut of a full config: its depth")
    ap.add_argument("--d-model", type=int)
    ap.add_argument("--d-ff", type=int)
    ap.add_argument("--d-head", type=int)
    ap.add_argument("--vocab", type=int)
    ap.add_argument("--n-experts", type=int)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), help="the parameters' dtype (default: the config's)")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), help="default: nccl with a card, else gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"),
                    help="gloo only: cuda puts several ranks on the visible cards (default: cpu)")
    ap.add_argument("--mode", help="comma-separated: train, prefill, decode (LM); train, serve, retrieval "
                                   "(RecSys); train (GCN); search (nsimplex-colors); default: the first")
    ap.add_argument("--shape", help="the cell of a RecSys, GCN or search mode (default: the mode's)")
    ap.add_argument("--size", action="append", metavar="KEY=VALUE", help="replaces one of the cell's sizes")
    ap.add_argument("--threshold", type=float,
                    help="the search cell's threshold (default: the median 3rd-nearest distance of 64 queries)")
    ap.add_argument("--opt", action="store_true", help="the cells' perf levers (local MoE dispatch, moe_local; "
                                                       "the search cell's opt variant)")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--steps", type=int, default=4, help="train steps (search: timed calls after the first)")
    ap.add_argument("--decode-steps", type=int, default=4)
    ap.add_argument("--moment-dtype", choices=("float32", "bfloat16"), default="float32",
                    help="AdamW's moment dtype (the reference's sharded test keeps f32)")
    ap.add_argument("--check", action="store_true",
                    help="the launcher compares the ranks' saved shards with the one-process port's")
    ap.add_argument("--out", help="directory for every rank's shards and results (rank{r}.pt)")
    ap.add_argument("--timeout", type=float, default=600.0, help="the launcher's limit for this run, seconds")
    ap.add_argument("--count-collectives", action="store_true",
                    help="one more untimed step or call of each mode under op_walk.CollectiveCounter: the "
                         "record's collectives[mode] holds its collective bytes by kind beside TensorParallel.moved")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "RANK" in os.environ:
        _run_rank([_parser().parse_args(a) for a in _runs(argv)])
        return 0
    rc, recs, bad = launch(argv)
    for r, code, out in bad:
        print(f"[rank {r}] exit {code}\n{out}", file=sys.stderr)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
