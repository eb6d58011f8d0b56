"""Dry run: every (architecture x input shape) cell's step, traced on meta
tensors for one card, with its counted cost and roofline terms.

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell on its production mesh.  Here a cell's plan
(``launch.steps.build_cell``) already carries its arguments as meta tensors
(shapes and dtypes, no memory), and its step runs eagerly on them under
``launch.op_walk.walk``: no memory is allocated and no kernel runs, so a
full config is walked on any host.  Each record gives the counted FLOPs and
HBM bytes, the argument, output and peak-live bytes, the plan's
``model_flops`` and ``roofline.roofline_terms`` for one card.  A step that
needs the data (``.item()``, a data-dependent shape, a kernel of this repo:
the ``nsimplex-colors`` serve step launches K4 and K3) cannot run on meta
tensors; its record says ``status="error"`` and why, as the reference
records a failed compile.  Every model cell of the registry runs on meta
tensors as it is (the MoE dispatch writes into a fixed-shape buffer, with
no ``nonzero`` and no host sync), so none needs a ``FakeTensorMode``.

``--mesh single`` is one card.  The multi-card mesh waits for the sharded
train step (ROADMAP item 11c); ``--mesh multi`` and ``both`` exit with a
message saying so.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --accum 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k --layers 2 --accum 2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --calibrate
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

__all__ = ["calibrate_cell", "main", "run_cell"]

MULTI_CARD_REFUSAL = ("the multi-card dry run needs the sharded train step, ROADMAP item 11c, which is not "
                      "ported; run --mesh single")


def _card_mesh():
    """One card as a (data=1, model=1) mesh over the meta device."""
    from repro_torch.sharding.rules import DeviceMesh

    return DeviceMesh(("data", "model"), (1, 1), (torch.device("meta"),))


def _mesh(mesh_kind: str):
    if mesh_kind != "single":
        raise ValueError(MULTI_CARD_REFUSAL)
    return _card_mesh()


def _leaf_bytes(tree) -> int:
    from repro_torch.launch.op_walk import tensor_bytes
    from repro_torch.models.params import tree_leaves

    return sum(tensor_bytes(t) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _cut_model_flops(plan, shape, accum, micro) -> float:
    """``plan.model_flops`` scaled to the steps a cut accumulation runs
    (an LM train cell's global batch is ``accum x micro`` sequences)."""
    gb = shape.sizes.get("global_batch")
    if plan.kind != "train" or accum is None or not gb:
        return plan.model_flops
    return plan.model_flops * accum * micro / gb


def run_cell(arch_id: str, shape_name: str, mesh_kind: str = "single", out_dir=None, verbose: bool = True,
             opt: bool = False, accum=None, n_layers=None) -> dict:
    """Walk one cell's step on meta tensors; ``accum`` cuts an LM train
    cell's microbatches and ``n_layers`` its depth (both recorded)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.op_walk import walk
    from repro_torch.launch.steps import _batch_shards, build_cell

    record = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind, "n_chips": 1, "status": "unknown",
              "accum": accum, "n_layers": n_layers}
    t0 = time.time()
    try:
        mesh = _mesh(mesh_kind)
        plan = build_cell(arch_id, shape_name, mesh, opt=opt, accum_override=accum, n_layers=n_layers)
        if plan.skip:
            record.update(status="skipped", reason=plan.skip)
            _write(out_dir, record)
            if verbose:
                print(f"[dryrun] SKIP {arch_id}/{shape_name}/{mesh_kind}: {plan.skip}")
            return record
        shape = get_arch(arch_id).shapes[shape_name]
        model_flops = _cut_model_flops(plan, shape, accum, _batch_shards(mesh))
        record.update(note=plan.note, kind=plan.kind, model_flops=model_flops)
        w = walk(plan.fn, *plan.args)
        record["walk_s"] = time.time() - t0
        arg_b, out_b = _leaf_bytes(plan.args), _leaf_bytes(w.result)
        record["memory"] = {"argument_bytes": arg_b, "output_bytes": out_b, "peak_live_bytes": w.peak_bytes,
                            "peak_bytes_est": arg_b + w.peak_bytes, "fits_80GB": arg_b + w.peak_bytes < 80e9}
        record["op_walk"] = {"flops": w.flops, "bytes_hbm": w.bytes_hbm, "ops": w.ops}
        record["roofline"] = rl.roofline_terms(flops_per_device=w.flops, bytes_per_device=w.bytes_hbm,
                                               collective_bytes_per_chip=0.0, n_chips=1, model_flops=model_flops)
        record["status"] = "ok"
        if verbose:
            r = record["roofline"]
            print(f"[dryrun] OK {arch_id}/{shape_name}/{mesh_kind} flops={w.flops:.4g} "
                  f"model_flops={model_flops:.4g} dominant={r['dominant']} "
                  f"bound_s={max(r['compute_s'], r['memory_s']):.4g}")
    except Exception as e:  # noqa: BLE001 - a cell that cannot run on meta tensors is recorded
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"[dryrun] FAIL {arch_id}/{shape_name}/{mesh_kind}: {record['error']}")
    record["total_s"] = time.time() - t0
    _write(out_dir, record)
    return record


def _measure_variant(arch_id, shape_name, mesh, *, n_layers, accum, kind, opt=False) -> dict:
    from repro_torch.launch.op_walk import walk
    from repro_torch.launch.steps import build_cell

    kwargs = dict(n_layers=n_layers, unroll=True, opt=opt)
    if kind == "train":
        kwargs["accum_override"] = accum
    plan = build_cell(arch_id, shape_name, mesh, **kwargs)
    w = walk(plan.fn, *plan.args)
    return {"flops": w.flops, "bytes": w.bytes_hbm, "coll_total": 0.0}


def calibrate_cell(arch_id: str, shape_name: str, mesh_kind: str = "single", out_dir=None, opt: bool = False):
    """The reference's roofline v3: fit cost(L, A) = a + b·L + A·(c + d·L)
    on shallow variants (L layers, A microbatches) and extrapolate to the
    full depth and accumulation.  An eager walk of a variant is exact, and
    the cost is linear in L and A, so the extrapolation is exact too; it
    saves walking all of a full train step's microbatches.  LM cells only
    (None otherwise)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.steps import _batch_shards, build_cell

    arch = get_arch(arch_id)
    shape = arch.shapes[shape_name]
    if arch.family != "lm" or shape.skip:
        return None
    Lf = arch.model_cfg.n_layers
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
           "method": "shallow-variant extrapolation"}
    t0 = time.time()
    try:
        mesh = _mesh(mesh_kind)
        if shape.kind == "train":
            Af = max(1, shape.sizes["global_batch"] // _batch_shards(mesh))
            pts = {(L, A): _measure_variant(arch_id, shape_name, mesh, n_layers=L, accum=A, kind="train", opt=opt)
                   for L, A in ((2, 1), (4, 1), (2, 2), (4, 2))}
            extrap = {}
            for k in pts[(2, 1)]:
                c21, c41 = pts[(2, 1)][k], pts[(4, 1)][k]
                c22, c42 = pts[(2, 2)][k], pts[(4, 2)][k]
                d = ((c42 - c41) - (c22 - c21)) / 2.0
                c = (c22 - c21) - 2.0 * d
                b = ((c41 - (c + 4 * d)) - (c21 - (c + 2 * d))) / 2.0
                a = c21 - 2 * b - (c + 2 * d)
                extrap[k] = a + b * Lf + Af * (c + d * Lf)
            rec["accum_full"] = Af
        else:
            pts = {L: _measure_variant(arch_id, shape_name, mesh, n_layers=L, accum=1, kind=shape.kind, opt=opt)
                   for L in (2, 4)}
            extrap = {}
            for k in pts[2]:
                b = (pts[4][k] - pts[2][k]) / 2.0
                extrap[k] = pts[2][k] - 2.0 * b + b * Lf
        plan_full = build_cell(arch_id, shape_name, mesh)
        rec.update(model_flops=plan_full.model_flops, opt=opt, points={str(k): v for k, v in pts.items()},
                   extrapolated=extrap)
        rec["roofline_v3"] = rl.roofline_terms(
            flops_per_device=max(extrap["flops"], 0.0), bytes_per_device=max(extrap["bytes"], 0.0),
            collective_bytes_per_chip=max(extrap["coll_total"], 0.0), n_chips=1,
            model_flops=plan_full.model_flops)
        rec["status"] = "ok"
        print(f"[calib] OK {arch_id}/{shape_name}/{mesh_kind} dominant={rec['roofline_v3']['dominant']} "
              f"roofline_frac={rec['roofline_v3']['roofline_fraction']:.3f}")
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        print(f"[calib] FAIL {arch_id}/{shape_name}/{mesh_kind}: {rec['error']}")
    rec["total_s"] = time.time() - t0
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_kind}__calib.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _write(out_dir, record):
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    fn = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description="walk every cell's step on meta tensors for one card")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"],
                    help="single: one card (multi and both wait for ROADMAP item 11c)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--opt", action="store_true",
                    help="apply the §Perf optimization levers (chunked attention/CE, local MoE dispatch)")
    ap.add_argument("--calibrate", action="store_true",
                    help="roofline v3: shallow-variant extrapolation (LM cells)")
    ap.add_argument("--accum", type=int, default=None, help="cut an LM train cell's microbatches to this many")
    ap.add_argument("--layers", type=int, default=None, help="cut the model's depth to this many layers")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        ap.exit(2, f"dryrun: --mesh {args.mesh}: {MULTI_CARD_REFUSAL}\n")

    from repro_torch.launch.steps import all_cells

    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]

    failures = 0
    for a, s in cells:
        if args.calibrate:
            rec = calibrate_cell(a, s, args.mesh, args.out, opt=args.opt)
        else:
            rec = run_cell(a, s, args.mesh, args.out, opt=args.opt, accum=args.accum, n_layers=args.layers)
        if rec is not None and rec["status"] == "error":
            failures += 1
    print(f"[dryrun] done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
