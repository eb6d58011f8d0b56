"""The dry run's tables, from the records ``python -m
repro_torch.launch.dryrun`` writes: the counterpart of the JAX package's
``tools/make_experiments.py``, on the port's record keys (``memory``,
``walk_s``, ``op_walk``, ``roofline``, ``roofline_v3``).

Four tables in Markdown: every cell's status on every mesh (fits in 80 GB
per rank, walk seconds); the single-pod roofline (256 chips; the
calibrated ``roofline_v3`` where a ``--calibrate`` record exists, else the
direct walk's), with the collective term; the hill-climbed cells, baseline
(``DIR/dryrun``) against ``--opt`` (``DIR/dryrun_opt``); and the opt
cells' memory per rank beside the baseline's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --opt --out results/dryrun_opt
  PYTHONPATH=src python -m repro_torch.launch.tables [--results results] > results/tables.md
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

__all__ = ["load", "main", "tables"]

#: the cells the reference hill-climbed, baseline against --opt
HILLCLIMBED = (("qwen2-1.5b", "train_4k"), ("mixtral-8x7b", "train_4k"), ("arctic-480b", "train_4k"),
               ("nsimplex-colors", "serve_1m"))


def load(directory: str) -> dict:
    """(arch, shape, mesh, calibrated) -> record, for every record in
    ``directory`` (empty where it does not exist)."""
    out = {}
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        out[(r["arch"], r["shape"], r["mesh"], f.endswith("__calib.json"))] = r
    return out


def fmt(x, digits=3) -> str:
    if x is None:
        return "-"
    if x == 0:
        return "0"
    return f"{x:.{digits}e}" if (abs(x) < 1e-2 or abs(x) > 1e4) else f"{x:.{digits}f}"


def _terms(store: dict, a: str, s: str, m: str):
    """The calibrated roofline of a cell where it was calibrated, else its
    walk's; None without an ok record."""
    for calib, key in ((True, "roofline_v3"), (False, "roofline")):
        r = store.get((a, s, m, calib))
        if r and r["status"] == "ok":
            return r[key]
    return None


def tables(base: dict, opt: dict) -> str:
    """The four tables (see the module) as Markdown."""
    out = ["## Dry-run status (every arch x shape x mesh)\n",
           "| arch | shape | mesh | status | fits 80GB | walk s | note |", "|---|---|---|---|---|---|---|"]
    for (a, s, m, calib), r in sorted(base.items()):
        if calib:
            continue
        fits = r.get("memory", {}).get("fits_80GB", "-")
        note = r.get("note", "") if r["status"] != "error" else r.get("error", "")
        out.append(f"| {a} | {s} | {m} | {r['status']} | {fits} | {fmt(r.get('walk_s'))} | {note[:48]} |")

    out += ["\n## Roofline baseline (single-pod, 256 chips)\n",
            "calibrated (roofline_v3, shallow-variant extrapolation) for LM cells;",
            "the direct walk for the others.\n",
            "| arch | shape | dominant | compute s | memory s | collective s | useful frac | roofline frac |",
            "|---|---|---|---|---|---|---|---|"]
    for a, s in sorted({(a, s) for a, s, m, _ in base if m == "single"}):
        v = _terms(base, a, s, "single")
        if v:
            out.append(f"| {a} | {s} | {v['dominant']} | {fmt(v['compute_s'])} | {fmt(v['memory_s'])} | "
                       f"{fmt(v['collective_s'])} | {fmt(v['useful_fraction'])} | {fmt(v['roofline_fraction'])} |")

    out += ["\n## Hillclimbed cells: baseline vs optimized\n",
            "| cell | variant | compute s | memory s | collective s | dominant | roofline frac |",
            "|---|---|---|---|---|---|---|"]
    for a, s in HILLCLIMBED:
        for label, store in (("baseline", base), ("optimized", opt)):
            v = _terms(store, a, s, "single")
            if v:
                out.append(f"| {a}/{s} | {label} | {fmt(v['compute_s'])} | {fmt(v['memory_s'])} | "
                           f"{fmt(v['collective_s'])} | {v['dominant']} | {fmt(v['roofline_fraction'])} |")

    out += ["\n## Opt-mode memory per rank\n", "| cell | mesh | baseline peak GB | opt peak GB | fits 80GB |",
            "|---|---|---|---|---|"]
    for (a, s, m, calib), r in sorted(opt.items()):
        b = base.get((a, s, m, False))
        if calib or r["status"] != "ok" or not b or b["status"] != "ok":
            continue
        bm, om = b["memory"]["peak_bytes_est"] / 2**30, r["memory"]["peak_bytes_est"] / 2**30
        out.append(f"| {a}/{s} | {m} | {bm:.1f} | {om:.1f} | {r['memory']['fits_80GB']} |")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the dry run's tables from results/dryrun and results/dryrun_opt")
    ap.add_argument("--results", default="results", help="the directory holding dryrun/ and dryrun_opt/")
    args = ap.parse_args(argv)
    sys.stdout.write(tables(load(os.path.join(args.results, "dryrun")), load(os.path.join(args.results, "dryrun_opt"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
