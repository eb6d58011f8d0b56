"""Readings behind the limits: the program's compared numbers over many
seeds, and the control's, in one process per cell.

    python portbench/control.py --workload <cell> --seeds 11,12,13 --control-seeds 11,12 --seconds 5

For each of ``--seeds`` one run of the cell (a window of ``--seconds``)
prints the numbers its check compared; for each of ``--control-seeds`` the
plain reference, computed in the precision below the one the configuration
states (``control_dtype``: bfloat16 for a float32 refinement, float32 for a
float64 one), is put in the program's place for the mix's ``check_sample``
queries (as many as a full run compares, or more), and the same numbers are
printed: they must fail a limit.  One
JSON line per reading.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell: dict, seed: int, *, n_answers: int, device: str = "cuda", sizes: dict = None) -> dict:
    """The compared numbers of the control on the seed's first ``n_answers``
    queries (as many as a run compares)."""
    import torch

    from portbench import bench, check
    from portbench.reference import Reference

    cfg, mix = dict(cell["config_data"]), dict(cell["traffic_data"])
    sizes = sizes or {}
    cfg["n_rows"] = sizes.get("n_rows", cfg["n_rows"])
    pool = int(sizes.get("query_pool", mix["query_pool"]))
    mix["query_pool"], mix["clients"] = pool, int(sizes.get("clients", mix["clients"]))
    corpus, queries = bench.cell_data(cfg, mix, seed)
    queries = queries[:pool]
    low = Reference(corpus, cfg["metric"], device=device, dtype=getattr(torch, cfg["control_dtype"]))
    pos = list(range(min(n_answers, pool)))
    ids, d = low.knn(queries[pos], int(mix["k"]))
    del low
    return check.compare(mix, queries, dict(zip(pos, zip(ids, d))), 0, Reference(corpus, cfg["metric"], device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program's readings")
    ap.add_argument("--control-seeds", default="", help="comma-separated seeds of the control's readings")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for p in (str(_ROOT / "src"), str(_ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t0 = time.perf_counter()
        res = bench.run_cell(cell, seed=seed, seconds=args.seconds, trace=False, t_start=t0)
        print(json.dumps({"reading": "program", "workload": args.workload, "seed": seed,
                          "correct": res["out"]["correct"], "n_compared": res["n_compared"], "ref_s": res["ref_s"],
                          "metrics": {k: v["value"] for k, v in res["out"]["metrics"].items()},
                          "numbers": {k: v["value"] for k, v in res["checks"].items()}}), flush=True)
        torch.cuda.empty_cache()
    for seed in (int(s) for s in args.control_seeds.split(",") if s):
        t0 = time.perf_counter()
        numbers = control_numbers(cell, seed, n_answers=int(cell["traffic_data"]["check_sample"]))
        limits = cell["limits"]
        print(json.dumps({"reading": "control", "workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, "numbers": numbers,
                          "fails": sorted(k for k, v in numbers.items() if v > limits[k])}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
