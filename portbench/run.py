"""Run one cell of the port's benchmark once, on the card, and print its result.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result (JSON): ``--trace 0`` gives the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, the device's busy seconds and a
breakdown.  The compared numbers and their limits end both standard error
and the result line (``checks``).  Exits non-zero, printing no result,
without a card, with a forbidden module loaded (JAX or the JAX package),
or when a run fails.  See ``portbench/README.md``.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
#: host threads of each numeric library (OpenMP, MKL, OpenBLAS, torch's
#: intra-op pool): the load comes from one process with few threads
HOST_THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)


def _paths() -> None:
    for p in (str(_ROOT / "src"), str(_ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # the kernel tuner's cache is read from a fixed path inside the checkout
    # (never written by a run), so a HOME's leftover cache cannot change plans
    os.environ["REPRO_TORCH_KERNEL_TUNE_CACHE"] = str(_ROOT / "build" / "portbench" / "kernel_tuning.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")
    _paths()
    from portbench import bench

    cell = bench.load_cell(args.workload)
    import torch

    torch.set_num_threads(HOST_THREADS)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    res = bench.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t_start=_T_START)
    bad = bench.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"portbench: set-up phases (s) {json.dumps(res['setup_phases'])}", file=sys.stderr)
    print(f"portbench: window {json.dumps(res['window'])}", file=sys.stderr)
    if res["trace"] is not None:
        print(f"portbench: trace {json.dumps(res['trace'].diag)}", file=sys.stderr)
    print(f"portbench: compared {res['n_compared']} answers; reference {res['ref_s']:.3f} s", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(bench.result_line(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
