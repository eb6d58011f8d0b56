"""Runs one of the JAX package's walkthroughs (``examples/<name>.py``) and
prints its summary, in the port's summary form
(``repro_torch.examples.summary``), as the last line of its output.

    PYTHONPATH=src JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python tests/examples_reference.py quickstart
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/examples_reference.py train_lm --ckpt-dir DIR --params OUT.npz
    PYTHONPATH=src python tests/examples_reference.py --write src/repro_torch/examples/reference_summaries.json

The script's own code runs as it is: its module body, then the body of its
``main()`` inlined at module level, so that ``main``'s locals stay readable
after it ran (each ``extract_<name>`` reads them); a call in ``main`` of
another module function with its parameters' own names as arguments is
inlined the same way.  ``--use-kernel`` builds
every index with ``use_kernel=True`` (the bound scan through the Pallas
kernels in interpret mode), the algorithm the port follows.  ``--params``
writes the parameters the script initialised (``retrieval_recsys``,
``train_lm``) to an ``.npz`` keyed by tree path.

``RUNS`` fixes how each walkthrough's reference run is made (``Run``
launches it so); ``--write`` makes every run at once and writes the
summaries, with those settings, as ``reference_summaries.json``.

The parity tests run it in a subprocess of its own: a walkthrough may set
``XLA_FLAGS`` before jax starts (``mesh_scaleout``), and a reference module
imported into a shared test worker may print into another test's capture.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: each walkthrough's reference run: the script's flags, jax's x64 mode (the
#: search half fits its pivots in f64 as the port does; the model half runs
#: as the script does) and use_kernel (the port follows the kernel path's
#: algorithm; set where a count of the default path differs from it:
#: quickstart's k-NN evaluations 3,643 against 3,656, expensive_metric_search's
#: ledger 146,731 / 3,268 against 146,729 / 3,270, service_demo's 8,889
#: against 8,890; mesh_scaleout keeps the default, whose own pivot assertion
#: fails under the kernel path's guard band at t = 1e-9)
RUNS = {
    "quickstart": dict(argv=[], x64=True, use_kernel=True),
    "expensive_metric_search": dict(argv=[], x64=True, use_kernel=True),
    "quality_tradeoff": dict(argv=[], x64=True, use_kernel=False),
    "filtered_search": dict(argv=[], x64=True, use_kernel=False),
    "kernel_tuning": dict(argv=[], x64=True, use_kernel=False),
    "online_updates": dict(argv=[], x64=True, use_kernel=False),
    "mesh_scaleout": dict(argv=[], x64=True, use_kernel=False),
    "service_demo": dict(argv=[], x64=True, use_kernel=True),
    "frontend_demo": dict(argv=[], x64=True, use_kernel=False),
    "retrieval_recsys": dict(argv=[], x64=False, use_kernel=False),
    "train_lm": dict(argv=["--steps", "3"], x64=False, use_kernel=False),
}


def execute(name: str, argv=()) -> tuple:
    """(namespace, stdout) of ``examples/<name>.py`` run with ``argv``."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    body, defs = [], {}
    for node in tree.body:
        if isinstance(node, ast.If) and "__name__" in ast.unparse(node.test):
            continue
        body.append(node)
        if isinstance(node, ast.FunctionDef):
            defs[node.name] = node
    main_body = []
    for node in defs["main"].body if "main" in defs else []:
        # a call of a module function with its parameters' own names as
        # arguments (online_updates' durable_walkthrough) is inlined too
        call = node.value if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) else None
        fn = defs.get(getattr(getattr(call, "func", None), "id", None))
        if fn is not None and [getattr(a, "id", None) for a in call.args] == [a.arg for a in fn.args.args]:
            main_body.extend(fn.body)
        else:
            main_body.append(node)
    code = compile(ast.Module(body=body + main_body, type_ignores=[]), path, "exec")
    ns = {"__name__": "__reference_example__", "__file__": path}
    sys.argv = [path, *argv]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(code, ns)
    return ns, out.getvalue()


def use_kernel_everywhere() -> None:
    """Every ``build_index`` and ``ExactSearchEngine`` of the run defaults to
    ``use_kernel=True``."""
    import functools

    import repro.api
    import repro.api.factory
    import repro.search
    import repro.search.engine

    build = repro.api.factory.build_index
    patched = functools.partial(build, use_kernel=True)
    repro.api.build_index = repro.api.factory.build_index = patched
    init = repro.search.engine.ExactSearchEngine.__init__

    def engine_init(self, *a, **kw):
        kw.setdefault("use_kernel", True)
        init(self, *a, **kw)

    repro.search.engine.ExactSearchEngine.__init__ = engine_init


def summary(exact=None, close=None, counts=None) -> dict:
    return {"exact": exact or {}, "close": close or {}, "counts": counts or {}}


def _ids(batch) -> list:
    return [np.asarray(r.ids).tolist() for r in batch]


# -- extractors: main()'s locals -> the port's summary sections --------------------
def extract_quickstart(ns, out):
    batch, hits = ns["batch"], ns["hits"]
    return summary(
        exact={"stats": ns["index"].stats(), "plan": ns["stages"], "knn_ids": _ids(batch),
               "threshold_ids": sorted(np.asarray(hits.ids).tolist()), "denied_top1": int(ns["denied"].ids[0])},
        close={"threshold_f32": ns["t"], "knn_distances_f32": [np.asarray(r.distances).tolist() for r in batch]},
        counts={"knn_original_calls": batch.total_original_calls,
                "threshold_original_calls": hits.stats.original_calls,
                "threshold_admitted": hits.stats.accepted_no_check},
    )


def extract_expensive_metric_search(ns, out):
    ledger, dec = ns["ledger"], ns["dec"]
    decisions = dict(zip(*np.unique(dec, return_counts=True)))
    return summary(
        exact={"objects": len(ns["queries"]) * ns["data"].shape[0], "results": ledger["results"],
               "last_query_ids": np.sort(np.asarray(ns["rep"].results)).tolist()},
        close={"threshold": ns["t_sample"]},
        counts={"excluded": ledger["excluded"], "admitted": ledger["admitted"], "rechecked": ledger["rechecked"],
                "k6_decisions": [int(decisions.get(k, 0)) for k in ("excl", "admit", "recheck")]},
    )


def extract_quality_tradeoff(ns, out):
    N, K, queries, oracle, index = ns["N"], ns["K"], ns["queries"], ns["oracle"], ns["index"]
    dims = [ns["N_PIVOTS"] // 8, ns["N_PIVOTS"] // 4, ns["N_PIVOTS"] // 2, ns["N_PIVOTS"]]
    hits, evals = [], []
    for d in dims:      # the script's sweep again, its lines parsed for the check below
        batch = index.knn_batch(queries, K, mode="approx", dims=d, refine=64)
        hits.append(int(sum(len(np.intersect1d(r.ids, o)) for r, o in zip(batch, oracle))))
        evals.append(batch.total_original_calls / len(queries))
    printed = [line.split() for line in out.splitlines() if line.split()[:1] in ([str(d)] for d in dims)]
    assert [float(p[2]) for p in printed] == evals and [float(p[1]) for p in printed] == [
        round(h / (K * len(queries)), 3) for h in hits], printed
    hit = ns["hit"]
    return summary(
        exact={"stats": index.stats(), "dims": dims, "evals_per_query": evals,
               "exact_ids": np.asarray(ns["exact"].ids).tolist(), "approx_ids": np.asarray(ns["approx"].ids).tolist(),
               "approx": ns["approx"].approx, "reloaded_approx": ns["loaded"].approx},
        close={"threshold": ns["t"]},
        counts={"hits": hits, "threshold_results": len(hit), "threshold_admitted": hit.stats.accepted_no_check},
    )


def extract_filtered_search(ns, out):
    res = ns["res"]
    return summary(
        exact={"matching_rows": int(len(ns["match"])), "strategy": ns["plan"]["filter"], "stage": ns["stage"],
               "top5": np.asarray(res.ids).tolist(), "after_insert": np.asarray(ns["fresh"].ids).tolist()},
        close={"top5_distances": np.asarray(res.distances).tolist()},
        counts={"original_calls": res.stats.original_calls,
                "postfilter_original_calls": ns["forced"].stats.original_calls},   # the loop's last mode
    )


def extract_kernel_tuning(ns, out):
    batch = ns["batch"]
    return summary(
        exact={"fused_ids": np.asarray(ns["ids"]).tolist(), "knn_ids": _ids(batch),
               "knn_top1": [int(r.ids[0]) for r in batch[:8]]},
        close={"knn_distances": [np.asarray(r.distances).tolist() for r in batch]},
    )


def _line(out, label):
    return next(line for line in out.splitlines() if line.startswith(label))


def extract_online_updates(ns, out):
    import re

    refits = int(re.search(r"(\d+) refit\(s\)", _line(out, "drift refit")).group(1))
    add, rm = (list(map(int, re.findall(r"\d+", _line(out, label)))) for label in ("after add", "after remove"))
    return summary(
        exact={"after_add": add, "after_remove_upsert": rm,
               "after_compact": int(re.search(r": (\d+) base", _line(out, "after compact")).group(1)),
               "shard_objects": ns["sharded"].stats()["shard_objects"],
               "wal_records": int(re.search(r": (\d+) WAL", _line(out, "durable writes")).group(1)),
               "durable_live": int(re.search(r"(\d+) live", _line(out, "durable writes")).group(1)),
               "recovered_live": int(re.search(r"\((\d+) live", _line(out, "crash recovery")).group(1)),
               "durable_knn_ids": _ids(ns["want"]), "drift_action": ns["action"], "refits": refits,
               "after_refit_ids": _ids(ns["after"])},
        close={"drift_stat": ns["stat"],
               "durable_knn_distances_f32": [np.asarray(r.distances).tolist() for r in ns["want"]]},
    )


def extract_mesh_scaleout(ns, out):
    import ast as _ast

    shapes = [_ast.literal_eval(line[line.index("{"):line.index("}") + 1])
              for line in out.splitlines() if line.split(" {")[0] in ns["layouts"]]
    return summary(
        exact={"grid_shapes": shapes, "range_ids": _ids(ns["want"]), "knn_ids": _ids(ns["seq"]),
               "pivot_calls": sorted(ns["calls"]), "n_shards": ns["stats"]["n_shards"], "devices": ns["n_dev"]},
        close={"threshold_f32": ns["threshold"]},
    )


def extract_service_demo(ns, out):
    direct = ns["direct"]
    burst = ns["index"].query(ns["queries"][:32], ns["spec"])     # the burst's stats were read before the stream
    return summary(
        exact={"plan": ns["index"].plan(ns["spec"]).explain()["stages"],
               "burst_batches": int(_line(out, "burst of 32").split(":")[1].split()[0]),
               "burst_occupancy": float(_line(out, "burst of 32").split("occupancy")[1].split(",")[0]),
               "burst_ids": _ids(direct), "poisson_requests": ns["st"]["n_requests"]},
        close={"burst_distances": [np.asarray(r.distances).tolist() for r in direct]},
        counts={"direct_original_calls": burst.total_original_calls},
    )


def extract_frontend_demo(ns, out):
    import ast as _ast

    cal = ns["cal"]
    tenants = [_ast.literal_eval(_line(out, label).split("serving " if label == "frontend" else "tenants now ")[1])
               for label in ("frontend", "hot add/remove")]
    q0 = ns["queries"][:1]
    return summary(
        exact={"tenants": tenants[0], "tenants_after": tenants[1],
               "products_ids": _ids(ns["products"].knn_batch(q0, 10))[0],
               "reviews_ids": _ids(ns["reviews"].knn_batch(q0, 10))[0],
               "prior_evals": cal["prior_evals"], "calibration_source": cal["source"]},
        counts={"calibrated_evals": cal["calibrated_evals"]},
    )


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def extract_retrieval_recsys(ns, out):
    import re

    import jax
    import jax.numpy as jnp

    cfg, step, ub = ns["cfg"], ns["step"], ns["user_history_batch"]
    params0 = ns["init_fn"](cfg, jax.random.PRNGKey(0))
    params, opt, losses = params0, ns["init_state"](ns["opt_cfg"], params0), []
    for i in range(10):             # the script's loop again, each step's loss kept
        seqs, targets = ub(64, cfg.seq_len, cfg.n_items, seed=i)
        params, opt, loss = step(params, opt, {"seqs": jnp.asarray(seqs), "targets": jnp.asarray(targets)})
        losses.append(float(loss))
    assert f"{losses[-1]:.3f}" in _line(out, "trained 10 steps")
    retriever, top, scored, pruned = ns["retriever"], [], [], []
    for u in ns["users"]:
        idx, _, stats = retriever.top_k(u, k=10)
        top.append(np.asarray(idx).tolist())
        scored.append(int(stats.exact_scored))
        pruned.append(int(stats.pruned))
    assert scored == [int(m) for m in re.findall(r"scored (\d+)/", out)]
    return {**summary(exact={"steps": 10, "candidates": len(ns["items"]), "users": len(ns["users"])},
                      close={"losses": losses, "top_ids": top}, counts={"scored": scored, "pruned": pruned}),
            "params": _flat(params0)}


def extract_train_lm(ns, out):
    m, cfg = ns["metrics"], ns["cfg"]
    return {**summary(exact={"config": cfg.name, "params_m": round(cfg.param_count() / 1e6, 1), "steps": m.steps_run,
                             "failures_recovered": m.failures_recovered, "restored_from": m.restored_from},
                      close={"losses": [float(x) for x in m.losses]}),
            "params": _flat(ns["params"])}


EXTRACT = {name[len("extract_"):]: fn for name, fn in dict(globals()).items() if name.startswith("extract_")}


class Run:
    """One reference run in a subprocess of its own, started at once."""

    def __init__(self, name: str, workdir: str):
        run = RUNS[name]
        self.name, self.params = name, None
        argv = [sys.executable, os.path.abspath(__file__), name, *run["argv"]]
        if run["use_kernel"]:
            argv.append("--use-kernel")
        if name in ("retrieval_recsys", "train_lm"):
            self.params = os.path.join(workdir, f"{name}_params.npz")
            argv += ["--params", self.params]
        if name == "train_lm":
            argv += ["--ckpt-dir", os.path.join(workdir, "ckpt")]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
                   JAX_ENABLE_X64="1" if run["x64"] else "0")
        self._proc = subprocess.Popen(argv, cwd=workdir, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)
        self._result = None

    def result(self, timeout: float = 600) -> tuple:
        """(summary, the script's stdout); raises if the run failed."""
        if self._result is None:
            try:
                out, err = self._proc.communicate(timeout=timeout)
            finally:
                self.stop()
            if self._proc.returncode != 0:
                raise RuntimeError(f"reference {self.name} exited {self._proc.returncode}:\n{err[-4000:]}")
            *lines, last = out.rstrip("\n").split("\n")
            self._result = (json.loads(last), "\n".join(lines) + "\n")
        return self._result

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait()


def write(path: str) -> None:
    """Every reference run at once, their summaries to ``path`` (JSON)."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        runs = {}
        for name in RUNS:
            os.makedirs(os.path.join(td, name))
            runs[name] = Run(name, os.path.join(td, name))
        out = {}
        for name, run in runs.items():
            summary_, _ = run.result()
            out[name] = {"reference_run": RUNS[name], **summary_}
    with open(path, "w") as f:       # one line per section
        f.write("{\n" + ",\n".join(
            f" {json.dumps(name)}: {{\n" + ",\n".join(f"  {json.dumps(k)}: {json.dumps(v)}" for k, v in sections.items())
            + "\n }" for name, sections in out.items()) + "\n}\n")


def main() -> None:
    if sys.argv[1:2] == ["--write"]:
        write(sys.argv[2])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--params", default=None)
    args, rest = ap.parse_known_args()
    if args.use_kernel:
        use_kernel_everywhere()
    ns, out = execute(args.name, rest)
    sys.stdout.write(out)
    result = EXTRACT[args.name](ns, out)
    if args.params:
        np.savez(args.params, **result.pop("params"))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
