"""A configuration, a mix, a cell and a per-layer metric added as files and
entries are found by name, with no edit to a file that is there."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from conftest import TINY

ROOT = Path(__file__).resolve().parents[2]


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    # a new configuration: the eu deployment with 12 pivots
    cfg = json.loads((pb / "configs" / "colors112k-eu.json").read_text())
    cfg["name"] = "colors-p12"
    cfg["index"]["n_pivots"] = 12
    (pb / "configs" / "colors-p12.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "colors-p12", "source": "https://arxiv.org/abs/1707.08370",
                             "file": "portbench/configs/colors-p12.json", "reduced": [], "why": "a test"})
    # a new mix: exact k=5 from 4 clients
    (pb / "traffic" / "knn5-c4.json").write_text(json.dumps(
        {"task": "knn", "k": 5, "mode": "exact", "clients": 4, "query_pool": 4000, "check_sample": 100,
         "trace_seconds": 1}))
    bench["workloads"].append({"name": "colors-p12.knn5", "config": "colors-p12", "traffic": "knn5-c4",
                               "chips": 1, "why": "a test"})
    (pb / "limits" / "colors-p12.knn5.json").write_text(json.dumps(
        {"limits": {"failed": 0, "short": 0, "order": 0, "dist_gap": 1e-5, "set_gap": 1e-5}}))
    # a new per-layer metric, read by a file of its own
    (pb / "layers" / "requests_per_batch_call.py").write_text(
        "def read(run):\n    return run.index['rows'] / run.index['calls'] if run.index['calls'] else None\n")
    bench["per_layer"].append({"name": "requests_per_batch_call", "unit": "rows/call", "better": "higher",
                               "source": "program_span", "layer": "api + index (index.query)", "moves": "qps",
                               "workloads": ["colors-p12.knn5"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT / 'src')!r}]\n"
        "from portbench import bench\n"
        "cell = bench.load_cell('colors-p12.knn5')\n"
        "sizes = dict(" + repr(TINY) + ", clients=4)\n"
        "res = bench.run_cell(cell, seed=5, seconds=1.0, trace=True, t_start=time.perf_counter(), device='cpu', sizes=sizes)\n"
        "print(json.dumps({'file': bench.__file__, 'correct': res['out']['correct'],\n"
        "                  'metrics': sorted(res['out']['metrics']), 'k': cell['traffic_data']['k'],\n"
        "                  'pivots': cell['config_data']['index']['n_pivots']}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"].startswith(str(tmp_path))
    assert got["correct"] and got["k"] == 5 and got["pivots"] == 12
    assert "requests_per_batch_call" in got["metrics"]
