"""The dry run on the reference's production meshes, with the collective
term (``python -m repro_torch.launch.dryrun --mesh single | multi | both``),
on the CPU.

This process joins a fake process group as rank 0 of a (16, 16) or
(2, 16, 16) mesh and runs a cell's sharded step on meta tensors;
``launch.op_walk`` counts each collective's result bytes on the rank.

* The witness: qwen2-1.5b at full width, 2 layers, f32, one decode step at
  B 2 over a 2,064-token cache on (1, 2) moves 457,728 bytes all-reduced and
  1,272,832 all-gathered, what two gloo ranks on the H100 counted.
* The meta walk against real ranks: the smoke configs' train, prefill and
  decode steps on four gloo CPU ranks on (2, 2) (qwen2; mixtral reduced,
  baseline and opt), each under ``op_walk.CollectiveCounter``, count every
  kind's bytes on every rank bit for bit as the meta walk of that rank does.
  On (1, 4) in the same start of the ranks (qwen2's two kv heads over four
  ranks: k / v gathered over ``model``) ``TensorParallel.moved`` counts
  what the walk counts: the reduce-scatter results of the gathers' backward.
* Against the JAX package: every cell's plan on the production meshes has
  the reference's note, model FLOPs and chip count (the reference's
  ``build_cell`` in a subprocess over 512 forced host devices, no compile);
  the uncut records of ``run_cell`` carry them.  One smoke cell's HLO
  collective bytes on a (2, 2) host mesh are printed beside the port's,
  with no equality asserted: XLA's partitioner picks its own collectives.
* Every family's cells on both meshes (LM train, prefill and decode, dense
  and MoE, opt, RecSys, GCN) give ok records with a collective term;
  qwen2-1.5b's 12 heads over 16 ``model`` ranks walk rank 0 and rank 15,
  whose counts are equal.
* ``calibrate_cell``'s extrapolated collective bytes equal a direct walk;
  ``--mesh both`` runs in one process and leaves no process group; the
  search serve cell is an error with its reason; a process that already
  has a process group gets an error record, not the one-card walk.
* ``python -m repro_torch.launch.tables`` on records made by ``run_cell``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist

import repro_torch.launch.steps as steps_mod
from repro_torch import configs as configs_mod
from repro_torch.launch import dryrun, tables
from repro_torch.launch import process_train as pt
from repro_torch.launch.mesh import meta_process_mesh
from repro_torch.launch.op_walk import CollectiveCounter, walk
from repro_torch.launch.roofline import NVLINK_BW
from repro_torch.launch.steps import all_cells, build_cell
from repro_torch.train import AdamWConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute", "total")
CHIPS = {"single": 256, "multi": 512}

#: the gloo runs' tokens and decode steps; the batch is one sequence a batch
#: shard (a train cell's microbatch), B on (2, 2)
B, S, N_DEC = 2, 16, 1
REDUCED = ["--d-model", "64", "--d-ff", "128", "--vocab", "512"]
COMMON = ["--smoke", "--backend", "gloo", "--seq", str(S), "--decode-steps", str(N_DEC), "--steps", "1",
          "--count-collectives", "--timeout", "180"]
RUNS_2X2 = {
    "qwen2": ["--arch", "qwen2-1.5b", "--mode", "train,prefill,decode"],
    "mixtral": ["--arch", "mixtral-8x7b", *REDUCED, "--mode", "train,prefill,decode"],
    "mixtral-opt": ["--arch", "mixtral-8x7b", *REDUCED, "--opt", "--mode", "train,prefill,decode"],
}
#: qwen2's smoke config (2 kv heads) over four ``model`` ranks: k / v
#: weights gathered over ``model``, their gradients reduce-scattered
RUN_1X4 = ["--arch", "qwen2-1.5b", "--mode", "train,decode"]


def _launch(runs):
    """One start of the ranks for ``runs``: (arguments, (data, model))."""
    argv = []
    for i, (run, (data, model)) in enumerate(runs):
        argv += ([pt.THEN] if i else []) + [*run, *COMMON, "--data", str(data), "--model", str(model),
                                            "--batch", str(data)]
    rc, recs, bad = pt.launch(argv)
    assert rc == 0, bad
    return recs


@pytest.fixture(scope="module")
def world4():
    """One start of four gloo ranks: every run of RUNS_2X2 on (2, 2), then
    RUN_1X4 on (1, 4) (under the key ``"1x4"``)."""
    recs = _launch([(run, (2, 2)) for run in RUNS_2X2.values()] + [(RUN_1X4, (1, 4))])
    return dict(zip([*RUNS_2X2, "1x4"], recs))


def _meta_walk(run, mode, names, sizes, rank):
    """The meta walk of ``run``'s ``mode`` step on rank ``rank`` of a
    (data, model) mesh of ``sizes``: the cell the ranks ran (a batch of
    ``data`` sequences: train one microbatch of one sequence a batch shard;
    the decode cache the prefill's, extended by the decode steps where the
    config has no window)."""
    args = pt._parser().parse_args([*run, *COMMON])
    cfg, batch = pt._config(args), sizes[0]
    shape, sizes_, extra = {
        "train": ("train_4k", {"seq_len": S, "global_batch": batch},
                  dict(accum_override=1, opt_cfg=AdamWConfig(moment_dtype="float32", lr=1e-3))),
        "prefill": ("prefill_32k", {"seq_len": S, "global_batch": batch}, {}),
        "decode": ("decode_32k", {"seq_len": S + N_DEC if cfg.window is None else min(S, cfg.window),
                                  "global_batch": batch}, {}),
    }[mode]
    with meta_process_mesh(names, sizes, rank=rank) as mesh:
        plan = build_cell(args.arch, shape, mesh, model_cfg=cfg, sizes=sizes_, opt=args.opt, **extra)
        return walk(plan.fn, *dryrun.rank_args(plan, mesh)).collective_bytes


# ---------------------------------------------------------------------------
# the witness, and the meta walk against real ranks
# ---------------------------------------------------------------------------

def test_decode_witness_on_1x2():
    cfg = dataclasses.replace(configs_mod.get_arch("qwen2-1.5b").model_cfg, n_layers=2, dtype="float32")
    with meta_process_mesh(("data", "model"), (1, 2)) as mesh:
        plan = build_cell("qwen2-1.5b", "decode_32k", mesh, model_cfg=cfg, sizes={"seq_len": 2064, "global_batch": 2})
        got = walk(plan.fn, *dryrun.rank_args(plan, mesh)).collective_bytes
    assert got["all-reduce"] == 457_728 and got["all-gather"] == 1_272_832
    assert got["reduce-scatter"] == got["all-to-all"] == got["collective-permute"] == 0
    assert got["total"] == 2 * 457_728 + 1_272_832
    assert not dist.is_initialized()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("run", list(RUNS_2X2))
def test_meta_walk_equals_gloo_ranks_on_2x2(world4, run, mode):
    rec = world4[run]
    assert rec["mesh"] == [2, 2] and len(rec["ranks"]) == 4
    for r in rec["ranks"]:
        live = r["collectives"][mode]["counted"]
        assert live == _meta_walk(RUNS_2X2[run], mode, ("data", "model"), (2, 2), r["rank"]), (r["rank"], live)
        assert live["total"] > 0 and live["all-gather"] > 0 and live["all-reduce"] > 0
        if mode == "train":     # FSDP: the gradients reduce-scattered over data
            assert live["reduce-scatter"] > 0


@pytest.mark.parametrize("mode", ["train", "decode"])
def test_tensor_parallel_moved_equals_the_walk_on_1x4(world4, mode):
    """``moved`` counts each collective's result: with two kv heads over
    four ranks k / v weights are gathered over ``model`` and their
    gradients reduce-scattered, the shard (not the whole gradient)
    counted.  The walk adds only the global gradient norm's f32 scalar,
    all-reduced over the world."""
    rec = world4["1x4"]
    assert rec["mesh"] == [1, 4] and len(rec["ranks"]) == 4
    for r in rec["ranks"]:
        got = r["collectives"][mode]
        live, moved = got["counted"], got["moved"]
        assert live == _meta_walk(RUN_1X4, mode, ("data", "model"), (1, 4), r["rank"])
        assert live["all-gather"] == moved["all_gather"] > 0
        assert live["reduce-scatter"] == moved.get("reduce_scatter", 0)
        assert live["all-reduce"] == moved["all_reduce"] + (4 if mode == "train" else 0)
        if mode == "train":     # each layer's wk, wv (and bk, bv): this rank's quarter of their gradients
            cfg = configs_mod.get_arch("qwen2-1.5b").smoke_cfg
            kv = cfg.n_kv * cfg.d_head * (cfg.d_model + cfg.qkv_bias) * 4
            assert cfg.n_kv < 4 and moved["reduce_scatter"] == cfg.n_layers * 2 * kv // 4


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

_REFERENCE_PLANS = """
import json
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import all_cells, build_cell
out = {}
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    for a, s in all_cells():
        p = build_cell(a, s, mesh)
        out[f"{a}|{s}|{kind}"] = [p.note, p.model_flops, mesh.size, p.kind, p.skip]
print(json.dumps(out))
"""

_REFERENCE_HLO = """
import dataclasses, json
import jax
from jax.sharding import NamedSharding, PartitionSpec
import repro.launch.steps as st
from repro.configs import get_arch
from repro.launch import roofline as rl
from repro.launch.mesh import make_host_mesh

def smoke(arch_id):
    arch = get_arch(arch_id)
    shapes = {n: dataclasses.replace(sh, sizes={**sh.sizes, "seq_len": %d, "global_batch": %d})
              for n, sh in arch.shapes.items()}
    return dataclasses.replace(arch, model_cfg=dataclasses.replace(arch.smoke_cfg, dtype="float32"), shapes=shapes)

st.get_arch = smoke
mesh = make_host_mesh(2, 2)
specs = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t, is_leaf=lambda x: isinstance(x, PartitionSpec))
out = {}
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    plan = st.build_cell("qwen2-1.5b", shape, mesh, accum_override=1 if shape == "train_4k" else None)
    with jax.set_mesh(mesh):
        compiled = jax.jit(plan.fn, in_shardings=specs(plan.in_specs), out_shardings=specs(plan.out_specs)).lower(
            *plan.args).compile()
    out[shape] = rl.collective_bytes(compiled.as_text())
print(json.dumps(out))
"""


def _reference(code: str, devices: int) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True, text=True, timeout=600,
                       env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference_plans():
    return _reference(_REFERENCE_PLANS, 512)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_every_plan_matches_the_reference(reference_plans, mesh_kind):
    n = 0
    for a, s in all_cells():
        with dryrun._mesh(mesh_kind) as mesh:
            plan = build_cell(a, s, mesh)
            got = [plan.note, plan.model_flops, len(mesh.devices), plan.kind, plan.skip]
        want = reference_plans[f"{a}|{s}|{mesh_kind}"]
        assert got[0] == want[0] and got[2:] == want[2:], (a, s, got, want)
        assert got[1] == pytest.approx(want[1], rel=1e-12), (a, s)
        n += 1
    assert n == len(all_cells()) and not dist.is_initialized()


#: uncut cells whose records hold the reference's plan fields
UNCUT = [("qwen2-1.5b", "decode_32k"), ("mixtral-8x7b", "decode_32k"), ("fm", "serve_p99"),
         ("sasrec", "retrieval_cand"), ("gcn-cora", "molecule")]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", UNCUT)
def test_uncut_record_carries_the_reference_plan(reference_plans, arch, shape, mesh_kind):
    rec = dryrun.run_cell(arch, shape, mesh_kind, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    note, flops, chips, kind, _ = reference_plans[f"{arch}|{shape}|{mesh_kind}"]
    assert (rec["note"], rec["n_chips"], rec["kind"]) == (note, chips, kind)
    assert rec["model_flops"] == pytest.approx(flops, rel=1e-12)


def test_reference_hlo_collectives_beside_the_port(capsys):
    """The reference's HLO-parsed collective bytes of qwen2's smoke config
    (f32, B 2, S 16) on a (2, 2) host mesh beside the port's meta walk of
    the same cells: printed, each side's bytes present; no equality (XLA's
    partitioner chooses its own collectives)."""
    ref = _reference(_REFERENCE_HLO % (S, B), 4)
    cfg = dataclasses.replace(configs_mod.get_arch("qwen2-1.5b").smoke_cfg, dtype="float32")
    for shape, extra in (("train_4k", {"accum_override": 1}), ("prefill_32k", {}), ("decode_32k", {})):
        with meta_process_mesh(("data", "model"), (2, 2)) as mesh:
            plan = build_cell("qwen2-1.5b", shape, mesh, model_cfg=cfg, sizes={"seq_len": S, "global_batch": B},
                              **extra)
            port = walk(plan.fn, *dryrun.rank_args(plan, mesh)).collective_bytes
        assert ref[shape]["total"] > 0 and port["total"] > 0
        with capsys.disabled():
            print(f"\n[collectives (2, 2) qwen2 smoke f32 B {B} S {S}] {shape}: reference HLO "
                  f"{json.dumps(ref[shape])} port walk {json.dumps(port)}")


# ---------------------------------------------------------------------------
# every family on both production meshes
# ---------------------------------------------------------------------------

FAMILY_CELLS = [
    ("qwen2-1.5b", "train_4k", dict(accum=1, n_layers=2)),
    ("qwen2-1.5b", "prefill_32k", dict(n_layers=2)),
    ("qwen2-1.5b", "decode_32k", {}),
    ("mixtral-8x7b", "train_4k", dict(accum=1, n_layers=1)),
    ("mixtral-8x7b", "train_4k", dict(accum=1, n_layers=1, opt=True)),
    ("mixtral-8x7b", "prefill_32k", dict(n_layers=1, opt=True)),
    ("mixtral-8x7b", "decode_32k", dict(n_layers=2)),
    ("fm", "train_batch", {}),
    ("xdeepfm", "serve_p99", {}),
    ("sasrec", "train_batch", dict()),
    ("mind", "retrieval_cand", {}),
    ("gcn-cora", "full_graph_sm", {}),
    ("gcn-cora", "ogb_products", {}),
    ("gcn-cora", "minibatch_lg", {}),
]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,shape,cut", FAMILY_CELLS, ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}{w}" for k, w in v.items()) or "uncut")
def test_family_cell_on_production_mesh(tmp_path, arch, shape, cut, mesh_kind):
    rec = dryrun.run_cell(arch, shape, mesh_kind, str(tmp_path), verbose=False, **cut)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_chips"] == CHIPS[mesh_kind] and rec["rank"] == 0
    coll = rec["op_walk"]["collective_bytes"]
    assert set(coll) == set(KINDS) and coll["total"] > 0
    roof = rec["roofline"]
    assert roof["collective_s"] == pytest.approx(coll["total"] / NVLINK_BW) and roof["collective_s"] > 0
    assert roof["hlo_flops_total"] == pytest.approx(rec["op_walk"]["flops"] * CHIPS[mesh_kind])
    mem = rec["memory"]
    assert mem["fits_80GB"] == (mem["peak_bytes_est"] < 80e9) and mem["argument_bytes"] > 0
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__{mesh_kind}.json").read_text())
    assert on_disk["op_walk"] == rec["op_walk"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_uneven_head_split_walks_two_ranks(mesh_kind):
    """qwen2-1.5b's 12 heads over 16 ``model`` ranks: rank 0 computes one
    head and rank 15 none, yet both run every collective of the layer on
    slices of equal size (the SPMD program's counts)."""
    rec = dryrun.run_cell("qwen2-1.5b", "train_4k", mesh_kind, verbose=False, accum=1, n_layers=2)
    assert rec["status"] == "ok", rec.get("error")
    first, last = rec["ranks"]
    assert first["rank"] == 0 and last["rank"] == 15 and last["coords"][-1] == 15
    assert rec["collectives_equal_across_ranks"]
    assert first["collective_bytes"] == last["collective_bytes"] == rec["op_walk"]["collective_bytes"]
    assert last["flops"] < first["flops"]       # no head on rank 15
    mix = dryrun.run_cell("mixtral-8x7b", "decode_32k", mesh_kind, verbose=False, n_layers=1)
    assert "ranks" not in mix                   # 32 heads over 16: an even split, rank 0 alone


# ---------------------------------------------------------------------------
# calibration, the CLI, the serve cell, the process group's lifetime
# ---------------------------------------------------------------------------

def _smoke_arch(get, layers=None, batch=48, seq=64):
    def get_smoke(arch_id):
        arch = get(arch_id)
        cfg = arch.smoke_cfg
        if layers is not None and arch.family == "lm":
            cfg = dataclasses.replace(cfg, n_layers=layers)
        shapes = {name: dataclasses.replace(sh, sizes={**sh.sizes, **({"seq_len": min(sh.sizes["seq_len"], seq),
                                                                        "global_batch": batch}
                                                                       if "seq_len" in sh.sizes else {})})
                  for name, sh in arch.shapes.items()}
        return dataclasses.replace(arch, model_cfg=cfg, shapes=shapes)
    return get_smoke


@pytest.fixture
def smoke(monkeypatch):
    get = _smoke_arch(configs_mod.get_arch, layers=6)
    monkeypatch.setattr(steps_mod, "get_arch", get)
    monkeypatch.setattr(configs_mod, "get_arch", get)


def test_calibration_extrapolates_the_collectives(smoke, tmp_path):
    cal = dryrun.calibrate_cell("qwen2-1.5b", "train_4k", "single", str(tmp_path))
    full = dryrun.run_cell("qwen2-1.5b", "train_4k", "single", verbose=False)
    assert cal["status"] == "ok" and full["status"] == "ok", (cal.get("error"), full.get("error"))
    assert cal["accum_full"] == 48 // 16 and cal["n_chips"] == 256
    coll = full["op_walk"]["collective_bytes"]
    assert coll["total"] > 0
    for k in KINDS:
        assert cal["extrapolated"][f"coll_{k}"] == pytest.approx(coll[k], rel=1e-9, abs=1e-6), k
    assert cal["extrapolated"]["flops"] == pytest.approx(full["op_walk"]["flops"], rel=1e-9)
    v3 = cal["roofline_v3"]
    assert v3["collective_s"] == pytest.approx(coll["total"] / NVLINK_BW, rel=1e-9)
    assert v3["hlo_flops_total"] == pytest.approx(full["op_walk"]["flops"] * 256, rel=1e-9)
    assert (tmp_path / "qwen2-1.5b__train_4k__single__calib.json").exists()


def test_mesh_both_in_one_process(smoke, tmp_path, capsys):
    rc = dryrun.main(["--mesh", "both", "--arch", "qwen2-1.5b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert rc == 0 and not dist.is_initialized()
    out = capsys.readouterr().out
    assert "[dryrun] OK qwen2-1.5b/decode_32k/single" in out and "[dryrun] OK qwen2-1.5b/decode_32k/multi" in out
    for kind, chips in CHIPS.items():
        rec = json.loads((tmp_path / f"qwen2-1.5b__decode_32k__{kind}.json").read_text())
        assert rec["n_chips"] == chips and rec["op_walk"]["collective_bytes"]["total"] > 0
    cal = tmp_path / "cal"
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k", "--calibrate", "--out", str(cal)]) == 0
    for kind, chips in CHIPS.items():
        rec = json.loads((cal / f"qwen2-1.5b__decode_32k__{kind}__calib.json").read_text())
        assert rec["n_chips"] == chips and rec["roofline_v3"]["collective_s"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_serve_cell_is_an_error_with_its_reason(mesh_kind):
    rec = dryrun.run_cell("nsimplex-colors", "serve_1m", mesh_kind, verbose=False)
    assert rec["status"] == "error" and "K4 and K3" in rec["error"] and "live run" in rec["error"]
    assert rec["n_chips"] == CHIPS[mesh_kind] and not dist.is_initialized()


def test_no_fallback_to_one_card():
    """A process that already has a default group cannot join a fake one:
    the record is an error, and the caller's group is left as it was."""
    with meta_process_mesh(("data", "model"), (1, 2)):
        rec = dryrun.run_cell("gcn-cora", "molecule", "single", verbose=False)
        assert dist.is_initialized()
    assert rec["status"] == "error" and "default process group" in rec["error"] and "op_walk" not in rec
    assert not dist.is_initialized()


def test_counter_outside_a_mesh_counts_nothing():
    with CollectiveCounter() as counter:
        torch.ones(3) @ torch.ones(3)
    assert counter.bytes == {k: 0.0 for k in KINDS}


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

def test_tables_from_run_cell_records(tmp_path, capsys):
    base, opt = tmp_path / "dryrun", tmp_path / "dryrun_opt"
    for kind in ("single", "multi"):
        dryrun.run_cell("qwen2-1.5b", "train_4k", kind, str(base), verbose=False, accum=1, n_layers=2)
        dryrun.run_cell("qwen2-1.5b", "train_4k", kind, str(opt), verbose=False, accum=1, n_layers=2, opt=True)
        dryrun.run_cell("gcn-cora", "molecule", kind, str(base), verbose=False)
        dryrun.run_cell("nsimplex-colors", "serve_1m", kind, str(base), verbose=False)
    assert tables.main(["--results", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for head in ("## Dry-run status", "## Roofline baseline (single-pod, 256 chips)",
                 "## Hillclimbed cells: baseline vs optimized", "## Opt-mode memory per rank"):
        assert head in out
    rows = [line.split(" | ") for line in out.splitlines() if line.startswith("| ")]
    status = {(r[0][2:], r[1], r[2]): r[3] for r in rows if len(r) == 7 and r[2] in CHIPS}
    assert status[("qwen2-1.5b", "train_4k", "multi")] == "ok"
    assert status[("nsimplex-colors", "serve_1m", "single")] == "error"
    rec = json.loads((base / "qwen2-1.5b__train_4k__single.json").read_text())
    roof = [r for r in rows if len(r) == 8 and r[0] == "| qwen2-1.5b" and r[1] == "train_4k"]
    assert roof and roof[0][5] == tables.fmt(rec["roofline"]["collective_s"]) and roof[0][5] != "0"
    climbed = [r for r in rows if r[0] == "| qwen2-1.5b/train_4k" and len(r) == 7]
    assert [r[1] for r in climbed] == ["baseline", "optimized"]
    mem = [r for r in rows if r[0] == "| qwen2-1.5b/train_4k" and len(r) == 5]
    assert {r[1] for r in mem} == {"single", "multi"}
