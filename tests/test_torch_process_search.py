"""The paper's search serve cell on a mesh of processes, on the CPU.

``python -m repro_torch.launch.process_train --arch nsimplex-colors --mode
search --check`` runs gloo ranks on (2, 1), (1, 2) and (2, 2) ``(data,
model)`` meshes, the baseline (rows over the batch axes, Algorithm 2, K1
and a sort into 128 slots) and ``--opt`` (rows over every axis, K4, K3 into
8 slots), at two thresholds: 0.046, where no query has more than 6
candidates, and 0.09, where every query overflows the opt cell's slots
(K1's completion of the accepted column).  The smoke config's colors rows
under sqrt-JSD, cut to 7,900 rows so that every shard holds real rows; the
table pads to 8,192 rows with rows of altitude +inf.  The runs of one world
size share one start of its ranks (``--then``).  Held:

* every rank's histograms and candidate slots equal the one-process grid's
  (``steps.build_cell`` on a host mesh of the same shape: the launcher's
  check), exactly;
* the histograms sum to the padded table, no padding row is a candidate,
  and the padding rows are counted excluded;
* the histograms equal the JAX package's ``build_serve_step`` on its
  one-device host mesh under ``jax.jit`` on the same inputs, and each
  query's packed (id, code) set equals the reference's where neither
  overflows its slots (every query at 0.046); both thresholds lie more
  than 1e-5 (relative) from every f32 bound, checked first;
* each rank holds 1 / its shard count of the table's rows, and its K3 /
  K4 / K1 outputs equal their plain versions on its inputs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh as rmake_host_mesh
from repro.search import distributed as rdistributed
from repro_torch.configs import get_arch
from repro_torch.core.simplex import apex_addition
from repro_torch.kernels import ref
from repro_torch.launch import process_train, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.search.distributed import build_process_filter
from repro_torch.sharding.rules import ProcessMesh

ARCH, N_OBJECTS, N_PAD, Q = "nsimplex-colors", 7900, 8192, 16
THRESHOLDS = (0.046, 0.09)
MESHES = [(2, 1), (1, 2), (2, 2)]
RUNS = [(data, model, opt, t) for data, model in MESHES for opt in (False, True) for t in THRESHOLDS]


def _argv(data, model, opt, t, out):
    return ["--arch", ARCH, "--smoke", "--mode", "search", "--data", str(data), "--model", str(model),
            "--backend", "gloo", "--size", f"n_objects={N_OBJECTS}", "--threshold", str(t), "--steps", "1",
            "--check", "--out", str(out), "--timeout", "120"] + (["--opt"] if opt else [])


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every run's record and its ranks' saved results: the runs of one
    world size in one start of its ranks."""
    got = {}
    for world in sorted({d * m for d, m in MESHES}):
        runs = [r for r in RUNS if r[0] * r[1] == world]
        argv, outs = [], []
        for i, run in enumerate(runs):
            outs.append(tmp_path_factory.mktemp("search_{}x{}_{}_{}".format(*run)))
            argv += ([process_train.THEN] if i else []) + _argv(*run, outs[-1])
        rc, recs, bad = process_train.launch(argv)
        assert rc == 0, bad
        for run, rec, out in zip(runs, recs, outs, strict=True):
            got[run] = rec, [torch.load(out / f"rank{r}.pt")["search"] for r in range(world)]
    return got


@pytest.fixture(params=RUNS, ids=lambda r: "{}x{}-{}-t{}".format(r[0], r[1], "opt" if r[2] else "base", r[3]))
def run(request, launched):
    return request.param, *launched[request.param]


def _cfg():
    return get_arch(ARCH).smoke_cfg


@functools.cache
def _inputs(t):
    sizes = {"n_objects": N_OBJECTS, "query_batch": Q, "n_pivots": _cfg().n_pivots}
    return process_train.search_inputs(_cfg(), sizes, torch.device("cpu"), t)


def _slots(opt, data, model):
    return 8 if opt else _cfg().max_candidates, data * model if opt else data


def test_equal_to_the_one_process_grid(run):
    (data, model, opt, t), rec, saved = run
    assert rec["world"] == data * model and rec["mesh"] == [data, model]
    assert rec["search_equal_one_process"]
    K, shards = _slots(opt, data, model)
    assert rec["n_shards"] == shards
    for got in saved:
        assert tuple(got["idx"].shape) == tuple(got["code"].shape) == (shards, Q, K)
        for key in ("hist", "idx", "code"):
            assert torch.equal(got[key], saved[0][key])
    # queries with more candidates than all their slots: none at the low
    # threshold, some at the high one
    overflow = rec["overflowing_queries"]
    assert (overflow == 0) if t == THRESHOLDS[0] else (overflow > 0)


def test_padding_rows_are_never_candidates(run):
    (data, model, opt, t), rec, saved = run
    assert rec["hist_sums_to_padded_rows"] and rec["padding_never_candidate"] and rec["padding_excluded"]
    for got in saved:
        assert bool((got["hist"].sum(dim=1) == N_PAD).all())
        assert int(got["idx"].max()) < N_OBJECTS
        assert bool((got["hist"][:, 0] >= N_PAD - N_OBJECTS).all())


def _far_from_bounds(t, opt):
    """The threshold's bands lie more than 1e-5 (relative) from every f32
    bound of the projected queries (the reference's projection and the
    port's may round differently)."""
    table, Linv, sq, sigma, qd, _ = _inputs(t)
    q = ref.apex_project_ref(qd, Linv, sq) if opt else apex_addition(sigma, qd)
    lwb, upb = ref.apex_bounds_batch_ref(table[:N_OBJECTS], q, q.shape[1])
    hi, lo = t * (1 + 1e-5) + 1e-9, t * (1 - 1e-5) - 1e-9
    return min(float((lwb - hi).abs().min()), float((upb - lo).abs().min())) / t > 1e-5


@functools.cache
def _reference(opt, t):
    """The JAX package's serve step on its one-device host mesh under
    ``jax.jit``, with the cell's projection, selection and slots."""
    K, _ = _slots(opt, 1, 1)
    serve = rdistributed.build_serve_step(rmake_host_mesh(1, 1), n_pivots=_cfg().n_pivots, max_candidates=K,
                                          projection="gemm" if opt else "paper",
                                          selection="topk" if opt else "sort")
    table, *consts, qd, _ = _inputs(t)
    out = jax.jit(serve)(*(jnp.asarray(a.numpy()) for a in (table, *consts, qd)), jnp.float32(t))
    return [np.asarray(o) for o in out]


def _pairs(idx, code, q):
    return sorted((int(a), int(c)) for a, c in zip(idx[:, q].ravel(), code[:, q].ravel()) if a >= 0)


def test_equal_to_jax(run):
    (data, model, opt, t), rec, saved = run
    assert _far_from_bounds(t, opt)
    hist, idx, code = _reference(opt, t)
    got = saved[0]
    np.testing.assert_array_equal(got["hist"].numpy(), hist)
    K, shards = _slots(opt, data, model)
    compared = 0
    for q in range(Q):
        n = int(hist[q, 1] + hist[q, 2])
        if n <= min(K, idx.shape[-1]):
            assert _pairs(got["idx"].numpy(), got["code"].numpy(), q) == _pairs(idx, code, q), q
            compared += 1
    assert compared == Q or t != THRESHOLDS[0]


def test_ranks_hold_their_rows_and_kernels_match_plain(run):
    (data, model, opt, t), rec, _ = run
    _, shards = _slots(opt, data, model)
    for r in rec["ranks"]:
        assert r["table_bytes"] * shards == rec["whole_table_bytes"] == N_PAD * _cfg().n_pivots * 4
        checks = r["kernel_checks"]
        # K1 runs on every query under the sort selection, on the overflowing
        # ones under K3's (none at the low threshold)
        k1 = not opt or "apex_bounds_batch" in checks
        assert set(checks) == ({"apex_project", "apex_threshold"} if opt else set()) | (
            {"apex_bounds_batch"} if k1 else set())
        assert k1 or t == THRESHOLDS[0] or shards > 1
        assert not (opt and k1 and t == THRESHOLDS[0])
        if opt:
            assert checks["apex_project"] == 0.0 and checks["apex_threshold"]["equal_to_plain_selection"]
        if k1:
            assert checks["apex_bounds_batch"]["max_abs_err"] == 0.0
        assert r["launches"] == {}          # the CPU runs the plain versions: no kernel launches


def _stand_in(data, model, rank=0):
    return ProcessMesh(("data", "model"), (data, model), (torch.device("cpu"),) * (data * model), rank=rank)


@pytest.mark.parametrize("opt", [False, True])
def test_the_cell_builds_on_a_process_mesh(opt):
    """The plan on a ProcessMesh keeps the host mesh's arguments, specs and
    note (the process groups are looked up only when the step runs)."""
    one = steps.build_cell(ARCH, "serve_1m", make_host_mesh(2, 2, devices=["cpu"] * 4), opt=opt)
    got = steps.build_cell(ARCH, "serve_1m", _stand_in(2, 2), opt=opt)
    assert got.kind == "search_serve" and got.note == one.note and got.in_specs == one.in_specs
    assert [tuple(a.shape) for a in got.args] == [tuple(a.shape) for a in one.args] and callable(got.fn)


def test_process_filter_refuses_axes_off_the_mesh():
    with pytest.raises(ValueError, match="not all in the mesh"):
        build_process_filter(_stand_in(2, 1), table_axes=("pod", "data"))
    with pytest.raises(ValueError, match="selection"):
        build_process_filter(_stand_in(2, 1), selection="argsort")


def test_smoke_sizes_come_from_the_config():
    """--smoke takes the smoke config's rows, queries and pivots; --size
    cuts them further."""
    args = process_train._parser().parse_args(["--arch", ARCH, "--smoke", "--mode", "search",
                                               "--size", "n_objects=100"])
    plan, _, sizes = process_train._cell_plan(args, _cfg(), "search", make_host_mesh(1, 1, devices=["cpu"]))
    cfg = dataclasses.asdict(_cfg())
    assert sizes == {"n_objects": 100, "query_batch": cfg["query_batch"], "n_pivots": cfg["n_pivots"]}
    assert tuple(plan.args[0].shape) == (8192, cfg["n_pivots"]) and tuple(plan.args[4].shape)[0] == Q
