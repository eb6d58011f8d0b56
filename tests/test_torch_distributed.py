"""The port's distributed filter and device grid, on grids of CPU devices.

``repro_torch.search.distributed.build_distributed_filter`` runs over
``make_scaleout_mesh`` grids of 1, 2 and 4 CPU devices (the same
``torch.device("cpu")`` repeated: each grid position is one slice of the
table and one filter call, as each card would be), with 1 and 2 replica
groups.  Held against the reference's host decisions
(``tests/test_sharding.py::test_sharded_filter_matches_host_reference``,
restated: an NSimplexProjector table of 2,048 colors rows, 8 pivots, 16
queries, 64 slots; t = 0.038, where the reference test's 0.05 puts f32
bounds within 1e-5 of a band): the histogram equal to a host count wherever
no bound lies within 1e-5 relative of a band (asserted first), every
non-excluded row packed when it fits, the overflow flagged when it does
not; the JAX package's own filter on its one-device mesh packing the same
(id, code) sets; ``"topk"`` (K3) and ``"sort"`` (K1 + a stable sort) giving
the same slots; the route past K3's 4,096 slots; the grid's shapes and
the layout's validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NSimplexProjector as RProjector, select_pivots as rselect
from repro.data import colors_like
from repro.metrics import get_metric as rmetric
from repro.search.distributed import build_distributed_filter as rfilter
from repro_torch.search import distributed
from repro_torch.sharding import ShardLayout, apex_table_specs, make_scaleout_mesh, place_rows

torch.set_num_threads(1)

CPU = torch.device("cpu")
T, K = 0.038, 64
EPS = 1e-5


@pytest.fixture(scope="module")
def apexes():
    X = colors_like(n=2064, seed=5)
    proj = RProjector(pivots=rselect(X[:2048], 8, seed=1), metric=rmetric("euclidean"), dtype=np.float64)
    table = np.asarray(proj(X[:2048]), dtype=np.float32)
    queries = np.asarray(proj(X[2048:2064]), dtype=np.float32)
    return table, queries


def _host(table, queries, t):
    """The reference test's host decisions (difference form, f32)."""
    head = ((table[None, :, :-1] - queries[:, None, :-1]) ** 2).sum(-1)
    lwb = np.sqrt(head + (table[None, :, -1] - queries[:, None, -1]) ** 2)
    upb = np.sqrt(head + (table[None, :, -1] + queries[:, None, -1]) ** 2)
    t_hi, t_lo = np.float32(t) * np.float32(1 + EPS) + np.float32(1e-9), np.float32(t) * np.float32(1 - EPS) - np.float32(1e-9)
    return lwb, upb, t_hi, t_lo


def _separated(lwb, upb, t_hi, t_lo, rel=1e-5):
    return not any(np.any(np.abs(b - band) <= rel * band) for b in (lwb, upb) for band in (t_hi, t_lo))


def _run(table, queries, t, devices, replicas=1, k=K, selection="topk", t_lo=None):
    mesh = make_scaleout_mesh(ShardLayout(replicas=replicas), devices)
    fn = distributed.build_distributed_filter(mesh, max_candidates=k, selection=selection)
    return [x.numpy() for x in fn(torch.from_numpy(table), torch.from_numpy(queries), t, t_lo)]


GRIDS = [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2)]


@pytest.mark.parametrize("n_dev,replicas", GRIDS)
def test_filter_matches_host_reference(apexes, n_dev, replicas):
    table, queries = apexes
    lwb, upb, t_hi, t_lo = _host(table, queries, T)
    assert _separated(lwb, upb, t_hi, t_lo), "a bound lies within 1e-5 of a band: pick another t"
    hist, idx, code = _run(table, queries, T, [CPU] * n_dev, replicas)
    D = n_dev // replicas
    assert hist.shape == (16, 3) and idx.shape == (D, 16, K) and code.shape == (D, 16, K)
    assert (hist.sum(1) == 2048).all()
    np.testing.assert_array_equal(hist[:, 0], (lwb > t_hi).sum(1))
    np.testing.assert_array_equal(hist[:, 2], (upb <= t_lo).sum(1))
    rows_local = 2048 // D
    for q in range(16):
        interesting = np.where(lwb[q] <= t_hi)[0]
        packed = idx[:, q, :]
        ids = packed[packed >= 0]
        assert len(np.unique(ids)) == len(ids)
        # every packed row is interesting and carries its decision
        assert set(ids.tolist()) <= set(interesting.tolist())
        c = code[:, q, :][packed >= 0]
        np.testing.assert_array_equal(c, np.where(upb[q][ids] <= t_lo, 2, 1))
        # each slot holds a row of its own data slice
        for j in range(D):
            own = packed[j][packed[j] >= 0]
            assert ((own >= j * rows_local) & (own < (j + 1) * rows_local)).all()
        per_dev = [int(((interesting >= j * rows_local) & (interesting < (j + 1) * rows_local)).sum())
                   for j in range(D)]
        if max(per_dev) < K:
            assert set(interesting.tolist()) == set(ids.tolist()), q
        else:
            # overflow flagged: the device whose rows do not fit has every slot full
            assert any((packed[j] >= 0).sum() == K for j in range(D) if per_dev[j] >= K)


def test_cases_hold_fitting_and_overflowing_queries(apexes):
    table, queries = apexes
    lwb, _, t_hi, _ = _host(table, queries, T)
    counts = (lwb <= t_hi).sum(1)
    assert (counts < K).any() and (counts >= K).any(), counts


@pytest.mark.parametrize("k", [4, K])
def test_equals_the_reference_filter_on_one_device(apexes, k):
    """The JAX package's filter (one CPU device here) and the port's grid
    of one: the same histogram and (id, code) slots, in the same order."""
    table, queries = apexes
    mesh = jax.make_mesh((1,), ("data",))
    hist, idx, code = (np.asarray(a) for a in rfilter(mesh, max_candidates=k)(
        jnp.asarray(table), jnp.asarray(queries), jnp.float32(T)))
    got = _run(table, queries, T, [CPU], k=k)
    np.testing.assert_array_equal(got[0], hist)
    np.testing.assert_array_equal(got[1], idx)
    np.testing.assert_array_equal(got[2], code)


@pytest.mark.parametrize("n_dev,replicas", [(1, 1), (4, 1), (4, 2)])
@pytest.mark.parametrize("k", [4, K, 700])
def test_topk_and_sort_pack_the_same_slots(apexes, n_dev, replicas, k):
    table, queries = apexes
    a = _run(table, queries, T, [CPU] * n_dev, replicas, k=k)
    b = _run(table, queries, T, [CPU] * n_dev, replicas, k=k, selection="sort")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_overflowing_histogram_is_completed_exactly(apexes):
    """A large threshold overflows 4 slots on every device: the accepted
    column comes from K1 over the device's rows, not from the slots."""
    table, queries = apexes
    t = 0.3
    lwb, upb, t_hi, t_lo = _host(table, queries, t)
    assert _separated(lwb, upb, t_hi, t_lo)
    hist, idx, _ = _run(table, queries, t, [CPU] * 2, k=4)
    assert ((idx >= 0).sum(2) == 4).all()
    np.testing.assert_array_equal(hist[:, 2], (upb <= t_lo).sum(1))
    np.testing.assert_array_equal(hist[:, 1], ((lwb <= t_hi) & (upb > t_lo)).sum(1))


def test_wider_than_the_kernel_takes_k1_and_a_stable_sort(monkeypatch):
    """``max_candidates`` past 4,096 slots (the name is that of the route
    it once took): K3 at that width, as the reference's ``lax.top_k`` has no
    cap, and the same slots and histogram as the reference; the running
    sort (``_sort_select``) is not called."""
    rng = np.random.default_rng(9)
    table = (rng.normal(size=(9000, 6)) * 0.3).astype(np.float32)
    table[:, -1] = np.abs(table[:, -1])
    queries = table[:4].copy()
    t = 1.5
    mesh = jax.make_mesh((1,), ("data",))
    want = [np.asarray(a) for a in rfilter(mesh, max_candidates=5000)(
        jnp.asarray(table), jnp.asarray(queries), jnp.float32(t))]

    def refuse(*a, **k):
        raise AssertionError("the running sort called at selection='topk'")

    widths = []
    k3 = distributed.apex_bounds_threshold
    monkeypatch.setattr(distributed, "_sort_select", refuse)
    monkeypatch.setattr(distributed, "apex_bounds_threshold",
                        lambda *a, **k: (widths.append(a[3]), k3(*a, **k))[1])
    got = _run(table, queries, t, [CPU], k=5000)
    assert widths == [5000]
    assert ((got[1] >= 0).sum(2) > 4096).any()
    np.testing.assert_array_equal(got[0], want[0])
    for q in range(4):
        a = sorted(zip(got[1][0, q].tolist(), got[2][0, q].tolist()))
        b = sorted(zip(want[1][0, q].tolist(), want[2][0, q].tolist()))
        assert a == b


def test_filter_rejects_unsplittable_inputs(apexes):
    table, queries = apexes
    mesh = make_scaleout_mesh(ShardLayout(replicas=2), [CPU] * 4)
    fn = distributed.build_distributed_filter(mesh, max_candidates=8)
    with pytest.raises(ValueError, match="replica"):
        fn(torch.from_numpy(table), torch.from_numpy(queries[:3]), T)
    with pytest.raises(ValueError, match="multiple"):
        fn(torch.from_numpy(table[:2047]), torch.from_numpy(queries), T)
    with pytest.raises(ValueError, match="selection"):
        distributed.build_distributed_filter(mesh, selection="heap")
    with pytest.raises(ValueError, match="data"):
        distributed.build_distributed_filter(mesh, table_axes=("pod", "data"))


def test_placed_table_answers_like_the_table(apexes):
    table, queries = apexes
    mesh = make_scaleout_mesh(ShardLayout(), [CPU] * 4)
    fn = distributed.build_distributed_filter(mesh, max_candidates=K)
    placed = place_rows(mesh, torch.from_numpy(table))
    assert len(placed) == 1 and len(placed[0]) == 4 and placed[0][1].shape == (512, 8)
    for a, b in zip(fn(placed, torch.from_numpy(queries), T), fn(torch.from_numpy(table), torch.from_numpy(queries), T)):
        assert torch.equal(a, b)


# -- the grid ------------------------------------------------------------------
def test_layout_validation_and_round_trip():
    lay = ShardLayout(replicas=2)
    assert ShardLayout.from_dict(lay.to_dict()) == lay
    assert ShardLayout.from_dict(None) == ShardLayout()
    with pytest.raises(ValueError, match="partitioned|replicated"):
        ShardLayout(rows="diagonal")
    with pytest.raises(ValueError, match="replicas"):
        ShardLayout(replicas=0)
    with pytest.raises(ValueError, match="pivot_tables"):
        ShardLayout(pivot_tables="sharded")


def test_grid_shapes_follow_the_reference_rule():
    devs = [CPU] * 4
    m = make_scaleout_mesh(ShardLayout(), devs)
    assert m.axis_names == ("data",) and m.shape == {"data": 4}
    m2 = make_scaleout_mesh(ShardLayout(replicas=2), devs)
    assert m2.axis_names == ("replica", "data") and m2.shape == {"replica": 2, "data": 2}
    # non-divisor replica counts clamp down to a divisor
    assert make_scaleout_mesh(ShardLayout(replicas=3), devs).shape["replica"] == 2
    assert make_scaleout_mesh(ShardLayout(replicas=9), devs).shape["replica"] == 4
    mr = make_scaleout_mesh(ShardLayout(rows="replicated"), devs)
    assert mr.shape == {"replica": 4, "data": 1}
    one = make_scaleout_mesh(ShardLayout(rows="replicated"), [CPU])
    assert one.axis_names == ("data",) and one.shape == {"data": 1}


def test_apex_table_specs():
    table_spec, query_spec = apex_table_specs(make_scaleout_mesh(ShardLayout(replicas=2), [CPU] * 4))
    assert table_spec == ("data", None) and query_spec == ("replica", None)
    assert apex_table_specs(make_scaleout_mesh(ShardLayout(), [CPU] * 4))[1] == (None, None)


def test_default_grid_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default grid is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_scaleout_mesh(ShardLayout())
