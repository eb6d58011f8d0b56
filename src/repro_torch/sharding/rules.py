"""Sharding rules: the model half's parameter, batch and KV-cache specs,
and the scale-out layouts of the sharded apex-table scan.

The JAX package runs its distributed filter as one program over a mesh of
every device (``jax.device_count()``), driven by one Python process.  The
same thing in PyTorch is a grid of ``torch.device``s shaped
``(replica, data)`` in one process: the flattened table's rows split over
``data``, the queries over ``replica``, one kernel launch per device under
``torch.cuda.device(dev)``.  ``make_scaleout_mesh`` builds that grid by the
reference's rule.

The model half names a layout the way the reference does: a
``DeviceMesh`` with axes ``("data", "model")`` or ``("pod", "data",
"model")`` (``repro_torch.launch.mesh``), and per leaf a
``PartitionSpec``, one entry per dimension: ``None``, an axis name or a
tuple of names.  The rules are the reference's baseline "fsdp x tp"
scheme:

  * ``model`` axis: tensor parallelism — attention heads / d_ff / vocab /
    expert dim (when n_experts >= |model|) / embedding-table rows.
  * ``data`` axis (+ ``pod`` when present): batch parallelism for
    activations; FSDP sharding of the *other* big weight dim; optimizer
    moments take the param specs.

Dims with size 1 never get a mesh axis.  The reference stacks a
transformer's layer parameters along a leading (n_layers,) axis that
stays unsharded; the port keeps one tree per layer, so each layer spec is
the reference's without its first entry.

``to_named_shardings`` turns specs into placements.  One process holds a
tensor on one device, so over a ``DeviceMesh`` a placement puts a leaf
whole on its mesh's device when the mesh has one distinct device (a card,
or the CPU listed n times in the tests), and raises
``NotImplementedError`` where it would have to split or replicate a leaf
over several distinct devices.  Over a ``ProcessMesh``
(``repro_torch.launch.mesh.make_process_mesh``: one process per rank under
``torch.distributed``) each rank holds its own slice: ``place`` cuts it
from a whole leaf, ``gather`` rebuilds the leaf (all-gathers over the
split axes, or only over the batch axes: the layout a tensor-parallel
step computes in) and ``reduce_scatter`` averages a gradient over the
batch axes and leaves this rank its shard.  That is the layout the sharded
steps keep at rest (``repro_torch.launch.steps``).  Every all-gather and
reduce-scatter goes through ``staged``, which takes CUDA tensors through
host memory under gloo (several ranks on one card; NCCL takes one card per
rank).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DeviceGrid",
    "DeviceMesh",
    "NamedSharding",
    "PartitionSpec",
    "ProcessMesh",
    "ShardLayout",
    "apex_table_specs",
    "batch_spec",
    "gcn_param_specs",
    "kv_cache_specs",
    "lm_param_specs",
    "make_scaleout_mesh",
    "place_rows",
    "recsys_param_specs",
    "to_named_shardings",
]


@dataclass(frozen=True)
class ShardLayout:
    """Device placement policy for ``ShardedIndex``'s flattened apex scan.

    ``rows``
        ``"partitioned"`` — apex-table rows split over the grid's ``data``
        axis (the default: the table is the big state).  ``"replicated"`` —
        every device holds the full table and the grid degenerates to pure
        replica groups (``data`` axis of size 1), trading memory for query
        throughput on hot shards.
    ``pivot_tables``
        Placement of the tiny query-side state (query apexes, thresholds).
        Always ``"replicated"``; named so manifests stay explicit.
    ``replicas``
        Replica-group count.  With ``rows="partitioned"`` the grid becomes
        ``("replica", "data")`` = (replicas, n_devices // replicas) and the
        query stream is split over the ``replica`` axis; clamped down to the
        nearest divisor of the device count.
    """

    rows: str = "partitioned"
    pivot_tables: str = "replicated"
    replicas: int = 1

    def __post_init__(self):
        if self.rows not in ("partitioned", "replicated"):
            raise ValueError(f"rows must be partitioned|replicated; got {self.rows!r}")
        if self.pivot_tables != "replicated":
            raise ValueError("pivot_tables supports only 'replicated'")
        if int(self.replicas) < 1:
            raise ValueError(f"replicas must be >= 1; got {self.replicas}")

    def to_dict(self) -> dict:
        return {"rows": self.rows, "pivot_tables": self.pivot_tables, "replicas": int(self.replicas)}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ShardLayout":
        d = d or {}
        return cls(
            rows=d.get("rows", "partitioned"),
            pivot_tables=d.get("pivot_tables", "replicated"),
            replicas=int(d.get("replicas", 1)),
        )


@dataclass(frozen=True)
class DeviceGrid:
    """A ``(replica, data)`` grid of devices: ``devices[r][j]`` holds row
    slice ``j`` of the table and serves replica group ``r``'s queries.
    ``axis_names`` is ``("data",)`` for one replica group, as the
    reference's 1-D mesh, else ``("replica", "data")``."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        sizes = {"replica": len(self.devices), "data": len(self.devices[0])}
        return {name: sizes[name] for name in self.axis_names}


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class PartitionSpec(tuple):
    """Per dimension of a leaf: ``None`` (not split), an axis name, or a
    tuple of axis names (split over their product), as
    ``jax.sharding.PartitionSpec``, which also reads an empty tuple as
    ``None`` and a one-name tuple as the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class DeviceMesh:
    """A named grid of devices, row-major: ``devices[i]`` is the device at
    the multi-index ``np.unravel_index(i, sizes)``.  An abstract mesh (the
    production mesh) lists the meta device."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")
        if len(self.devices) != int(np.prod(self.sizes)):
            raise ValueError(f"a {self.sizes} mesh needs {int(np.prod(self.sizes))} devices; got {len(self.devices)}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def distinct_devices(self) -> list:
        return list(dict.fromkeys(self.devices))

    def scaleout_grid(self, row_axes: Sequence[str]) -> DeviceGrid:
        """The search half's ``(replica, data)`` grid over this mesh's
        devices: table rows split over the product of ``row_axes``, one
        replica group per index of the other axes."""
        rows = [a for a in self.axis_names if a in tuple(row_axes)]
        rest = [a for a in self.axis_names if a not in rows]
        grid = np.empty(len(self.devices), dtype=object)
        grid[:] = list(self.devices)
        grid = grid.reshape(self.sizes)
        order = [self.axis_names.index(a) for a in rest + rows]
        n_rows = int(np.prod([self.shape[a] for a in rows]))
        grid = grid.transpose(order).reshape(-1, n_rows)
        return DeviceGrid(tuple(tuple(r) for r in grid), ("data",) if len(grid) == 1 else ("replica", "data"))


@dataclass(frozen=True)
class ProcessMesh(DeviceMesh):
    """A ``DeviceMesh`` of processes: rank ``r`` of the default
    ``torch.distributed`` group sits at the row-major coordinate
    ``np.unravel_index(r, sizes)`` and computes on ``devices[r]``.  This
    process is ``rank``; ``groups`` maps each non-empty set of axes (a tuple
    in mesh order) to the process group of the ranks that share this rank's
    coordinates on every other axis, ordered row-major over the set (group
    rank = the chunk index over those axes).  Built by
    ``repro_torch.launch.mesh.make_process_mesh``."""

    rank: int = 0
    groups: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def coords(self) -> tuple:
        return tuple(int(c) for c in np.unravel_index(self.rank, self.sizes))

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices[self.rank]

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if any(a not in self.axis_names for a in axes):
            raise ValueError(f"axes {axes} are not all in the mesh's {self.axis_names}")
        ordered = tuple(a for a in self.axis_names if a in axes)
        if ordered != axes:
            raise NotImplementedError(f"axes {axes} out of the mesh's order {self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)], dtype=np.int64))

    def axis_index(self, axes) -> int:
        """This rank's chunk index over ``axes``: row-major over their
        coordinates, as ``jax.sharding`` splits a dim over a tuple."""
        axes = self._axes(axes)
        c = dict(zip(self.axis_names, self.coords))
        return int(np.ravel_multi_index([c[a] for a in axes], [self.shape[a] for a in axes])) if axes else 0

    def group(self, axes):
        """The process group of ``axes`` (see the class)."""
        return self.groups[self._axes(axes)]

    @property
    def transport(self) -> str:
        """How this rank's collectives move: the backend, and for gloo with
        CUDA tensors (several ranks on one card) that all-gathers and
        reduce-scatters are staged through host memory."""
        backend = dist.get_backend() if dist.is_initialized() else "none"
        if backend == "gloo" and self.device.type == "cuda":
            return "gloo (all-gather / reduce-scatter staged through host memory)"
        return backend


def process_groups(axis_names: Sequence[str], sizes: Sequence[int], rank: int) -> dict:
    """Every rank's call that builds the groups of ``ProcessMesh.groups``:
    ``torch.distributed.new_group`` is collective, so each rank creates every
    group of every axis set, in the same order, and keeps its own."""
    names = tuple(axis_names)
    grid = np.arange(int(np.prod(sizes))).reshape(tuple(sizes))
    mine = np.unravel_index(rank, tuple(sizes))
    out = {}
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), r):
            rest = [i for i in range(len(names)) if i not in axes]
            moved = np.transpose(grid, rest + list(axes)).reshape(
                [sizes[i] for i in rest] + [int(np.prod([sizes[i] for i in axes]))])
            for other in itertools.product(*[range(sizes[i]) for i in rest]):
                ranks = [int(x) for x in moved[other]]
                g = dist.group.WORLD if len(ranks) == grid.size else dist.new_group(ranks)
                if all(mine[i] == o for i, o in zip(rest, other)):
                    out[tuple(names[i] for i in axes)] = g
    return out


def make_scaleout_mesh(layout: Optional[ShardLayout] = None,
                       devices: Optional[Sequence[torch.device]] = None) -> DeviceGrid:
    """The device grid of the distributed filter under ``layout``.

    ``devices=None`` takes every visible CUDA card (the reference's
    ``jax.device_count()``) and raises without one; the CPU tests pass a list
    such as ``[torch.device("cpu")] * 4``.  ``replicas == 1`` gives the 1-D
    ``("data",)`` grid; otherwise ``("replica", "data")`` splits queries over
    replica groups and rows over ``data`` inside each group, the replica
    count clamped down to a divisor of the device count.  ``rows ==
    "replicated"`` makes every device its own replica group (``data`` of
    size 1).
    """
    layout = layout or ShardLayout()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass devices= to build a grid of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = max(len(devs), 1)
    if layout.rows == "replicated":
        r = n
    else:
        r = min(int(layout.replicas), n)
        while n % r != 0:  # clamp to a divisor so the grid factorises
            r -= 1
    d = n // r
    grid = tuple(tuple(devs[g * d:(g + 1) * d]) for g in range(r))
    return DeviceGrid(grid, ("data",) if r <= 1 else ("replica", "data"))


def apex_table_specs(mesh: DeviceGrid, layout: Optional[ShardLayout] = None):
    """(table_spec, query_spec) of the flattened apex scan, as tuples of axis
    names per dimension: rows over ``data`` (replicated across replica
    groups), queries over ``replica`` when present (replicated across
    ``data``)."""
    rep = "replica" if "replica" in mesh.axis_names else None
    return ("data", None), (rep, None)


def place_rows(mesh: DeviceGrid, rows: torch.Tensor):
    """``rows``'s leading-axis slices on the grid: ``[r][j]`` is slice ``j``
    on device ``(r, j)`` (a view where the rows already lie there), split
    over ``data`` and replicated across replica groups.  The caller pads
    the rows to a multiple of the ``data`` size."""
    D = len(mesh.devices[0])
    if rows.shape[0] % D:
        raise ValueError(f"table rows {rows.shape[0]} must be a multiple of the data axis size {D}")
    per = rows.shape[0] // D
    return tuple(
        tuple(rows[j * per:(j + 1) * per].to(dev) for j, dev in enumerate(group)) for group in mesh.devices
    )


# ---------------------------------------------------------------------------
# the model half: parameter, batch and KV-cache specs
# ---------------------------------------------------------------------------

def _axes(mesh):
    names = mesh.axis_names
    fsdp = "data" if "data" in names else None
    mdl = "model" if "model" in names else None
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return fsdp, mdl, batch_axes


def batch_spec(mesh, extra_dims: int = 1) -> PartitionSpec:
    """Batch-leading arrays: (B, ...) -> P(('pod', 'data'), None, ...)."""
    _, _, batch = _axes(mesh)
    return P(batch, *([None] * extra_dims))


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _replicated(leaf) -> PartitionSpec:
    return P(*([None] * len(leaf.shape)))


def lm_param_specs(params_abstract, mesh, *, n_experts: Optional[int] = None, moe_local: bool = False):
    """Spec tree of a transformer's parameters (a ``Params`` tree, meta
    tensors or real ones).  ``moe_local``: expert weights replicate over
    the data axes when experts cannot shard over ``model`` (the local
    dispatch path); optimizer moments are built without it."""
    from repro_torch.models.params import tree_map_with_path  # repro_torch.models imports this module

    fsdp, mdl, _ = _axes(mesh)
    mdl_size = mesh.shape.get("model", 1)
    experts_on_model = n_experts is not None and n_experts >= mdl_size
    e_fsdp = None if (moe_local and not experts_on_model) else fsdp

    def rule(path, leaf):
        name = _path_str(path)
        if "layers/" in name:
            # one layer's leaf: the reference's spec less its (n_layers,) entry
            if "attn/w" in name:
                if name.endswith("wo"):
                    return P(mdl, fsdp)
                return P(fsdp, mdl)              # wq, wk, wv (D, H*Dh)
            if "attn/b" in name:
                return P(mdl)
            if "ln_" in name:
                return P(None)
            if "moe/w_router" in name:
                return P(fsdp, None)
            if "moe/w_gate" in name or "moe/w_up" in name:   # (E, D, F)
                return P(mdl, e_fsdp, None) if experts_on_model else P(None, e_fsdp, mdl)
            if "moe/w_down" in name:                          # (E, F, D)
                return P(mdl, None, e_fsdp) if experts_on_model else P(None, mdl, e_fsdp)
            if "mlp/w_gate" in name or "mlp/w_up" in name:    # (D, F)
                return P(fsdp, mdl)
            if "mlp/w_down" in name:                          # (F, D)
                return P(mdl, fsdp)
            return _replicated(leaf)
        if name == "embed":
            return P(mdl, None)
        if name == "head":
            return P(None, mdl)
        return _replicated(leaf)

    return tree_map_with_path(rule, params_abstract)


def gcn_param_specs(params_abstract, mesh):
    """GCN weights are tiny (d_hidden 16): replicate everything."""
    from repro_torch.models.params import tree_map  # repro_torch.models imports this module

    return tree_map(_replicated, params_abstract)


def recsys_param_specs(params_abstract, mesh):
    """Embedding tables row-shard over ``model``; interaction weights replicate."""
    from repro_torch.models.params import tree_map_with_path  # repro_torch.models imports this module

    _, mdl, _ = _axes(mesh)

    def rule(path, leaf):
        name = _path_str(path)
        nd = len(leaf.shape)
        if name in ("table", "items") and nd == 2:
            return P(mdl, None)
        if name == "linear" and nd == 1:
            return P(mdl)
        return _replicated(leaf)

    return tree_map_with_path(rule, params_abstract)


def kv_cache_specs(cache_abstract, mesh, *, batch: int):
    """KV caches (the port keeps the reference's stacked (L, B, C, Hk, Dh)
    layout): batch over (pod, data) when divisible; head_dim over model."""
    from repro_torch.models.params import tree_map_with_path  # repro_torch.models imports this module

    _, mdl, batch_axes = _axes(mesh)
    n_batch_shards = 1
    for a in batch_axes:
        n_batch_shards *= mesh.shape[a]
    shard_batch = batch % n_batch_shards == 0 and batch >= n_batch_shards
    mdl_size = mesh.shape.get("model", 1)

    def rule(path, leaf):
        name = _path_str(path)
        if name in ("k", "v"):  # (L, B, C, Hk, Dh)
            dh_axis = mdl if leaf.shape[-1] % mdl_size == 0 else None
            return P(None, batch_axes if shard_batch else None, None, None, dh_axis)
        if name == "pos":       # (L, B, C)
            return P(None, batch_axes if shard_batch else None, None)
        return _replicated(leaf)

    return tree_map_with_path(rule, cache_abstract)


def _split_size(mesh, spec: PartitionSpec) -> int:
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n *= mesh.shape[a]
    return n


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def staged(collective, out: torch.Tensor, src: torch.Tensor, group) -> torch.Tensor:
    """``collective(out, src, group=group)`` (``dist.all_gather_into_tensor``
    or ``dist.reduce_scatter_tensor``, a sum), through host memory where
    gloo takes only CPU tensors: CUDA tensors of several ranks sharing one
    card (``make_process_mesh(backend="gloo", device="cuda")``)."""
    if src.is_cuda and dist.get_backend(group) == "gloo":
        host = torch.empty(out.shape, dtype=out.dtype)
        collective(host, src.cpu(), group=group)
        return out.copy_(host)
    collective(out, src, group=group)
    return out


def gather_dim(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``t`` of ``group`` concatenated along ``dim``, in
    group-rank order (``t`` itself for a group of one)."""
    if size == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((size * src.shape[0],) + tuple(src.shape[1:]))
    return staged(dist.all_gather_into_tensor, out, src, group).movedim(0, dim)


def scatter_dim(t: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of the ``size`` ranks'
    ``t`` of ``group`` (``t`` itself for a group of one)."""
    if size == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // size,) + tuple(src.shape[1:]))
    return staged(dist.reduce_scatter_tensor, out, src, group).movedim(0, dim)


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: ``spec`` over ``mesh``.  Over a ``DeviceMesh``
    ``place(t)`` puts the leaf whole on the mesh's one distinct device; over
    a ``ProcessMesh`` it cuts this rank's shard (each split dim divided into
    equal chunks, one per coordinate over its axes; replicated dims whole),
    ``gather`` rebuilds the leaf from every rank's shard (or only its dims
    split over chosen axes: the layout a tensor-parallel step computes in)
    and ``reduce_scatter`` turns a per-rank gradient into this rank's shard
    of its mean over the batch axes."""

    mesh: DeviceMesh
    spec: PartitionSpec

    def __post_init__(self):
        if isinstance(self.mesh, ProcessMesh):
            return
        distinct = self.mesh.distinct_devices
        if len(distinct) > 1:
            how = "split" if _split_size(self.mesh, self.spec) > 1 else "replicated"
            raise NotImplementedError(
                f"{self.spec} would be {how} over {len(distinct)} distinct devices; one process holds a "
                "tensor on one device: run one process per device on a ProcessMesh "
                "(repro_torch.launch.mesh.make_process_mesh)")

    @property
    def device(self) -> torch.device:
        if isinstance(self.mesh, ProcessMesh):
            return self.mesh.device
        return self.mesh.distinct_devices[0]

    @property
    def replicas(self) -> int:
        """Ranks that hold each element (the mesh's size over the split)."""
        return int(np.prod(self.mesh.sizes)) // _split_size(self.mesh, self.spec)

    def _split(self, t: torch.Tensor, axes=None):
        """(dim, axes) of each split dim of ``t`` (only those split over a
        subset of ``axes`` when given), checked to divide; a dim split over
        axes partly in ``axes`` raises."""
        if len(self.spec) > t.ndim:
            raise ValueError(f"{self.spec} has more entries than a {t.ndim}-d leaf")
        out = []
        for d, entry in enumerate(self.spec):
            own = _entry_axes(entry)
            if not own:
                continue
            if axes is not None and not set(own) <= set(axes):
                if set(own) & set(axes):
                    raise NotImplementedError(f"{self.spec}: dim {d} mixes {tuple(axes)} and other axes")
                continue
            k = self.mesh.axis_size(own)
            if t.shape[d] % k:
                raise ValueError(f"dim {d} of a {tuple(t.shape)} leaf does not split into {k} over {own}")
            out.append((d, own))
        return out

    def _non_local(self, local: Sequence[str]) -> tuple:
        """The mesh's axes less ``local``."""
        return tuple(a for a in self.mesh.axis_names if a not in tuple(local))

    def cut(self, t: torch.Tensor, axes=None) -> torch.Tensor:
        """This rank's chunk of each dim of ``t`` split over ``axes`` (every
        split dim by default), contiguous; ``t`` is whole on those dims."""
        for d, own in self._split(t, axes):
            per = t.shape[d] // self.mesh.axis_size(own)
            t = t.narrow(d, self.mesh.axis_index(own) * per, per)
        return t.contiguous()

    def place(self, t: torch.Tensor) -> torch.Tensor:
        if not isinstance(self.mesh, ProcessMesh):
            return t.to(self.device)
        return self.cut(t.to(self.device))

    def gather(self, shard: torch.Tensor, axes=None) -> torch.Tensor:
        """The leaf from every rank's ``shard``: all-gathers each split dim
        over its axes (a collective of the ranks of those groups).  ``axes``:
        only the dims split over a subset of them (``("data",)``: the FSDP
        dims, leaving the dims split over ``model`` this rank's)."""
        if not isinstance(self.mesh, ProcessMesh):
            return shard
        whole = [(d, own) for d, own in enumerate(map(_entry_axes, self.spec)) if own]
        if axes is not None:
            whole = [(d, own) for d, own in whole if set(own) <= set(axes)]
        for d, own in whole:
            shard = gather_dim(shard, d, self.mesh.group(own), self.mesh.axis_size(own))
        return shard.contiguous()

    def reduce_scatter(self, full: torch.Tensor, mean_over: Sequence[str], local: Sequence[str] = ()) -> torch.Tensor:
        """This rank's shard of the mean over the ranks of ``mean_over``
        (the batch axes) of each rank's ``full`` gradient: dims split over
        other axes are cut locally (their ranks hold the same batch) unless
        those axes are in ``local`` (the gradient is already this rank's
        chunk there: a tensor-parallel step's ``model`` dims), dims split
        over batch axes are reduce-scattered over those axes, the batch axes
        that split no dim are all-reduced."""
        if not isinstance(self.mesh, ProcessMesh):
            return full
        over = tuple(a for a in self.mesh.axis_names if a in tuple(mean_over))
        dims = self._split(full, self._non_local(local))
        t = full
        for d, axes in dims:
            if set(axes) <= set(over):
                continue
            if set(axes) & set(over):
                raise NotImplementedError(f"{self.spec}: dim {d} mixes batch and other axes")
            per = t.shape[d] // self.mesh.axis_size(axes)
            t = t.narrow(d, self.mesh.axis_index(axes) * per, per)
        t = t.contiguous()
        used = []
        for d, axes in dims:
            if set(axes) <= set(over):
                t = scatter_dim(t, d, self.mesh.group(axes), self.mesh.axis_size(axes)).contiguous()
                used.extend(axes)
        rest = tuple(a for a in over if a not in used)
        if rest and self.mesh.axis_size(rest) > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.mesh.group(rest))
        if over:
            t.div_(self.mesh.axis_size(over))
        return t


def to_named_shardings(spec_tree, mesh: DeviceMesh):
    from repro_torch.models.params import tree_map  # repro_torch.models imports this module

    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))

