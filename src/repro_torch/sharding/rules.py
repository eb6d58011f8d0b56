"""Scale-out layouts for the sharded apex-table scan.

The JAX package runs its distributed filter as one program over a mesh of
every device (``jax.device_count()``), driven by one Python process.  The
same thing in PyTorch is a grid of ``torch.device``s shaped
``(replica, data)`` in one process: the flattened table's rows split over
``data``, the queries over ``replica``, one kernel launch per device under
``torch.cuda.device(dev)``.  ``make_scaleout_mesh`` builds that grid by the
reference's rule.  The model parameter rules of the reference's
``sharding/rules.py`` serve the workload models and are not part of this
module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

__all__ = ["DeviceGrid", "ShardLayout", "apex_table_specs", "make_scaleout_mesh", "place_rows"]


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
