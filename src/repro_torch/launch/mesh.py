"""Device meshes of the model half.

Single pod: (data=16, model=16) = 256 devices; multi-pod: (pod=2, data=16,
model=16) = 512, the ``pod`` axis carrying pure data parallelism.
``make_production_mesh`` is abstract (it lists the meta device):
``build_cell`` and the sharding rules read only its axis names and sizes.
``production_process_mesh`` makes this process rank 0 (or another rank) of
a production mesh of processes that exist only on paper
(``meta_process_mesh``: a fake process group), on which a cell's real
sharded step runs on meta tensors: the dry run's collective term.
``make_host_mesh`` builds a small mesh over real devices, one process;
``make_process_mesh`` a mesh of processes, one per rank under
``torch.distributed`` (gloo on the CPU, NCCL with one card per rank, or
gloo with several ranks on one card), which the sharded steps run on.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import DeviceMesh, ProcessMesh, process_groups

__all__ = ["make_host_mesh", "make_process_mesh", "make_production_mesh", "meta_process_mesh",
           "production_process_mesh"]


def _production_layout(multi_pod: bool) -> tuple:
    """(axis names, sizes) of the single-pod or multi-pod mesh."""
    return (("pod", "data", "model"), (2, 16, 16)) if multi_pod else (("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    axes, shape = _production_layout(multi_pod)
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(axes, shape, (torch.device("meta"),) * n)


@contextlib.contextmanager
def meta_process_mesh(axis_names: Sequence[str], sizes: Sequence[int], rank: int = 0) -> Iterator[ProcessMesh]:
    """This process as rank ``rank`` of a ``ProcessMesh`` of
    ``prod(sizes)`` ranks on the meta device, the other ranks absent: the
    default process group is a fake one of that world size, whose
    collectives return at once and touch no data, so a sharded step runs
    here on meta tensors, rank ``rank``'s shapes, and every collective it
    calls is dispatched (and counted by ``launch.op_walk``).  The group is
    destroyed on exit, on an error too; a process that already has a
    default group raises.

    The backend is ``torch.testing._internal.distributed.fake_pg``: its
    import registers the ``"fake"`` backend (``FakeProcessGroup``, built
    into ``torch.distributed``) with a store that holds nothing.  Where it
    is missing the import raises, and the caller records the error: no
    path falls back to another mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    world = 1
    for s in sizes:
        world *= s
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not on a {sizes} mesh")
    if dist.is_initialized():
        raise RuntimeError("this process already has a default process group; a meta mesh needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield ProcessMesh(names, sizes, (torch.device("meta"),) * world, rank=rank,
                          groups=process_groups(names, sizes, rank))
    finally:
        dist.destroy_process_group()


def production_process_mesh(*, multi_pod: bool = False, rank: int = 0):
    """``meta_process_mesh`` of the single-pod (16, 16) or multi-pod
    (2, 16, 16) mesh, with the reference's axis names: a context manager."""
    return meta_process_mesh(*_production_layout(multi_pod), rank=rank)


def make_host_mesh(data: int = 1, model: int = 1, devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (data, model) mesh over the first ``data * model`` of ``devices``
    (every visible CUDA card by default; raises without one).  The CPU
    tests pass ``[torch.device("cpu")] * n``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass devices= (for example "
                               "[torch.device('cpu')] * n) to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if len(devs) < data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices; {len(devs)} given")
    return DeviceMesh(("data", "model"), (data, model), tuple(devs[:data * model]))


def make_process_mesh(data: int = 1, model: int = 1, backend: Optional[str] = None,
                      device: Optional[str] = None) -> ProcessMesh:
    """This process's place on a ``(data, model)`` mesh of processes.

    Reads the torchrun-style environment: ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` (default ``localhost``), ``MASTER_PORT`` and, for a card
    per rank, ``LOCAL_RANK`` (default ``RANK``).  ``backend``: ``"gloo"``
    runs every rank on the CPU, ``"nccl"`` on card ``LOCAL_RANK`` (made the
    current device; NCCL refuses two ranks on one card); the default is
    NCCL when a card is visible.  ``backend="gloo", device="cuda"`` puts
    several ranks on the visible cards (rank ``LOCAL_RANK`` on card
    ``LOCAL_RANK`` modulo their count): every rank computes on its card, and
    the all-gathers and reduce-scatters that gloo takes only for CPU
    tensors are staged through host memory (``sharding.rules.staged``;
    ``ProcessMesh.transport`` names the route).  Joins the default process
    group (``tcp://MASTER_ADDR:MASTER_PORT``) unless this process already
    has one, checks ``WORLD_SIZE == data * model``, and builds every axis
    group (a collective: every rank calls this once, in the same order as
    its other collectives)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks; WORLD_SIZE is {world}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    local = int(os.environ.get("LOCAL_RANK", rank))
    if backend == "nccl":
        if device not in (None, "cuda"):
            raise ValueError(f"nccl runs on the cards; got device={device!r}")
        if world > torch.cuda.device_count():
            raise ValueError(f"nccl takes one card per rank: {world} ranks, {torch.cuda.device_count()} cards; "
                             "pass backend='gloo', device='cuda' for several ranks on one card")
        torch.cuda.set_device(local)
        mine = torch.device("cuda", local)
        devices = tuple(torch.device("cuda", r) for r in range(world))
    elif backend == "gloo" and device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' needs a card; no CUDA device is visible")
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local % cards)
        mine = torch.device("cuda", local % cards)
        devices = tuple(torch.device("cuda", r % cards) for r in range(world))
    elif backend == "gloo" and device in (None, "cpu"):
        mine = torch.device("cpu")
        devices = (mine,) * world
    else:
        raise ValueError(f"backend must be gloo or nccl, device cpu or cuda; got {backend!r}, {device!r}")
    if not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{os.environ['MASTER_PORT']}",
                                world_size=world, rank=rank)
    names, sizes = ("data", "model"), (data, model)
    devices = devices[:rank] + (mine,) + devices[rank + 1:]
    return ProcessMesh(names, sizes, devices, rank=rank, groups=process_groups(names, sizes, rank))
