"""Device meshes of the model half.

Single pod: (data=16, model=16) = 256 devices; multi-pod: (pod=2, data=16,
model=16) = 512, the ``pod`` axis carrying pure data parallelism.  The
production meshes are abstract (they list the meta device): ``build_cell``
and the sharding rules read only their axis names and sizes.
``make_host_mesh`` builds a small mesh over real devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.sharding.rules import DeviceMesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(axes, shape, (torch.device("meta"),) * n)


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
