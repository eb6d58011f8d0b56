"""Op-level cost walk of an eager step: the counterpart of the JAX
package's ``launch/hlo_walk.py``.

``walk(fn, *args)`` runs ``fn`` once, on the tensors it is given (meta or
fake tensors for a full config: shapes and dtypes, no memory, no kernel),
and counts every ATen op it dispatches:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` — matmuls,
    convolutions and attention at 2·M·N·K (forward and backward);
    elementwise ops count none;
  * HBM bytes: each op's input and output bytes, the convention of the
    reference's ``_op_bytes`` (a top-level op reads its operands and writes
    its outputs).  Eager PyTorch fuses nothing, so every op is top-level.
    Views and other pure aliases move no bytes; an in-place op reads and
    writes its target.  A broadcast (expanded) operand counts its storage,
    a slice of a larger buffer its own elements;
  * peak-live bytes: the largest sum of the op outputs alive at once (the
    arguments not included), from the outputs' lifetimes;
  * collective bytes: every ``torch.distributed`` collective the step runs
    on this rank (a ``c10d`` op), by the reference's kinds (``all-reduce``,
    ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), as the bytes of its result on this rank: the
    convention of the reference's HLO parse, which reads each collective's
    result shape (an all-reduce's buffer, an all-gather's gathered output,
    a reduce-scatter's shard of this rank), with ``"total"`` under the
    ring convention (``roofline.collective_bytes``).  A collective over a
    group of one moves nothing and counts 0.  Collective buffers are kept
    out of the HBM bytes, as the reference's ``hlo_walk`` keeps them, and
    out of ``ops``.

Collectives dispatch as ``c10d`` ops on real tensors as well as on meta
tensors (rank 0 of a fake process group, ``launch.mesh.meta_process_mesh``:
the dry run of a production mesh in one process), so ``CollectiveCounter``
alone counts a live step's collectives, as ``walk`` counts a meta step's.

An eager trace unrolls Python loops, so a loop body is counted once per
trip by construction; the reference's ``WalkResult.loops`` (trip counts
read out of HLO ``while`` ops) has no counterpart, and nothing here parses
HLO.
"""

from __future__ import annotations

import collections
import weakref
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.roofline import collective_bytes

__all__ = ["CollectiveCounter", "WalkResult", "tensor_bytes", "walk"]

#: ops that only re-label a buffer (no alias annotation, yet no traffic)
_FREE = {torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default}

#: ``c10d`` collectives by the reference's kind; each op's first argument
#: holds this rank's result (the buffer reduced in place, or the output)
_C10D = {
    "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "recv_": "collective-permute",
}
#: ``c10d`` ops that produce no result on this rank
_C10D_SILENT = {"barrier", "send"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a kernel reads or writes for ``t``: its elements, or its
    storage when that is smaller (a broadcast view)."""
    own = t.numel() * t.element_size()
    try:
        return min(own, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return own


@dataclass
class WalkResult:
    flops: float = 0.0
    bytes_hbm: float = 0.0
    ops: int = 0
    peak_bytes: float = 0.0
    collective_bytes: dict = field(default_factory=lambda: collective_bytes({}))
    result: Any = field(default=None, repr=False)


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives run under it on this rank: ``per_op`` maps
    each kind to the bytes of its results (see the module), ``bytes`` adds
    the ring ``"total"``.  Any other ``c10d`` op that moves data raises
    rather than go uncounted."""

    def __init__(self):
        super().__init__()
        self.per_op = collections.Counter()

    @property
    def bytes(self) -> dict:
        return collective_bytes(self.per_op)

    def count(self, func, args) -> bool:
        """Adds ``func``'s result bytes when it is a collective; whether it
        is one (``c10d``)."""
        if func.namespace != "c10d":
            return False
        name = func._schema.name.split("::")[-1]
        if name in _C10D_SILENT:
            return True
        if name not in _C10D:
            raise NotImplementedError(f"c10d op {name} is not a counted collective")
        group = next(a for a in args if isinstance(a, torch.ScriptObject))
        if dist.ProcessGroup.unbox(group).size() > 1:
            self.per_op[_C10D[name]] += sum(t.numel() * t.element_size() for t in tree_leaves(args[0])
                                            if isinstance(t, torch.Tensor))
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.count(func, args)
        return out


class _ByteCounter(CollectiveCounter):
    def __init__(self):
        super().__init__()
        self.bytes_hbm = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0

    def _release(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.count(func, args):
            return out      # a collective: no HBM traffic counted, not an op
        self.ops += 1
        returns = func._schema.returns
        aliases = [r.alias_info for r in returns]
        if func in _FREE or (aliases and all(a is not None and not a.is_write for a in aliases)):
            return out      # a view: no traffic, no allocation
        traffic = 0
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                traffic += tensor_bytes(t)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        fresh = all(a is None for a in aliases)
        for t in outs:
            nb = tensor_bytes(t)
            traffic += nb
            if fresh:
                self.live += nb
                weakref.finalize(t, self._release, nb)
        self.peak = max(self.peak, self.live)
        self.bytes_hbm += traffic
        return out


def walk(fn, *args, **kwargs) -> WalkResult:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs, HBM bytes,
    ops, peak-live bytes and collective bytes (see the module docstring)."""
    flops = FlopCounterMode(display=False)
    counter = _ByteCounter()
    with flops, counter:
        result = fn(*args, **kwargs)
    return WalkResult(flops=float(flops.get_total_flops()), bytes_hbm=counter.bytes_hbm, ops=counter.ops,
                      peak_bytes=float(counter.peak), collective_bytes=counter.bytes, result=result)
