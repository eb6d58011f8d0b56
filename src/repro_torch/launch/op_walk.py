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
    arguments not included), from the outputs' lifetimes.

An eager trace unrolls Python loops, so a loop body is counted once per
trip by construction; the reference's ``WalkResult.loops`` (trip counts
read out of HLO ``while`` ops) has no counterpart.  Nothing here parses
HLO, and no collective is counted (a single-device step has none).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["WalkResult", "tensor_bytes", "walk"]

#: ops that only re-label a buffer (no alias annotation, yet no traffic)
_FREE = {torch.ops.aten._unsafe_view.default, torch.ops.aten.lift_fresh.default}


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
    result: Any = field(default=None, repr=False)


class _ByteCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0

    def _release(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
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
        self.bytes += traffic
        return out


def walk(fn, *args, **kwargs) -> WalkResult:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs, HBM bytes,
    ops and peak-live bytes (see the module docstring)."""
    flops = FlopCounterMode(display=False)
    counter = _ByteCounter()
    with flops, counter:
        result = fn(*args, **kwargs)
    return WalkResult(flops=float(flops.get_total_flops()), bytes_hbm=counter.bytes, ops=counter.ops,
                      peak_bytes=float(counter.peak), result=result)
