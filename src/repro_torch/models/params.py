"""Parameter trees as ``nn.Module``s.

The JAX package keeps every model's parameters in nested dicts of arrays
and passes them to plain functions.  The port keeps the same names in a
``Params`` module: each array is an ``nn.Parameter`` (no gradient: this
slice serves, it does not train), each nested dict a child ``Params``, each
per-layer list an ``nn.ModuleList``.  ``params["wq"]`` and ``"mlp" in
params`` read as they do on the reference's dicts, so the port's functions
keep the reference's structure, and ``.to(device)``, ``state_dict()`` and
``parameters()`` work as on any module.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["Params", "generator_for", "normal"]


class Params(nn.Module):
    """A named tree of tensors: tensors become parameters, ``Params`` (or
    any module) children, lists ``nn.ModuleList``s and ``None`` an absent
    entry."""

    def __init__(self, **entries):
        super().__init__()
        for name, value in entries.items():
            if value is None:
                continue
            if isinstance(value, torch.Tensor):
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, nn.Module):
                self.add_module(name, value)
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(value))
            else:
                raise TypeError(f"{name}: expected a tensor, a module or a list; got {type(value).__name__}")

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def normal(generator: torch.Generator, shape, dtype, scale: float, device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in ``dtype`` on the generator's device, then
    placed on ``device``."""
    x = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype) * scale
    return x.to(device)


def generator_for(generator, device: torch.device) -> torch.Generator:
    """``generator``, or a fresh one on ``device`` seeded 0 when it is None."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)
