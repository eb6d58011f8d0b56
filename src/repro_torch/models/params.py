"""Parameter trees as ``nn.Module``s, and the tree functions over them.

The JAX package keeps every model's parameters in nested dicts of arrays
and passes them to plain functions.  The port keeps the same names in a
``Params`` module: each array is an ``nn.Parameter``, each nested dict a
child ``Params``, each per-layer list an ``nn.ModuleList``.
``params["wq"]`` and ``"mlp" in params`` read as they do on the
reference's dicts, so the port's functions keep the reference's structure,
and ``.to(device)``, ``state_dict()`` and ``parameters()`` work as on any
module.

Parameters are registered with ``requires_grad=False``: the serving
forwards build no autograd graph.  The train path turns gradients on for
its own tree: ``value_and_grad`` does so for the tree it differentiates
(``params.requires_grad_(True)`` on a ``Params`` does the same).

``tree_flatten`` / ``tree_map`` / ``tree_unflatten`` walk a tree of
``Params``, dicts, lists and tuples as ``jax.tree_util`` walks the
reference's pytrees: dict keys and ``Params`` names in sorted order,
sequence entries by index, ``None`` an empty subtree.  A path is the tuple
of those keys, so ``Params`` trees flatten by their module names
(``("layers", 0, "attn", "wq")``).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device

__all__ = [
    "Params",
    "generator_for",
    "model_device",
    "normal",
    "tree_flatten",
    "tree_leaves",
    "tree_map",
    "tree_map_with_path",
    "tree_unflatten",
    "value_and_grad",
]


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


def model_device(device) -> torch.device:
    """The device a model initialiser builds on: ``"meta"`` (shapes and
    dtypes without memory, the counterpart of ``jax.eval_shape``) or what
    ``resolve_device`` gives (the card by default)."""
    return torch.device("meta") if str(device) == "meta" else resolve_device(device)


def normal(generator: Optional[torch.Generator], shape, dtype, scale: float, device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in ``dtype`` on the generator's device, then
    placed on ``device`` (an empty tensor on the meta device)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    x = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype) * scale
    return x.to(device)


def generator_for(generator, device: torch.device) -> Optional[torch.Generator]:
    """``generator``, or a fresh one on ``device`` seeded 0 when it is None
    (None on the meta device, which draws nothing)."""
    if generator is not None or device.type == "meta":
        return generator
    return torch.Generator(device=device).manual_seed(0)


# ---------------------------------------------------------------------------
# tree functions
# ---------------------------------------------------------------------------

def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) pairs of a container node in the reference's flattening
    order, or None for a leaf."""
    if isinstance(node, nn.ModuleList):
        return [(i, m) for i, m in enumerate(node)]
    if isinstance(node, nn.Module):
        names = sorted(list(node._parameters) + list(node._modules))
        return [(k, getattr(node, k)) for k in names]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _is_tensor_tree(v) -> bool:
    if v is None or isinstance(v, (torch.Tensor, nn.Module)):
        return True
    return isinstance(v, list) and all(isinstance(m, nn.Module) for m in v)


def _rebuild(node, values: dict):
    """A node of ``node``'s kind holding ``values`` (key -> rebuilt child).
    A ``Params`` whose new children are not all tensors and modules (a spec
    tree, say) becomes a dict; a ``ModuleList`` a list."""
    if isinstance(node, nn.ModuleList):
        return [values[i] for i in range(len(node))]
    if isinstance(node, nn.Module):
        return Params(**values) if all(_is_tensor_tree(v) for v in values.values()) else values
    if isinstance(node, dict):
        return dict(values)
    seq = [values[i] for i in range(len(node))]
    return tuple(seq) if isinstance(node, tuple) else seq


def _kids(node, is_leaf):
    return None if (is_leaf is not None and is_leaf(node)) else _children(node)


# The walks are module-level functions: a nested function that calls itself
# is a reference cycle, which would keep every leaf it reaches (gradients,
# activations) alive until Python's cyclic collector happens to run.
def _flatten(node, path, is_leaf, paths, leaves):
    if node is None:
        return
    kids = _kids(node, is_leaf)
    if kids is None:
        paths.append(path)
        leaves.append(node)
        return
    for k, child in kids:
        _flatten(child, path + (k,), is_leaf, paths, leaves)


def _map(fn, node, others, path, is_leaf):
    if node is None:
        return None
    kids = _kids(node, is_leaf)
    if kids is None:
        return fn(path, node, *others)
    other_kids = [dict(_children(o)) for o in others]
    return _rebuild(node, {k: _map(fn, child, [ok[k] for ok in other_kids], path + (k,), is_leaf)
                           for k, child in kids})


def tree_flatten(tree, is_leaf: Optional[Callable[[Any], bool]] = None):
    """(paths, leaves) of ``tree``; ``is_leaf`` stops the walk at nodes it
    accepts (a ``PartitionSpec`` is a tuple)."""
    paths, leaves = [], []
    _flatten(tree, (), is_leaf, paths, leaves)
    return paths, leaves


def tree_leaves(tree, is_leaf=None) -> list:
    return tree_flatten(tree, is_leaf)[1]


def tree_map_with_path(fn: Callable, tree, *rest, is_leaf=None):
    """``fn(path, leaf, *other_leaves)`` over ``tree``'s leaves, rebuilt in
    ``tree``'s structure; ``rest`` are trees of the same structure."""
    return _map(fn, tree, list(rest), (), is_leaf)


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn(leaf, *other_leaves)`` over the leaves, in ``tree``'s structure."""
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest, is_leaf=is_leaf)


def tree_unflatten(template, leaves: list):
    """``template``'s structure holding ``leaves`` in flattening order.  A
    tensor leaf that replaces a template tensor keeps that tensor's
    ``requires_grad``."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    for old, new in zip(tree_leaves(template), tree_leaves(out)):
        if isinstance(old, torch.Tensor) and old.requires_grad and new.is_leaf:
            new.requires_grad_(True)
    return out


# ---------------------------------------------------------------------------
# gradients (the train path)
# ---------------------------------------------------------------------------

def _trainable(params):
    """``params`` with gradients on for each floating-point leaf (in place;
    the serving forwards never call this)."""
    for leaf in tree_leaves(params):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() and not leaf.requires_grad:
            leaf.requires_grad_(True)
    return params


def value_and_grad(fn: Callable, params, *, has_aux: bool = False):
    """``jax.value_and_grad`` on a tree: ``(fn(params), grads)`` with
    ``grads`` a tree like ``params`` holding d value / d leaf (zeros where
    the value does not depend on a leaf).  Gradients are turned on for the
    tree's floating-point leaves first, in place; ``has_aux``: ``fn``
    returns ``(value, aux)``, the result is ``((value, aux), grads)``.  The
    returned value and aux are detached."""
    leaves = tree_leaves(_trainable(params))
    want = [l for l in leaves if l.requires_grad]
    with torch.enable_grad():
        out = fn(params)
        value = out[0] if has_aux else out
        got = dict(zip(map(id, want), torch.autograd.grad(value, want, allow_unused=True)))
    grads = iter([torch.zeros_like(l) if got.get(id(l)) is None else got[id(l)] for l in leaves])
    grad_tree = tree_map(lambda _: next(grads), params)
    if has_aux:
        aux = tree_map(lambda a: a.detach() if isinstance(a, torch.Tensor) else a, out[1])
        return (value.detach(), aux), grad_tree
    return value.detach(), grad_tree
