"""The parameter bridge: the JAX package's parameter pytrees into the
port's ``Params`` modules, and back.

A test holds the port against the reference by converting the reference's
own initial parameters (``jax.tree.map(np.asarray, params)``, nested dicts
of numpy arrays, bfloat16 ones as ``ml_dtypes`` arrays) for any config of
the three families.  The reference stacks a transformer's layer
parameters along a leading (n_layers, ...) axis; the bridge splits that
axis into one ``Params`` per layer.  Every other tree maps name for name.

``to_reference`` is the inverse: a port tree (parameters, a gradient tree,
an optimizer moment tree) as the reference's nested dicts of numpy arrays,
the layers re-stacked along a leading axis, so that gradients and
optimizer states compare leaf by leaf with the reference's.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.models.params import Params, model_device
from repro_torch.models.transformer import TransformerConfig

__all__ = ["from_reference", "to_array", "to_reference", "to_tensor"]


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """One array on ``device``, dtype kept (bfloat16 through its bits).
    The array is read in place (no host copy), so a broadcast view of a
    full-size shape costs nothing on the meta device."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # read-only arrays are copied below
        t = torch.from_numpy(a.view(np.uint16) if bf16 else a)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device=device, copy=True)


def _tree(node, device):
    if isinstance(node, dict):
        return Params(**{k: _tree(v, device) for k, v in node.items()})
    return to_tensor(node, device)


def from_reference(cfg, tree: dict, device="cuda") -> Params:
    """The port's parameters for ``cfg`` (a ``TransformerConfig``,
    ``RecsysConfig`` or ``GCNConfig``, full size or smoke; any other value,
    None included, maps a sub-tree such as one layer's attention name for
    name) from the reference's parameter tree of numpy arrays, on
    ``device`` (the card by default; ``"meta"`` checks shapes without
    memory)."""
    dev = model_device(device)
    if not isinstance(cfg, TransformerConfig):
        return _tree(tree, dev)
    stacked = tree["layers"]
    layers = [_tree(_take_layer(stacked, li), dev) for li in range(cfg.n_layers)]
    rest = {k: _tree(v, dev) for k, v in tree.items() if k != "layers"}
    return Params(layers=layers, **rest)


def _take_layer(node, li: int):
    if isinstance(node, dict):
        return {k: _take_layer(v, li) for k, v in node.items()}
    if node.shape[0] <= li:
        raise ValueError(f"stacked layer axis has {node.shape[0]} entries; need layer {li}")
    return node[li]


def to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor as a host numpy array, dtype kept: bfloat16 through its
    bits, as an ``ml_dtypes.bfloat16`` array where that package is
    importable (it comes with jax) and as the raw ``uint16`` bits
    otherwise."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy().view(np.uint16)
    try:
        import ml_dtypes
    except ImportError:
        return bits
    return bits.view(ml_dtypes.bfloat16)


def _numpy_tree(node):
    if isinstance(node, (Params, dict)):
        names = node.keys() if isinstance(node, dict) else list(node._parameters) + list(node._modules)
        return {k: _numpy_tree(node[k]) for k in names}
    return to_array(node)


def to_reference(cfg, tree) -> dict:
    """The reference's numpy pytree for the port's ``tree`` (a ``Params``
    of parameters, gradients or moments for ``cfg``): a transformer's
    per-layer trees stacked along a leading (n_layers, ...) axis, every
    other tree name for name."""
    if not isinstance(cfg, TransformerConfig):
        return _numpy_tree(tree)
    layers = [_numpy_tree(layer) for layer in tree["layers"]]
    out = {k: _numpy_tree(tree[k]) for k in list(tree._parameters) + list(tree._modules) if k != "layers"}
    out["layers"] = _stack(layers)
    return out


def _stack(nodes: list):
    if isinstance(nodes[0], dict):
        return {k: _stack([n[k] for n in nodes]) for k in nodes[0]}
    return np.stack(nodes)

