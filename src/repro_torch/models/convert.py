"""The parameter bridge: the JAX package's parameter pytrees into the
port's ``Params`` modules.

A test holds the port against the reference by converting the reference's
own initial parameters (``jax.tree.map(np.asarray, params)``, nested dicts
of numpy arrays, bfloat16 ones as ``ml_dtypes`` arrays) for any config of
the three families.  The reference stacks a transformer's layer
parameters along a leading (n_layers, ...) axis; the bridge splits that
axis into one ``Params`` per layer.  Every other tree maps name for name.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import Params
from repro_torch.models.transformer import TransformerConfig

__all__ = ["from_reference", "to_tensor"]


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
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
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
