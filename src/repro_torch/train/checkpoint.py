"""Checkpoints with atomic commits, keep-k garbage collection and
corruption-tolerant restore, in the JAX package's on-disk layout:

    <dir>/step_<N>/              (N zero-padded to 10 digits)
        manifest.json            (step, leaf names, files, shapes, dtypes)
        <leaf>.npy               (one file per tree leaf, on the host)
        _COMMITTED               (written last; restores ignore dirs
                                  without it — atomicity marker)

A step is written into ``step_<N>.tmp`` and renamed when complete.  Leaf
names are the tree paths joined with ``##`` as the reference's
``jax.tree_util.tree_flatten_with_path`` gives them for the same
structure: dict keys in sorted order, sequence indices as integers, and a
``Params`` tree by its module names (``layers##0##attn##wq``).  So a dict
tree of f32 and int32 leaves written by either package restores in the
other.

bfloat16 leaves are written as their 2-byte patterns (numpy dtype ``V2``,
as the reference's ``np.save`` of an ``ml_dtypes`` array gives) with
manifest dtype ``"bfloat16"``, and read back through ``np.int16`` and
``Tensor.view(torch.bfloat16)``: no ``ml_dtypes`` is needed, and a bf16
checkpoint written by the reference restores here bit for bit.

``restore`` places each leaf on the template leaf's device, or as
``sharding_tree`` says: a tree like the template of ``torch.device``s or
of placements from ``repro_torch.sharding.to_named_shardings``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_flatten, tree_unflatten

__all__ = ["CheckpointManager"]

_SEP = "##"


def _flatten_with_names(tree):
    paths, leaves = tree_flatten(tree)
    return [_SEP.join(str(k) for k in path) for path in paths], leaves


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf needs 2-byte items; got {arr.dtype}")
        return torch.from_numpy(np.array(arr, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr.astype(dtype), order="C"))


def _place(t: torch.Tensor, leaf, shd) -> torch.Tensor:
    if shd is not None:
        return shd.place(t) if hasattr(shd, "place") else t.to(torch.device(shd))
    return t.to(leaf.device) if isinstance(leaf, torch.Tensor) else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        names, leaves = _flatten_with_names(tree)
        manifest = {"step": step, "leaves": [], "extra": extra or {}, "time": time.time()}
        for name, leaf in zip(names, leaves):
            arr = _host_array(leaf)
            fn = name.replace("/", "_") + ".npy"
            np.save(os.path.join(tmp, fn), arr)
            manifest["leaves"].append(
                {"name": name, "file": fn, "shape": list(arr.shape), "dtype": _dtype_name(leaf, arr)}
            )
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # -- inspect ----------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in sorted(os.listdir(self.directory)):
            if not d.startswith("step_") or d.endswith(".tmp"):
                continue
            if not os.path.exists(os.path.join(self.directory, d, "_COMMITTED")):
                continue
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore ----------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None, sharding_tree: Any = None):
        """Restore into the structure of ``template``; returns (tree, step).

        ``sharding_tree``: optional tree like ``template`` of placements
        (``torch.device``s, or ``to_named_shardings``'s); without it each
        leaf goes to its template leaf's device.  Corrupt or uncommitted
        directories are skipped (newest valid wins).
        """
        steps = self.all_steps()
        if step is not None:
            if step not in steps:
                raise FileNotFoundError(f"no committed checkpoint for step {step}")
            candidates = [step]
        else:
            candidates = list(reversed(steps))
        last_err = None
        for s in candidates:
            try:
                return self._restore_one(template, s, sharding_tree), s
            except Exception as e:  # corrupt -> try older
                last_err = e
                continue
        raise FileNotFoundError(f"no restorable checkpoint in {self.directory}: {last_err}")

    def _restore_one(self, template, step, sharding_tree):
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {l["name"]: l for l in manifest["leaves"]}
        names, leaves = _flatten_with_names(template)
        if sharding_tree is not None:
            shardings = tree_flatten(sharding_tree, is_leaf=lambda x: hasattr(x, "place"))[1]
        else:
            shardings = [None] * len(leaves)
        out = []
        for name, leaf, shd in zip(names, leaves, shardings):
            entry = by_name[name]
            arr = np.load(os.path.join(d, entry["file"]))
            want_shape = tuple(leaf.shape)
            if tuple(arr.shape) != want_shape:
                raise ValueError(f"{name}: shape {arr.shape} != {want_shape}")
            out.append(_place(_from_host(arr, entry["dtype"]), leaf, shd))
        return tree_unflatten(template, out)
