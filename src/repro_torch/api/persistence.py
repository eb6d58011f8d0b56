"""Versioned on-disk format of fitted indexes — the JAX package's format.

An index directory holds ``manifest.json`` (format version, kind, metric
config, scalar parameters, array names) and ``arrays.npz`` (data, pivots,
apex table, simplex factors).  Both packages read and write the same
layout, so an index saved by either loads in the other, bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

__all__ = ["ARRAYS_NAME", "FORMAT_VERSION", "MANIFEST_NAME", "read_index_dir", "write_index_dir"]

FORMAT_VERSION = 1

MANIFEST_NAME = "manifest.json"
ARRAYS_NAME = "arrays.npz"


def write_index_dir(path, *, kind: str, params: dict, arrays: Dict[str, np.ndarray]) -> None:
    """Write one index to ``path`` (created if missing, files overwritten)."""
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    manifest = {
        "format_version": FORMAT_VERSION,
        "kind": kind,
        "params": params,
        "arrays": sorted(arrays),
    }
    with open(os.path.join(path, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    np.savez(os.path.join(path, ARRAYS_NAME), **arrays)


def read_index_dir(path) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Read (manifest, arrays) from an index directory, validating version."""
    path = os.fspath(path)
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    version = manifest.get("format_version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"index at {path!r} has format_version {version}; "
            f"this build reads version {FORMAT_VERSION}"
        )
    with np.load(os.path.join(path, ARRAYS_NAME)) as z:
        arrays = {name: z[name] for name in z.files}
    missing = set(manifest.get("arrays", [])) - set(arrays)
    if missing:
        raise ValueError(f"index at {path!r} is missing arrays: {sorted(missing)}")
    return manifest, arrays
