"""``build_index`` / ``load_index`` — the two entry points of ``repro_torch.api``.

    from repro_torch.api import Query, build_index, load_index

    idx = build_index(data, metric="jensen_shannon", n_pivots=20)   # on "cuda"
    res = idx.query(queries, Query.knn(10))
    idx.save("colors.idx")
    idx = load_index("colors.idx")      # identical results, nothing re-measured

Both default to ``device="cuda"`` and raise when no card is present, unless
``device="cpu"`` is passed.  This package builds the ``nsimplex`` kind; the
other kinds and the composites of the JAX package raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.api.indexes import SimplexTableIndex
from repro_torch.api.persistence import read_index_dir
from repro_torch.api.query import QueryOptions
from repro_torch.core import select_pivots
from repro_torch.device import resolve_device
from repro_torch.metrics import Metric, get_metric

__all__ = ["build_index", "load_index"]

_KIND_ALIASES = {"N_seq": "nsimplex", "simplex": "nsimplex"}

#: kinds and options of the JAX package's ``build_index`` that are not
#: ported yet, with the ROADMAP item that ports them
_NOT_PORTED_KINDS = {"laesa": 5, "L_seq": 5, "tree": 5}


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported to repro_torch yet (ROADMAP item {item})")


def build_index(
    data: np.ndarray,
    metric: Union[Metric, str] = "euclidean",
    *,
    kind: str = "nsimplex",
    n_pivots: int = 20,
    pivot_strategy: str = "random",
    seed: int = 0,
    eps: float = 1e-6,
    use_kernel: bool = True,
    mutable: bool = False,
    shards: Optional[int] = None,
    durable: bool = False,
    apex_dims: Optional[int] = None,
    attributes=None,
    query_options: Optional[QueryOptions] = None,
    device="cuda",
) -> SimplexTableIndex:
    """Build an n-simplex index over (data, metric) on ``device``.

    Args:
      data:           (N, dim) corpus (kept on the device in its dtype).
      metric:         a ``Metric`` or a registry name.
      kind:           "nsimplex" (aliases "N_seq", "simplex").
      n_pivots:       reference objects of the apex table.
      pivot_strategy: "random" | "pca" | "maxmin" (see ``select_pivots``);
                      "random" draws the same rows as the JAX package.
      seed:           pivot randomness.
      eps:            relative threshold guard band.
      use_kernel:     persisted for manifest compatibility; the scan always
                      runs through the bound-scan kernels.
      query_options:  per-index ``QueryOptions`` defaults (persisted).
      device:         "cuda" (default) or "cpu".
      mutable, shards, durable, apex_dims, attributes: not ported yet; any
                      non-default value raises ``NotImplementedError``.
    """
    resolved = _KIND_ALIASES.get(kind, kind)
    if resolved in _NOT_PORTED_KINDS:
        raise _not_ported(f"kind={kind!r}", _NOT_PORTED_KINDS[resolved])
    if resolved != "nsimplex":
        raise ValueError(f"unknown index kind {kind!r}; this package builds 'nsimplex'")
    for flag, value, item in (
        ("mutable", mutable, 7),
        ("shards", shards, 7),
        ("durable", durable, 9),
        ("apex_dims", apex_dims, 4),
        ("attributes", attributes, 8),
    ):
        if value is not None and value is not False:
            raise _not_ported(f"build_index({flag}=...)", item)
    dev = resolve_device(device)
    data = np.asarray(data)
    metric = get_metric(metric) if isinstance(metric, str) else metric
    pivots = select_pivots(data, n_pivots, strategy=pivot_strategy, seed=seed, metric=metric)
    index = SimplexTableIndex.build(
        data, metric, pivots=pivots, eps=eps, use_kernel=use_kernel, device=dev
    )
    index.query_options = query_options
    return index


def load_index(path, *, device="cuda") -> SimplexTableIndex:
    """Load an n-simplex index saved by either package onto ``device``;
    nothing is re-measured."""
    dev = resolve_device(device)
    manifest, arrays = read_index_dir(path)
    kind = manifest["kind"]
    if kind != SimplexTableIndex.kind:
        raise NotImplementedError(
            f"index at {path!r} has kind {kind!r}; repro_torch loads 'nsimplex' only "
            "(the other kinds and composites are ROADMAP items 5, 7 and 9)"
        )
    return SimplexTableIndex._load(manifest, arrays, device=dev)
