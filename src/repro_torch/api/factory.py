"""``build_index`` / ``load_index`` — the two entry points of ``repro_torch.api``.

    from repro_torch.api import Query, build_index, load_index

    idx = build_index(data, metric="jensen_shannon", n_pivots=20)   # on "cuda"
    res = idx.query(queries, Query.knn(10))
    idx.save("colors.idx")
    idx = load_index("colors.idx")      # identical results, nothing re-measured

    # approximate by default: queries measure 10 pivot distances and
    # re-rank the 64 best truncated-surrogate candidates with the metric
    approx = build_index(data, "jensen_shannon", n_pivots=20, apex_dims=10, refine=64)

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
from repro_torch.api.query import DEFAULT_REFINE, QueryOptions
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
    refine: int = DEFAULT_REFINE,
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
      apex_dims:      truncate the per-query surrogate to this many of the
                      ``n_pivots`` dimensions and default every query to the
                      approximate path; results carry ``QueryResult.approx``
                      and ``QueryStats.bound_width``.  None = exact.
      refine:         true-metric re-rank budget of approximate queries
                      (overridable per query with ``Query(refine=...)``).
      query_options:  per-index ``QueryOptions`` defaults (persisted).
      device:         "cuda" (default) or "cpu".
      mutable, shards, durable, attributes: not ported yet; any non-default
                      value raises ``NotImplementedError``.
    """
    resolved = _KIND_ALIASES.get(kind, kind)
    if resolved not in _NOT_PORTED_KINDS and resolved != "nsimplex":
        raise ValueError(f"unknown index kind {kind!r}; this package builds 'nsimplex'")
    approx = None
    if apex_dims is not None:
        if resolved not in ("nsimplex", "laesa", "L_seq"):
            raise ValueError(
                f"apex_dims applies to the table kinds (nsimplex/laesa); "
                f"kind={resolved!r} has no truncatable surrogate"
            )
        if not (2 <= int(apex_dims) <= int(n_pivots)):
            raise ValueError(f"apex_dims must be in [2, n_pivots={n_pivots}]; got {apex_dims}")
        approx = {"dims": int(apex_dims), "refine": int(refine)}
    if resolved in _NOT_PORTED_KINDS:
        raise _not_ported(f"kind={kind!r}", _NOT_PORTED_KINDS[resolved])
    for flag, value, item in (
        ("mutable", mutable, 7),
        ("shards", shards, 7),
        ("durable", durable, 9),
        ("attributes", attributes, 8),
    ):
        if value is not None and value is not False:
            raise _not_ported(f"build_index({flag}=...)", item)
    dev = resolve_device(device)
    data = np.asarray(data)
    metric = get_metric(metric) if isinstance(metric, str) else metric
    pivots = select_pivots(data, n_pivots, strategy=pivot_strategy, seed=seed, metric=metric)
    index = SimplexTableIndex.build(
        data, metric, pivots=pivots, eps=eps, use_kernel=use_kernel, approx=approx, device=dev
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
