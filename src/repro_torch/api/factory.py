"""``build_index`` / ``load_index`` — the two entry points of ``repro_torch.api``.

    from repro_torch.api import Query, build_index, load_index

    idx = build_index(data, metric="jensen_shannon", n_pivots=20)   # on "cuda"
    res = idx.query(queries, Query.knn(10))
    idx.save("colors.idx")
    idx = load_index("colors.idx")      # identical results, nothing re-measured

    # approximate by default: queries measure 10 pivot distances and
    # re-rank the 64 best truncated-surrogate candidates with the metric
    approx = build_index(data, "jensen_shannon", n_pivots=20, apex_dims=10, refine=64)

    laesa = build_index(data, "jensen_shannon", kind="laesa", n_pivots=20)
    tree = build_index(data, "jensen_shannon", kind="tree", leaf_size=32)

    # filtered and online: an attribute store and the mutable composite
    store = AttributeStore({"shop": "categorical", "year": "int"})
    store.put(np.arange(len(data)), {"shop": shops, "year": years})
    live = build_index(data, "euclidean", attributes=store, mutable=True)
    live.add(rows, attrs={"shop": new_shops, "year": new_years})
    live.query(queries, Query.knn(10, where=Predicate.eq("shop", "s1")))

    # a corpus served as four segments sharing one pivot set, online or not
    sharded = build_index(data, "euclidean", shards=4)
    online = build_index(data, "euclidean", shards=4, mutable=True)

    # crash-safe: WAL-first mutations, checkpoints, recovery (open_durable)
    durable = build_index(data, "euclidean", durable=True, wal_dir="t/wal")

Both default to ``device="cuda"`` and raise when no card is present, unless
``device="cpu"`` is passed.  This package builds the three single-structure
kinds (``nsimplex``, ``laesa``, ``tree``), the mutable, sharded and durable
composites over them and attribute stores.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np

from repro_torch.api.indexes import MetricTreeIndex, PivotTableIndex, SimplexTableIndex
from repro_torch.api.mutable import MutableIndex
from repro_torch.api.persistence import read_index_dir
from repro_torch.api.query import DEFAULT_REFINE, QueryOptions
from repro_torch.api.sharded import ShardedIndex, _shared_projector
from repro_torch.core import select_pivots
from repro_torch.device import resolve_device
from repro_torch.filter.store import AttributeStore
from repro_torch.metrics import Metric, get_metric

__all__ = ["COMPOSITE_KINDS", "INDEX_KINDS", "build_index", "load_index"]

#: kind -> implementation; also the manifest dispatch table of load_index
INDEX_KINDS = {
    SimplexTableIndex.kind: SimplexTableIndex,
    PivotTableIndex.kind: PivotTableIndex,
    MetricTreeIndex.kind: MetricTreeIndex,
}

#: engine-mechanism spellings accepted as aliases
_KIND_ALIASES = {"N_seq": "nsimplex", "L_seq": "laesa", "simplex": "nsimplex"}

#: composite kinds (selected with build_index flags, not ``kind=``); the
#: durable kind registers itself lazily: ``repro_torch.store`` imports this
#: package, so a top-level import here would be circular
COMPOSITE_KINDS = {MutableIndex.kind: MutableIndex, ShardedIndex.kind: ShardedIndex}


def _durable_cls():
    from repro_torch.store.durable import DurableIndex

    COMPOSITE_KINDS.setdefault(DurableIndex.kind, DurableIndex)
    return DurableIndex


def _resolve_kind(kind: str) -> str:
    resolved = _KIND_ALIASES.get(kind, kind)
    if resolved not in INDEX_KINDS:
        raise ValueError(
            f"unknown index kind {kind!r}; known kinds: {sorted(INDEX_KINDS)} "
            f"(aliases: {sorted(_KIND_ALIASES)})"
        )
    return resolved


def _build_segment(data, metric: Metric, kind: str, *, pivots, leaf_size: int, seed: int, eps: float,
                   use_kernel: bool, approx: Optional[dict], device):
    if kind == "nsimplex":
        return SimplexTableIndex.build(
            data, metric, pivots=pivots, eps=eps, use_kernel=use_kernel, approx=approx, device=device
        )
    if kind == "laesa":
        return PivotTableIndex.build(data, metric, pivots=pivots, approx=approx, device=device)
    return MetricTreeIndex.build(data, metric, leaf_size=leaf_size, seed=seed, device=device)


def build_index(
    data: np.ndarray,
    metric: Union[Metric, str] = "euclidean",
    *,
    kind: str = "nsimplex",
    n_pivots: int = 20,
    pivot_strategy: str = "random",
    leaf_size: int = 32,
    seed: int = 0,
    eps: float = 1e-6,
    use_kernel: bool = True,
    mutable: bool = False,
    shards: Optional[int] = None,
    compact_threshold: Optional[float] = 0.5,
    durable: bool = False,
    wal_dir: Optional[str] = None,
    fsync_every: int = 8,
    drift_threshold: Optional[float] = None,
    checkpoint_every: Optional[int] = 4096,
    device_filter: Optional[bool] = None,
    max_candidates: int = 256,
    fanout_workers: Optional[int] = None,
    layout: Optional[dict] = None,
    apex_dims: Optional[int] = None,
    refine: int = DEFAULT_REFINE,
    attributes=None,
    query_options: Optional[QueryOptions] = None,
    device="cuda",
) -> Union[SimplexTableIndex, PivotTableIndex, MetricTreeIndex, MutableIndex, ShardedIndex, "DurableIndex"]:
    """Build one index of the requested kind over (data, metric) on ``device``.

    Args:
      data:           (N, dim) corpus (kept on the device in its dtype).
      metric:         a ``Metric`` or a registry name.
      kind:           "nsimplex" (apex table, the paper's mechanism; aliases
                      "N_seq", "simplex"), "laesa" (pivot-distance baseline;
                      alias "L_seq") or "tree" (hyperplane tree with Hilbert
                      exclusion).
      n_pivots:       reference objects of the table kinds.
      pivot_strategy: "random" | "pca" | "maxmin" (see ``select_pivots``);
                      "random" draws the same rows as the JAX package.
      leaf_size:      tree leaf capacity (tree kind only).
      seed:           pivot / tree randomness.
      eps:            relative threshold guard band (nsimplex kind).
      use_kernel:     persisted for manifest compatibility; the n-simplex
                      scan always runs through the bound-scan kernels.
      apex_dims:      table kinds only: truncate the per-query surrogate to
                      this many of the ``n_pivots`` dimensions and default
                      every query to the approximate path; results carry
                      ``QueryResult.approx`` and ``QueryStats.bound_width``.
                      None = exact.
      refine:         true-metric re-rank budget of approximate queries
                      (overridable per query with ``Query(refine=...)``).
      mutable:        wrap the segment in ``MutableIndex``: online add /
                      remove / upsert / compact with exact queries.
      compact_threshold: delta + tombstone fraction that marks a mutable
                      index ``pending_compaction``; the fold runs on an
                      explicit ``compact()`` (None: never marked).
      shards:         partition rows across this many segments
                      (``ShardedIndex``); shard 0 fits the shared pivot set
                      and the others reuse it, so the sharded simplex filter
                      can scan every shard's table as one.
      device_filter:  sharded nsimplex only: route exact range batches
                      through the distributed filter (K3 per device; None =
                      auto, False = host fan-out).
      max_candidates: per-device candidate slots of the distributed filter.
      fanout_workers: sharded only: host fan-out policy; None uses the
                      shared process pool with the overlapped top-k merge
                      and radius hints, 0 the sequential scan, an int > 0 a
                      private pool of that size.
      layout:         sharded only: the distributed filter's device
                      placement as a ``ShardLayout`` dict (``rows``:
                      partitioned|replicated, ``replicas``: replica groups);
                      None = rows partitioned over every visible card.
      attributes:     a ``repro_torch.filter.AttributeStore`` to attach,
                      enabling ``Query(where=Predicate...)``; persisted next
                      to the index by ``save`` and reattached by
                      ``load_index``.
      durable:        wrap the (implied) ``MutableIndex`` in a
                      ``repro_torch.store.DurableIndex``: every mutation is
                      write-ahead logged under ``wal_dir`` before it is
                      applied, checkpoints publish crash-consistent
                      snapshots, and recovery (``repro_torch.store.open_durable``)
                      replays the tail to the exact pre-crash state.  The
                      log and checkpoints are the JAX package's format.
      wal_dir:        directory of the WAL + checkpoints (required, and only
                      legal, with ``durable=True``); must not already hold a
                      durable store (reopen those with ``open_durable``).
      fsync_every:    batch size of the WAL's group fsync (durable only).
      drift_threshold: Jensen-Shannon divergence of the pivot-distance
                      histogram past which ingest stages a pivot
                      re-selection + refit on a shadow index (durable table
                      kinds only; None = drift detection off).
      checkpoint_every: WAL records between automatic checkpoints picked up
                      by the maintenance tick (durable only; None = only
                      explicit ``checkpoint()``).
      query_options:  per-index ``QueryOptions`` defaults (persisted).
      device:         "cuda" (default) or "cpu".
    """
    kind = _resolve_kind(kind)
    if attributes is not None and not isinstance(attributes, AttributeStore):
        raise TypeError(
            f"attributes= must be a repro_torch.filter.AttributeStore; got {type(attributes).__name__}"
        )
    approx = None
    if apex_dims is not None:
        if kind not in ("nsimplex", "laesa"):
            raise ValueError(
                f"apex_dims applies to the table kinds (nsimplex/laesa); "
                f"kind={kind!r} has no truncatable surrogate"
            )
        if not (2 <= int(apex_dims) <= int(n_pivots)):
            raise ValueError(f"apex_dims must be in [2, n_pivots={n_pivots}]; got {apex_dims}")
        approx = {"dims": int(apex_dims), "refine": int(refine)}
    if durable:
        if shards is not None:
            raise ValueError(
                "durable=True does not compose with shards=; durable stores "
                "are sharded at the registry level (one WAL dir per tenant)"
            )
        if wal_dir is None:
            raise ValueError("durable=True requires wal_dir=")
    elif wal_dir is not None:
        raise ValueError("wal_dir= is only meaningful with durable=True")
    if shards is None and (fanout_workers is not None or layout is not None):
        raise ValueError("fanout_workers=/layout= are only meaningful with shards=")
    dev = resolve_device(device)
    data = np.asarray(data)
    metric = get_metric(metric) if isinstance(metric, str) else metric
    pivots = None
    if kind in ("nsimplex", "laesa"):
        pivots = select_pivots(data, n_pivots, strategy=pivot_strategy, seed=seed, metric=metric)
    seg_kw = dict(pivots=pivots, leaf_size=leaf_size, seed=seed, eps=eps, use_kernel=use_kernel,
                  approx=approx, device=dev)
    if shards is not None:
        index = _build_sharded(
            data, metric, kind, int(shards), seg_kw, mutable=mutable, compact_threshold=compact_threshold,
            eps=eps, device_filter=device_filter, max_candidates=max_candidates, approx=approx,
            fanout_workers=fanout_workers, layout=layout,
        )
    else:
        index = _build_segment(data, metric, kind, **seg_kw)
        if durable:
            return _durable_cls().create(
                MutableIndex(index, compact_threshold=compact_threshold),
                wal_dir,
                build_params={
                    "kind": kind,
                    "n_pivots": int(n_pivots),
                    "pivot_strategy": pivot_strategy,
                    "leaf_size": int(leaf_size),
                    "seed": int(seed),
                    "eps": float(eps),
                    "use_kernel": bool(use_kernel),
                },
                drift_threshold=drift_threshold,
                fsync_every=fsync_every,
                checkpoint_every=checkpoint_every,
                query_options=query_options,
                attributes=attributes,
            )
        if mutable:
            index = MutableIndex(index, compact_threshold=compact_threshold)
    index.query_options = query_options
    if attributes is not None:
        index.attach_attributes(attributes)
    return index


def _build_sharded(data, metric, kind: str, n_shards: int, seg_kw: dict, *, mutable: bool, compact_threshold,
                   **composite_kw) -> ShardedIndex:
    """Rows split into ``n_shards`` contiguous blocks: shard 0 fits the
    (shared) simplex and the rest spawn from it, so the inter-pivot
    distances are measured once; each block is a mutable shard on request."""
    if n_shards < 1:
        raise ValueError(f"shards must be >= 1; got {n_shards}")
    bounds = np.linspace(0, len(data), n_shards + 1).astype(int)
    shard_list, shard_ids, seg0 = [], [], None
    for s in range(n_shards):
        block = data[bounds[s]: bounds[s + 1]]
        seg = _build_segment(block, metric, kind, **seg_kw) if s == 0 else seg0.spawn(block)
        seg0 = seg0 or seg
        ids = np.arange(bounds[s], bounds[s + 1], dtype=np.int64)
        if mutable:
            shard_list.append(MutableIndex(seg, ids=ids, compact_threshold=compact_threshold))
            shard_ids.append(None)
        else:
            shard_list.append(seg)
            shard_ids.append(ids)
    return ShardedIndex(
        shard_list, shard_ids, inner_kind=kind, mutable=mutable, next_id=len(data),
        projector=_shared_projector(shard_list[0], kind), **composite_kw,
    )


def load_index(path, *, device="cuda"):
    """Load an index saved by either package onto ``device``; the
    manifest's ``kind`` selects the class (a mutable index recurses into its
    ``base/`` and ``delta/`` segment directories, a sharded one into its
    ``shard_SSS/`` directories, a durable snapshot into its ``state/`` and
    then replays its WAL tail), a saved ``attributes/`` store is
    reattached, and nothing is re-measured."""
    dev = resolve_device(device)
    manifest, arrays = read_index_dir(path)
    kind = manifest["kind"]
    if kind == "durable":
        _durable_cls()
    if kind in COMPOSITE_KINDS:
        out = COMPOSITE_KINDS[kind]._load(path, manifest, arrays, device=dev)
    elif kind in INDEX_KINDS:
        out = INDEX_KINDS[kind]._load(manifest, arrays, device=dev)
    else:
        raise ValueError(
            f"index at {path!r} has unknown kind {kind!r}; one of {sorted(INDEX_KINDS) + sorted(COMPOSITE_KINDS)}"
        )
    if out.attributes is None:
        # the durable loader attaches its own store (checkpoint + WAL
        # replay); every other kind persists it as an ``attributes/`` sidecar
        store = AttributeStore.maybe_load(os.path.join(os.fspath(path), "attributes"))
        if store is not None:
            out.attach_attributes(store)
    return out
