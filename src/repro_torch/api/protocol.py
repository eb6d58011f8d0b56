"""The ``Index`` and ``SupportsMutation`` protocols and the ``stats()`` key
contract.

``STATS_CONTRACT`` is the JAX package's, key for key: every index kind
reports the ``common`` keys and its own extras; a composite reports its
innermost segment's keys too.  This package implements every kind of the
table: ``nsimplex``, ``laesa``, ``tree``, ``mutable``, ``sharded`` and
``durable`` (``repro_torch.store.DurableIndex``, which reports the
``mutable`` keys of its inner index as well).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.api.types import BatchQueryResult, QueryResult

STATS_CONTRACT = {
    "common": frozenset({"kind", "metric", "n_objects", "dim"}),
    "nsimplex": frozenset({"n_pivots", "table_bytes"}),
    "laesa": frozenset({"n_pivots", "table_bytes"}),
    "tree": frozenset({"leaf_size", "build_calls"}),
    "mutable": frozenset(
        {
            "base_kind",
            "base_rows",
            "delta_rows",
            "tombstones",
            "compact_threshold",
            "pending_compaction",
            "compactions",
            "generation",
        }
    ),
    "durable": frozenset(
        {
            "base_kind",
            "wal_records",
            "wal_bytes",
            "wal_synced",
            "refits",
            "drift_stat",
            "drift_pending",
        }
    ),
    "sharded": frozenset(
        {
            "inner_kind",
            "n_shards",
            "mutable",
            "shard_objects",
            "device_filter",
            "shared_projector",
        }
    ),
}


@runtime_checkable
class Index(Protocol):
    """Structural protocol for index mechanisms."""

    kind: str

    def fit(self, data: np.ndarray) -> "Index":
        """Rebuild over new data, reusing the fitted configuration."""
        ...

    def query(self, q: np.ndarray, spec, *, plan=None):
        """Answer one ``Query``: 1-D ``q`` -> ``QueryResult``, 2-D ->
        ``BatchQueryResult``."""
        ...

    def plan(self, spec):
        """The ``QueryPlan`` that ``query()`` would execute."""
        ...

    def search(self, q: np.ndarray, threshold: float) -> QueryResult:
        ...

    def search_batch(self, queries: np.ndarray, thresholds) -> BatchQueryResult:
        ...

    def knn(self, q: np.ndarray, k: int) -> QueryResult:
        ...

    def knn_batch(self, queries: np.ndarray, k: int) -> BatchQueryResult:
        ...

    def save(self, path) -> None:
        """Persist to ``path`` (directory with manifest.json + arrays.npz)."""
        ...

    def stats(self) -> dict:
        """Build-time facts per the ``STATS_CONTRACT`` key sets."""
        ...


@runtime_checkable
class SupportsMutation(Protocol):
    """Structural protocol for online (mutable) indexes.

    Query results always reflect the *logical* rows: ids are stable logical
    ids that survive compaction, and every query answers as a fresh rebuild
    over the current live rows would (same ids, same (distance, id) tie
    order).
    """

    def add(self, rows: np.ndarray, ids=None) -> np.ndarray:
        """Append rows; returns their logical ids (no refit)."""
        ...

    def remove(self, ids) -> None:
        """Tombstone live logical ids; raises KeyError on an unknown id."""
        ...

    def upsert(self, ids, rows: np.ndarray) -> np.ndarray:
        """Replace (or insert) rows under the given logical ids."""
        ...

    def compact(self) -> "Index":
        """Fold delta + tombstones back into a single fitted segment."""
        ...

    def ids(self) -> np.ndarray:
        """The live logical ids, ascending."""
        ...
