"""Typed result carriers of the index protocol (host numpy arrays).

* ``QueryStats``       — the per-query cost ledger (``repro_torch.index.stats``).
* ``QueryResult``      — ids + (optionally) true distances + stats.
* ``BatchQueryResult`` — the results of one query block, with aggregate views.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.index.stats import QueryStats

__all__ = ["QueryStats", "QueryResult", "BatchQueryResult"]


@dataclass
class QueryResult:
    """One query's verified answer set.

    ``distances`` is None when not every returned id had its true distance
    evaluated (range search admits rows on the upper bound alone); k-NN
    results carry true distances, ascending, ties broken by id.  ``approx``
    is None for exact answers.
    """

    ids: np.ndarray
    distances: Optional[np.ndarray] = None
    stats: QueryStats = field(default_factory=QueryStats)
    approx: Optional[dict] = None

    def __post_init__(self):
        self.ids = np.asarray(self.ids, dtype=np.int64)
        if self.distances is not None:
            self.distances = np.asarray(self.distances, dtype=np.float64)

    def __len__(self) -> int:
        return int(self.ids.shape[0])


@dataclass
class BatchQueryResult:
    """Per-query results for one query block, plus the aggregate ledger."""

    results: List[QueryResult]
    elapsed_s: float = 0.0       # wall time for the whole block

    def __len__(self) -> int:
        return len(self.results)

    def __iter__(self) -> Iterator[QueryResult]:
        return iter(self.results)

    def __getitem__(self, i: int) -> QueryResult:
        return self.results[i]

    @property
    def total_original_calls(self) -> int:
        return sum(r.stats.original_calls for r in self.results)

    @property
    def total_surrogate_calls(self) -> int:
        return sum(r.stats.surrogate_calls for r in self.results)

    @property
    def total_accepted_no_check(self) -> int:
        return sum(r.stats.accepted_no_check for r in self.results)

    @property
    def total_candidates(self) -> int:
        return sum(r.stats.candidates for r in self.results)

    def metric_eval_fraction(self, n_objects: int) -> float:
        """Mean fraction of the table touched by the true metric per query
        (pivot distances included)."""
        if not self.results or n_objects <= 0:
            return 0.0
        return self.total_original_calls / (len(self.results) * n_objects)
