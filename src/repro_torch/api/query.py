"""Declarative query specs: what to answer, not how to answer it.

A ``Query`` is a frozen, validated, hashable value: k-NN or range search,
the exact/approx dial, id allow/deny lists, a per-query cost budget and an
attribute predicate (``where=``) with its filter strategy.  Being hashable
it is also the coalescing key of ``SearchService``.  ``QueryOptions`` holds
per-index defaults for the fields a ``Query`` leaves unset.  Both mirror
the JAX package's types field for field, so plans explain identically.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, fields
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.filter.predicate import Predicate

__all__ = ["DEFAULT_REFINE", "Query", "QueryOptions"]

#: default true-metric re-rank budget for approximate queries
DEFAULT_REFINE = 64

_TASKS = ("knn", "range")
_MODES = ("exact", "approx", "auto")
_FILTER_MODES = ("prefilter", "pushdown", "postfilter")


def _id_tuple(ids) -> Optional[Tuple[int, ...]]:
    if ids is None:
        return None
    if isinstance(ids, (int, np.integer)):
        ids = (ids,)
    out = tuple(sorted({int(i) for i in ids}))
    for i in out:
        if i < 0:
            raise ValueError(f"id filters hold logical ids (>= 0); got {i}")
    return out


@dataclass(frozen=True)
class Query:
    """One declarative query spec.

    Args:
      task:      "knn" (k nearest, true distances, ties by id) or "range".
      k:         neighbour count (task="knn").
      threshold: a float, or a tuple of per-query floats (task="range").
      mode:      "exact" | "approx" | "auto" (the planner resolves "auto").
      dims:      truncation dimension of the approximate path.
      refine:    true-metric re-rank budget of the approximate path.
      allow:     id allowlist, answered by a direct exact scan of its rows.
      deny:      id denylist (k-NN over-fetches ``k + len(deny)``).
      budget:    per-query cost budget in true-metric evaluations.
      where:     attribute ``Predicate`` (or its dict form) evaluated against
                 the index's ``AttributeStore``; its id sugar
                 (``Predicate.ids`` / ``exclude_ids``) folds into ``allow`` /
                 ``deny`` here, so it rides the id-filter paths bit for bit.
      filter_mode: force one predicate strategy ("prefilter", "pushdown",
                 "postfilter"); None lets the planner choose.
    """

    task: str = "knn"
    k: Optional[int] = None
    threshold: Optional[Union[float, Tuple[float, ...]]] = None
    mode: str = "auto"
    dims: Optional[int] = None
    refine: Optional[int] = None
    allow: Optional[Tuple[int, ...]] = None
    deny: Optional[Tuple[int, ...]] = None
    budget: Optional[int] = None
    where: Optional[Predicate] = None
    filter_mode: Optional[str] = None

    def __post_init__(self):
        if self.task not in _TASKS:
            raise ValueError(f"task must be one of {_TASKS}; got {self.task!r}")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}; got {self.mode!r}")
        if self.task == "knn":
            if self.k is None or int(self.k) < 0:
                raise ValueError(f"task='knn' needs k >= 0; got {self.k!r}")
            object.__setattr__(self, "k", int(self.k))
            if self.threshold is not None:
                raise ValueError("task='knn' takes k, not threshold")
        else:
            if self.threshold is None:
                raise ValueError("task='range' needs a threshold")
            if self.k is not None:
                raise ValueError("task='range' takes threshold, not k")
            t = self.threshold
            t = tuple(float(x) for x in t) if isinstance(t, (tuple, list)) else float(t)
            if isinstance(t, tuple) and not t:
                raise ValueError("per-query threshold tuple must be non-empty")
            object.__setattr__(self, "threshold", t)
        if self.dims is not None and int(self.dims) < 2:
            raise ValueError(f"dims must be >= 2; got {self.dims}")
        if self.refine is not None and int(self.refine) < 0:
            raise ValueError(f"refine must be >= 0; got {self.refine}")
        if self.budget is not None and int(self.budget) <= 0:
            raise ValueError(f"budget must be positive; got {self.budget}")
        if self.filter_mode is not None and self.filter_mode not in _FILTER_MODES:
            raise ValueError(
                f"filter_mode must be one of {_FILTER_MODES} or None; got {self.filter_mode!r}"
            )
        allow, deny = self.allow, self.deny
        if self.where is not None:
            where = self.where
            if isinstance(where, dict):
                where = Predicate.from_dict(where)
            if not isinstance(where, Predicate):
                raise ValueError(
                    f"where must be a Predicate (or its dict form); got {type(where).__name__}"
                )
            where, sugar_allow, sugar_deny = where.split_ids()
            if sugar_allow:
                allow = sugar_allow if allow is None else tuple(allow) + sugar_allow
            if sugar_deny:
                deny = sugar_deny if deny is None else tuple(deny) + sugar_deny
            object.__setattr__(self, "where", where if where else None)
        object.__setattr__(self, "allow", _id_tuple(allow))
        object.__setattr__(self, "deny", _id_tuple(deny))
        if self.allow and self.deny:
            clash = set(self.allow) & set(self.deny)
            if clash:
                raise ValueError(f"ids cannot be both allowed and denied: {sorted(clash)}")

    @classmethod
    def knn(cls, k: int, **kw) -> "Query":
        return cls(task="knn", k=k, **kw)

    @classmethod
    def range(cls, threshold, **kw) -> "Query":
        return cls(task="range", threshold=threshold, **kw)

    def to_dict(self) -> dict:
        """JSON-able form (used by ``QueryPlan.explain`` and the service)."""
        d = asdict(self)
        for key in ("threshold", "allow", "deny"):
            if isinstance(d[key], tuple):
                d[key] = list(d[key])
        d["where"] = self.where.to_dict() if self.where is not None else None
        return d


@dataclass(frozen=True)
class QueryOptions:
    """Per-index query defaults consulted for every ``Query`` field left
    unset (Query > QueryOptions > build-time config > global defaults)."""

    mode: Optional[str] = None
    dims: Optional[int] = None
    refine: Optional[int] = None
    budget: Optional[int] = None

    def __post_init__(self):
        if self.mode is not None and self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}; got {self.mode!r}")
        if self.dims is not None and int(self.dims) < 2:
            raise ValueError(f"dims must be >= 2; got {self.dims}")
        if self.refine is not None and int(self.refine) < 0:
            raise ValueError(f"refine must be >= 0; got {self.refine}")
        if self.budget is not None and int(self.budget) <= 0:
            raise ValueError(f"budget must be positive; got {self.budget}")

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["QueryOptions"]:
        if d is None:
            return None
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
