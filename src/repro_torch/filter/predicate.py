"""Frozen, hashable predicate spec: eq / in / range AND-compositions.

A ``Predicate`` is a conjunction of normalised ``Clause`` atoms over named
attributes.  It is a pure value object — construction validates and
canonicalises (sorted clause order, deduped / sorted ``in`` sets, python
scalars only) so that two predicates selecting the same rows compare and
hash equal, which makes ``Query`` specs carrying them valid coalescing
keys for the batching service and cache keys for the planner.

The reserved attribute ``ID_ATTR`` ("__id__") carries id-level sugar:
``Predicate.ids(...)`` / ``Predicate.exclude_ids(...)`` compile to ``in`` /
``not_in`` clauses over it, which ``Query.__post_init__`` folds into the
legacy ``allow`` / ``deny`` tuples — so id sugar rides the exact same
execution paths, bit for bit.

This module is the JAX package's ``repro.filter.predicate``, copied: it has
no array code, and the port imports nothing of ``repro``.  Both packages'
predicates have the same canonical form and wire format (``to_dict`` /
``from_dict``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping

#: reserved attribute name for id-level (allow / deny) sugar clauses
ID_ATTR = "__id__"

#: clause operators
OPS = ("eq", "in", "range", "not_in")

_SCALARS = (int, float, str, bool)


def _scalar(value: Any) -> Any:
    """Coerce numpy scalars to plain python; reject unhashable values."""
    if hasattr(value, "item") and not isinstance(value, _SCALARS):
        value = value.item()
    if isinstance(value, bool) or isinstance(value, (int, float, str)):
        return value
    raise TypeError(
        f"predicate values must be int/float/str/bool scalars; got {type(value).__name__}"
    )


@dataclasses.dataclass(frozen=True)
class Clause:
    """One normalised predicate atom: ``attr <op> values``.

    * ``eq``     — ``values == (v,)``
    * ``in``     — ``values`` a sorted, deduped tuple of admitted values
    * ``not_in`` — complement of ``in`` (only used for id-level deny sugar)
    * ``range``  — ``values == (lo, hi)``, inclusive, ``None`` = unbounded
    """

    attr: str
    op: str
    values: tuple

    def __post_init__(self) -> None:
        if not isinstance(self.attr, str) or not self.attr:
            raise ValueError(f"clause attr must be a non-empty string; got {self.attr!r}")
        if self.op not in OPS:
            raise ValueError(f"clause op must be one of {OPS}; got {self.op!r}")
        if self.op == "range":
            if len(self.values) != 2:
                raise ValueError(f"range clause needs (lo, hi); got {self.values!r}")
            lo, hi = self.values
            vals = tuple(None if v is None else _scalar(v) for v in (lo, hi))
            if vals[0] is None and vals[1] is None:
                raise ValueError("range clause needs at least one of lo / hi")
            if (
                vals[0] is not None
                and vals[1] is not None
                and not isinstance(vals[0], str)
                and vals[0] > vals[1]
            ):
                raise ValueError(f"range lo > hi: {vals!r}")
        else:
            if not self.values:
                raise ValueError(f"{self.op} clause needs at least one value")
            vals = tuple(sorted({_scalar(v) for v in self.values}, key=lambda v: (str(type(v)), v)))
            if self.op == "eq" and len(vals) != 1:
                raise ValueError(f"eq clause takes exactly one value; got {self.values!r}")
        object.__setattr__(self, "values", vals)

    def to_dict(self) -> dict:
        return {"attr": self.attr, "op": self.op, "values": list(self.values)}


def _canon(clauses: Iterable[Clause]) -> tuple[Clause, ...]:
    seen: dict[tuple, Clause] = {}
    for c in clauses:
        seen.setdefault((c.attr, c.op, c.values), c)
    return tuple(
        sorted(seen.values(), key=lambda c: (c.attr, OPS.index(c.op), tuple(map(str, c.values))))
    )


@dataclasses.dataclass(frozen=True)
class Predicate:
    """AND-conjunction of clauses; construct via the classmethod sugar."""

    clauses: tuple[Clause, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "clauses", _canon(self.clauses))

    # -- constructors ----------------------------------------------------
    @classmethod
    def eq(cls, attr: str, value: Any) -> "Predicate":
        return cls((Clause(attr, "eq", (value,)),))

    @classmethod
    def isin(cls, attr: str, values: Iterable[Any]) -> "Predicate":
        return cls((Clause(attr, "in", tuple(values)),))

    @classmethod
    def between(cls, attr: str, lo: Any = None, hi: Any = None) -> "Predicate":
        return cls((Clause(attr, "range", (lo, hi)),))

    @classmethod
    def ids(cls, ids: Iterable[int]) -> "Predicate":
        """Allow-list sugar: folds into ``Query.allow`` bit-identically."""
        return cls((Clause(ID_ATTR, "in", tuple(int(i) for i in ids)),))

    @classmethod
    def exclude_ids(cls, ids: Iterable[int]) -> "Predicate":
        """Deny-list sugar: folds into ``Query.deny`` bit-identically."""
        return cls((Clause(ID_ATTR, "not_in", tuple(int(i) for i in ids)),))

    # -- composition -----------------------------------------------------
    def __and__(self, other: "Predicate") -> "Predicate":
        if not isinstance(other, Predicate):
            return NotImplemented
        return Predicate(self.clauses + other.clauses)

    def __bool__(self) -> bool:
        return bool(self.clauses)

    # -- views -----------------------------------------------------------
    @property
    def attrs(self) -> tuple[str, ...]:
        """Attribute names referenced, id sugar excluded."""
        return tuple(sorted({c.attr for c in self.clauses if c.attr != ID_ATTR}))

    def split_ids(self) -> tuple["Predicate", tuple[int, ...], tuple[int, ...]]:
        """(attribute-only predicate, allow ids, deny ids) — the sugar fold."""
        attr_clauses, allow, deny = [], [], []
        for c in self.clauses:
            if c.attr != ID_ATTR:
                attr_clauses.append(c)
            elif c.op == "in":
                allow.extend(c.values)
            elif c.op == "not_in":
                deny.extend(c.values)
            else:
                raise ValueError(f"id clauses support only in/not_in; got {c.op!r}")
        return Predicate(tuple(attr_clauses)), tuple(allow), tuple(deny)

    # -- wire format -----------------------------------------------------
    def to_dict(self) -> dict:
        return {"clauses": [c.to_dict() for c in self.clauses]}

    @classmethod
    def from_dict(cls, payload: Mapping) -> "Predicate":
        if not isinstance(payload, Mapping) or "clauses" not in payload:
            raise ValueError("predicate payload must be a mapping with a 'clauses' list")
        raw = payload["clauses"]
        if not isinstance(raw, (list, tuple)):
            raise ValueError("predicate 'clauses' must be a list")
        clauses = []
        for item in raw:
            if not isinstance(item, Mapping):
                raise ValueError(f"predicate clause must be a mapping; got {item!r}")
            try:
                clauses.append(
                    Clause(item["attr"], item["op"], tuple(item["values"]))
                )
            except KeyError as exc:
                raise ValueError(f"predicate clause missing key {exc}") from exc
        return cls(tuple(clauses))
