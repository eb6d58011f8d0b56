"""Columnar attribute store aligned with logical row ids.

``AttributeStore`` keeps one typed numpy column per declared attribute,
row-aligned with a sorted int64 array of logical ids.  It is the
mutation-owning index object's sidecar: ``add`` / ``remove`` / ``upsert``
on the index call ``put`` / ``drop`` here, ``compact()`` leaves it
untouched (logical ids are stable across compaction), and composites
persist it next to their manifests via ``save`` / ``load``.

Semantics: the store holds only rows that HAVE attributes.  ``match``
returns the sorted ids of stored rows satisfying a predicate — indexed
rows absent from the store never match an attribute clause, mirroring SQL
``NULL`` exclusion.  ``selectivity`` estimates the matching fraction from
per-column statistics alone (no row scan), which is what the planner uses
to pick a filter strategy.

Mutation follows the rebind-don't-mutate rule: ``put`` / ``drop`` build
fresh arrays and bump ``version``, so ``view()`` snapshots handed to read
views stay frozen for free.  The column statistics are computed once per
``version`` and kept (a predicate's selectivity reads them on every plan;
at a million rows a categorical column's ``np.unique`` takes about a
second), which changes no result.

The store stays host numpy in the port too: a predicate compiles to a
sorted logical-id array on the host, and the index turns that into the row
mask its kernels read.  The on-disk layout (``attributes.json`` +
``attributes.npz``) is the JAX package's ``repro.filter.store``, so a store
saved by either package loads in the other.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np

from repro_torch.filter.predicate import ID_ATTR, Predicate

#: declared column kinds -> numpy storage dtype
COLUMN_KINDS = {
    "int": np.int64,
    "float": np.float64,
    "bool": np.bool_,
    "categorical": None,  # numpy unicode, width grows with the data
}

#: value-histogram cutoff: at or below this many distinct values the stats
#: carry exact counts, above it numeric columns carry equi-width bins
HISTOGRAM_MAX = 32

#: number of equi-width bins for high-cardinality numeric columns
N_BINS = 16

MANIFEST_NAME = "attributes.json"
ARRAYS_NAME = "attributes.npz"


def _coerce_column(kind: str, values) -> np.ndarray:
    if kind == "int":
        out = np.asarray(values, dtype=np.int64)
    elif kind == "float":
        out = np.asarray(values, dtype=np.float64)
    elif kind == "bool":
        out = np.asarray(values, dtype=np.bool_)
    elif kind == "categorical":
        out = np.asarray([str(v) for v in np.asarray(values, dtype=object).reshape(-1)])
    else:
        raise ValueError(f"unknown column kind {kind!r}; expected one of {sorted(COLUMN_KINDS)}")
    if out.ndim != 1:
        raise ValueError(f"column values must be 1-D; got shape {out.shape}")
    return out


class AttributeStore:
    """Typed columns keyed by sorted logical row ids."""

    def __init__(self, schema: Mapping[str, str]):
        if not schema:
            raise ValueError("AttributeStore needs at least one column in its schema")
        for name, kind in schema.items():
            if not isinstance(name, str) or not name or name == ID_ATTR:
                raise ValueError(f"invalid column name {name!r}")
            if kind not in COLUMN_KINDS:
                raise ValueError(
                    f"column {name!r} has unknown kind {kind!r}; "
                    f"expected one of {sorted(COLUMN_KINDS)}"
                )
        self.schema: Dict[str, str] = dict(schema)
        self._ids = np.empty(0, dtype=np.int64)
        self._cols: Dict[str, np.ndarray] = {
            name: _coerce_column(kind, []) for name, kind in self.schema.items()
        }
        self.version = 0

    # -- introspection ---------------------------------------------------
    def __len__(self) -> int:
        return int(self._ids.size)

    def ids(self) -> np.ndarray:
        """Sorted logical ids of rows with attributes (copy)."""
        return self._ids.copy()

    def column(self, name: str) -> np.ndarray:
        """Values of one column aligned with ``ids()`` (copy)."""
        self._check_column(name)
        return self._cols[name].copy()

    def _check_column(self, name: str) -> None:
        if name not in self.schema:
            raise ValueError(
                f"unknown attribute {name!r}; this store has columns {sorted(self.schema)}"
            )

    # -- mutation (rebind-don't-mutate) ----------------------------------
    def put(self, ids, values: Mapping[str, Iterable]) -> None:
        """Upsert attribute rows: ``values`` maps EVERY column to per-row data."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.size == 0:
            return
        if np.unique(ids).size != ids.size:
            raise ValueError("put ids contain duplicates")
        missing = set(self.schema) - set(values)
        extra = set(values) - set(self.schema)
        if missing or extra:
            raise ValueError(
                f"put values must cover the schema exactly; missing={sorted(missing)} "
                f"unknown={sorted(extra)}"
            )
        cols = {}
        for name, kind in self.schema.items():
            col = _coerce_column(kind, values[name])
            if col.shape[0] != ids.size:
                raise ValueError(
                    f"column {name!r} has {col.shape[0]} values for {ids.size} ids"
                )
            cols[name] = col
        order = np.argsort(ids, kind="stable")
        ids, cols = ids[order], {n: c[order] for n, c in cols.items()}
        keep = ~np.isin(self._ids, ids)  # replaced rows drop out of the old arrays
        new_ids = np.concatenate([self._ids[keep], ids])
        merged = {n: np.concatenate([c[keep], cols[n]]) for n, c in self._cols.items()}
        order = np.argsort(new_ids, kind="stable")
        self._ids = new_ids[order]
        self._cols = {n: c[order] for n, c in merged.items()}
        self.version += 1

    def drop(self, ids) -> None:
        """Remove attribute rows for ``ids`` (absent ids are ignored)."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        if ids.size == 0 or self._ids.size == 0:
            return
        keep = ~np.isin(self._ids, ids)
        if keep.all():
            return
        self._ids = self._ids[keep]
        self._cols = {n: c[keep] for n, c in self._cols.items()}
        self.version += 1

    def subset(self, ids) -> "AttributeStore":
        """New store holding only rows whose id is in ``ids``."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        keep = np.isin(self._ids, ids)
        out = AttributeStore(self.schema)
        out._ids = self._ids[keep].copy()
        out._cols = {n: c[keep].copy() for n, c in self._cols.items()}
        out.version = self.version
        return out

    def remap(self, id_map: Mapping[int, int]) -> "AttributeStore":
        """New store with ids translated through ``id_map`` (missing ids drop)."""
        out = AttributeStore(self.schema)
        if self._ids.size:
            keep = np.array([int(i) in id_map for i in self._ids], dtype=bool)
            new_ids = np.array([id_map[int(i)] for i in self._ids[keep]], dtype=np.int64)
            order = np.argsort(new_ids, kind="stable")
            out._ids = new_ids[order]
            out._cols = {n: c[keep][order].copy() for n, c in self._cols.items()}
        out.version = self.version
        return out

    def view(self) -> "AttributeStore":
        """Frozen-in-time snapshot sharing the current arrays (O(1))."""
        out = AttributeStore.__new__(AttributeStore)
        out.schema = self.schema
        out._ids = self._ids
        out._cols = self._cols
        out.version = self.version
        return out

    def copy(self) -> "AttributeStore":
        out = AttributeStore(self.schema)
        out._ids = self._ids.copy()
        out._cols = {n: c.copy() for n, c in self._cols.items()}
        out.version = self.version
        return out

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        """Per-column statistics: kind, cardinality, min/max, histogram/bins."""
        return copy.deepcopy(self._stats())

    def _stats(self) -> dict:
        """``stats()``, computed once per ``version`` and shared (read only).

        A durable index's planner reads its live store while a writer may
        ``put``: the version is read before the columns (a writer bumps it
        after rebinding them), so a racing fill can only cache newer columns
        under an older version, never older ones under the current."""
        version, cols = self.version, self._cols
        cached = getattr(self, "_stats_cache", None)
        if cached is not None and cached[0] == version:
            return cached[1]
        out = {"n_rows": len(self), "version": version, "columns": {}}
        for name, kind in sorted(self.schema.items()):
            col = cols[name]
            entry: dict = {"kind": kind, "count": int(col.size)}
            if col.size:
                uniq, counts = np.unique(col, return_counts=True)
                entry["cardinality"] = int(uniq.size)
                if kind in ("int", "float"):
                    entry["min"] = float(col.min())
                    entry["max"] = float(col.max())
                if uniq.size <= HISTOGRAM_MAX:
                    entry["histogram"] = {
                        (str(v) if kind == "categorical" else v.item()): int(c)
                        for v, c in zip(uniq, counts)
                    }
                elif kind in ("int", "float"):
                    hist, edges = np.histogram(col.astype(np.float64), bins=N_BINS)
                    entry["bins"] = {
                        "edges": [float(e) for e in edges],
                        "counts": [int(c) for c in hist],
                    }
            else:
                entry["cardinality"] = 0
            out["columns"][name] = entry
        self._stats_cache = (version, out)
        return out

    # -- predicate evaluation --------------------------------------------
    def _clause_mask(self, clause) -> np.ndarray:
        self._check_column(clause.attr)
        col = self._cols[clause.attr]
        kind = self.schema[clause.attr]
        if clause.op in ("eq", "in"):
            vals = _coerce_column(kind, list(clause.values))
            return np.isin(col, vals)
        if clause.op == "range":
            lo, hi = clause.values
            mask = np.ones(col.size, dtype=bool)
            if lo is not None:
                mask &= col >= _coerce_column(kind, [lo])[0]
            if hi is not None:
                mask &= col <= _coerce_column(kind, [hi])[0]
            return mask
        raise ValueError(f"unsupported op {clause.op!r} for attribute clause")

    def match(self, predicate: Predicate) -> np.ndarray:
        """Sorted logical ids of stored rows satisfying every clause."""
        if not isinstance(predicate, Predicate):
            raise TypeError(f"expected Predicate; got {type(predicate).__name__}")
        mask = np.ones(self._ids.size, dtype=bool)
        for clause in predicate.clauses:
            if clause.attr == ID_ATTR:
                continue  # id sugar is folded into Query.allow/deny upstream
            mask &= self._clause_mask(clause)
        return self._ids[mask].copy()

    def _clause_selectivity(self, clause) -> float:
        self._check_column(clause.attr)
        col = self._cols[clause.attr]
        n = col.size
        if n == 0:
            return 0.0
        kind = self.schema[clause.attr]
        stats = self._stats()["columns"][clause.attr]
        if clause.op in ("eq", "in"):
            hist = stats.get("histogram")
            if hist is not None:
                want = {str(v) if kind == "categorical" else v for v in clause.values}
                hit = sum(c for v, c in hist.items() for w in want if v == w)
                return hit / n
            # high cardinality: uniform-frequency assumption
            return min(1.0, len(clause.values) / max(stats.get("cardinality", 1), 1))
        # range over numerics: fraction of bin mass (or uniform span) inside
        lo, hi = clause.values
        lo = -np.inf if lo is None else float(lo)
        hi = np.inf if hi is None else float(hi)
        bins = stats.get("bins")
        if bins is not None:
            edges, counts = np.asarray(bins["edges"]), np.asarray(bins["counts"], dtype=float)
            mass = 0.0
            for b in range(counts.size):
                left, right = edges[b], edges[b + 1]
                width = right - left
                if width <= 0:
                    overlap = 1.0 if lo <= left <= hi else 0.0
                else:
                    overlap = max(0.0, (min(hi, right) - max(lo, left)) / width)
                mass += counts[b] * min(1.0, overlap)
            return float(mass / max(counts.sum(), 1.0))
        hist = stats.get("histogram")
        if hist is not None:
            hit = sum(c for v, c in hist.items() if lo <= float(v) <= hi)
            return hit / n
        cmin, cmax = stats.get("min", 0.0), stats.get("max", 0.0)
        span = cmax - cmin
        if span <= 0:
            return 1.0 if lo <= cmin <= hi else 0.0
        return float(max(0.0, min(hi, cmax) - max(lo, cmin)) / span)

    def selectivity(self, predicate: Predicate) -> float:
        """Estimated matching fraction in [0, 1], clause-independence model."""
        if len(self) == 0:
            return 0.0
        est = 1.0
        for clause in predicate.clauses:
            if clause.attr == ID_ATTR:
                continue
            est *= self._clause_selectivity(clause)
        return float(min(1.0, max(0.0, est)))

    # -- persistence -----------------------------------------------------
    def save(self, path) -> None:
        path = os.fspath(path)
        os.makedirs(path, exist_ok=True)
        manifest = {
            "schema": self.schema,
            "version": self.version,
            "n_rows": len(self),
        }
        with open(os.path.join(path, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        arrays = {"ids": self._ids}
        arrays.update({f"col_{n}": c for n, c in self._cols.items()})
        np.savez(os.path.join(path, ARRAYS_NAME), **arrays)

    @classmethod
    def load(cls, path) -> "AttributeStore":
        path = os.fspath(path)
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        out = cls(manifest["schema"])
        with np.load(os.path.join(path, ARRAYS_NAME)) as z:
            out._ids = z["ids"].astype(np.int64)
            out._cols = {
                n: z[f"col_{n}"]
                if kind == "categorical"
                else z[f"col_{n}"].astype(COLUMN_KINDS[kind])
                for n, kind in manifest["schema"].items()
            }
        out.version = int(manifest.get("version", 0))
        return out

    @staticmethod
    def maybe_load(path) -> Optional["AttributeStore"]:
        """Load a store from ``path`` if one was saved there, else None."""
        path = os.fspath(path)
        if os.path.exists(os.path.join(path, MANIFEST_NAME)):
            return AttributeStore.load(path)
        return None

    # -- wire helpers ----------------------------------------------------
    def row_values(self, ids) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(present ids, per-column values) for ``ids`` that have attributes."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        pos = np.searchsorted(self._ids, ids)
        pos = np.clip(pos, 0, max(self._ids.size - 1, 0))
        present = self._ids.size > 0
        hit = (self._ids[pos] == ids) if present else np.zeros(ids.size, dtype=bool)
        sel = pos[hit]
        return ids[hit], {n: c[sel] for n, c in self._cols.items()}
