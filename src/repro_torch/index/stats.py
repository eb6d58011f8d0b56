"""Per-query cost ledger (the paper's Table 3 discipline)."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["QueryStats"]


@dataclass
class QueryStats:
    original_calls: int = 0      # original-space metric evaluations (incl. pivots)
    surrogate_calls: int = 0     # surrogate-space evaluations (table rows)
    accepted_no_check: int = 0   # results admitted without original-space check
    candidates: int = 0          # rows surviving the filter
    #: approximate paths only: achieved surrogate band width; 0.0 when exact
    bound_width: float = 0.0

    def merge(self, other: "QueryStats") -> "QueryStats":
        """Fold another ledger into this one (the band width keeps the
        widest value)."""
        self.original_calls += other.original_calls
        self.surrogate_calls += other.surrogate_calls
        self.accepted_no_check += other.accepted_no_check
        self.candidates += other.candidates
        self.bound_width = max(self.bound_width, other.bound_width)
        return self
