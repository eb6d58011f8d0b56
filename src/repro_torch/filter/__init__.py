"""Columnar attribute store + predicate filtering for supermetric search.

``AttributeStore`` holds typed columns (int / float / bool / categorical)
aligned with the logical row ids of an index; ``Predicate`` is the frozen,
hashable filter spec carried on ``Query.where``.  The planner compiles a
predicate to a row selection and chooses between three execution
strategies (pre-filter scan, pushdown row mask into the bound-scan kernels,
overfetch + post-filter) from the store's per-column statistics.
"""

from repro_torch.filter.predicate import ID_ATTR, Clause, Predicate
from repro_torch.filter.store import AttributeStore

__all__ = ["AttributeStore", "Clause", "ID_ATTR", "Predicate"]
