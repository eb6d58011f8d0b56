"""repro_torch.api — the unified index protocol on PyTorch.

Build with ``build_index``, answer declarative ``Query`` specs with
``index.query(q_or_batch, spec)`` (``index.plan(spec).explain()`` shows the
pipeline), persist with ``save`` / ``load_index`` in the JAX package's
on-disk format.  ``build_index(..., mutable=True)`` returns a
``MutableIndex`` (online add / remove / upsert / compact, exact queries),
``build_index(..., shards=S)`` a ``ShardedIndex`` (rows over S segments
sharing one pivot set, optionally mutable),
``build_index(..., durable=True, wal_dir=...)`` a ``DurableIndex`` (WAL-first
mutations, checkpoints, crash recovery through ``repro_torch.store``, in the
JAX package's on-disk format);
``build_index(..., attributes=store)`` enables ``Query(where=Predicate...)``.
Results arrive as ``QueryResult`` / ``BatchQueryResult`` carriers with the
paper's per-query cost ledger.
"""

from repro_torch.api.execute import QuerySurface, execute
from repro_torch.api.factory import COMPOSITE_KINDS, INDEX_KINDS, build_index, load_index
from repro_torch.api.indexes import MetricTreeIndex, PivotTableIndex, SimplexTableIndex
from repro_torch.api.mutable import MutableIndex
from repro_torch.api.persistence import FORMAT_VERSION
from repro_torch.api.planner import PlanStage, QueryPlan, plan
from repro_torch.api.protocol import STATS_CONTRACT, Index, SupportsMutation
from repro_torch.api.query import DEFAULT_REFINE, Query, QueryOptions
from repro_torch.api.sharded import ShardedIndex
from repro_torch.api.types import BatchQueryResult, QueryResult, QueryStats

__all__ = [
    "BatchQueryResult",
    "COMPOSITE_KINDS",
    "DEFAULT_REFINE",
    "DurableIndex",
    "FORMAT_VERSION",
    "INDEX_KINDS",
    "Index",
    "MetricTreeIndex",
    "MutableIndex",
    "PivotTableIndex",
    "PlanStage",
    "Query",
    "QueryOptions",
    "QueryPlan",
    "QueryResult",
    "QueryStats",
    "QuerySurface",
    "STATS_CONTRACT",
    "ShardedIndex",
    "SimplexTableIndex",
    "SupportsMutation",
    "build_index",
    "execute",
    "load_index",
    "plan",
]


def __getattr__(name):
    # ``repro_torch.store`` imports this package, so its class is bound on
    # first use rather than at import time
    if name == "DurableIndex":
        from repro_torch.store.durable import DurableIndex

        return DurableIndex
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
