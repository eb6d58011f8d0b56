"""repro_torch.api — the unified index protocol on PyTorch.

Build with ``build_index``, answer declarative ``Query`` specs with
``index.query(q_or_batch, spec)`` (``index.plan(spec).explain()`` shows the
pipeline), persist with ``save`` / ``load_index`` in the JAX package's
on-disk format.  Results arrive as ``QueryResult`` / ``BatchQueryResult``
carriers with the paper's per-query cost ledger.
"""

from repro_torch.api.execute import QuerySurface, execute
from repro_torch.api.factory import build_index, load_index
from repro_torch.api.indexes import MetricTreeIndex, PivotTableIndex, SimplexTableIndex
from repro_torch.api.persistence import FORMAT_VERSION
from repro_torch.api.planner import PlanStage, QueryPlan, plan
from repro_torch.api.protocol import STATS_CONTRACT, Index
from repro_torch.api.query import DEFAULT_REFINE, Query, QueryOptions
from repro_torch.api.types import BatchQueryResult, QueryResult, QueryStats

__all__ = [
    "BatchQueryResult",
    "DEFAULT_REFINE",
    "FORMAT_VERSION",
    "Index",
    "MetricTreeIndex",
    "PivotTableIndex",
    "PlanStage",
    "Query",
    "QueryOptions",
    "QueryPlan",
    "QueryResult",
    "QueryStats",
    "QuerySurface",
    "STATS_CONTRACT",
    "SimplexTableIndex",
    "build_index",
    "execute",
    "load_index",
    "plan",
]
