"""repro_torch.serve — the serving front end on PyTorch.

The JAX package's ``repro.serve`` with the same ``__all__``: the layer
between the network and the micro-batching core
(``repro_torch.launch.service``): an HTTP/JSON request boundary with end-to-end
deadline propagation, admission control (token-bucket rate limits, bounded
queues, deadline-aware load shedding, graceful degradation to the
truncated-apex path), a multi-tenant index registry with a shared worker
budget, and serving telemetry that calibrates the planner's cost model
from measured ``QueryStats``.

    from repro_torch.serve import Frontend, IndexRegistry

    registry = IndexRegistry(max_concurrent_batches=4)      # device="cuda"
    registry.add("colors", index=build_index(data, metric), rate=500.0)
    with Frontend(registry, port=8080) as fe:
        ...  # POST /v1/query {"tenant": "colors", "q": [...], "k": 10}
"""

from repro_torch.launch.service import (
    DeadlineExceeded,
    SearchService,
    ServiceClosed,
    ServiceOverloaded,
)
from repro_torch.serve.admission import (
    AdmissionController,
    AdmissionDecision,
    AdmissionRejected,
    TokenBucket,
)
from repro_torch.serve.frontend import Frontend, FrontendClient, FrontendError
from repro_torch.serve.registry import ImmutableTenant, IndexRegistry, Tenant, UnknownTenant
from repro_torch.serve.telemetry import Telemetry

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "AdmissionRejected",
    "DeadlineExceeded",
    "Frontend",
    "FrontendClient",
    "FrontendError",
    "ImmutableTenant",
    "IndexRegistry",
    "SearchService",
    "ServiceClosed",
    "ServiceOverloaded",
    "Telemetry",
    "Tenant",
    "TokenBucket",
    "UnknownTenant",
]
