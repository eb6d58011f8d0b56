"""The n-simplex technique: Algorithms 1/2, the host GEMM projection, the
projector, and the two-sided bounds."""

from repro_torch.core.bounds import (
    ACCEPT,
    EXCLUDE,
    RECHECK,
    filter_decisions,
    lower_bound,
    mean_bound,
    truncate_apexes,
    two_sided,
    upper_bound,
)
from repro_torch.core.simplex import (
    apex_addition,
    apex_addition_np,
    apex_gemm_np,
    base_lower_triangular,
    simplex_build_np,
)
from repro_torch.core.surrogate import NSimplexProjector, select_pivots, truncate_apexes_np

__all__ = [
    "ACCEPT",
    "EXCLUDE",
    "RECHECK",
    "filter_decisions",
    "lower_bound",
    "mean_bound",
    "truncate_apexes",
    "two_sided",
    "upper_bound",
    "apex_addition",
    "apex_addition_np",
    "apex_gemm_np",
    "base_lower_triangular",
    "simplex_build_np",
    "NSimplexProjector",
    "select_pivots",
    "truncate_apexes_np",
]
