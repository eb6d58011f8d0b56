"""The n-simplex technique: Algorithms 1/2, the host GEMM projection, the
triangular solve, the projector, the two-sided bounds, and the distortion
measurement (paper §5)."""

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
from repro_torch.core.distortion import distortion_from_ratios, measure_distortion
from repro_torch.core.simplex import (
    apex_addition,
    apex_addition_jax,
    apex_addition_np,
    apex_gemm,
    apex_gemm_np,
    apex_solve,
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
    "apex_addition_jax",
    "apex_addition_np",
    "apex_gemm",
    "apex_gemm_np",
    "apex_solve",
    "base_lower_triangular",
    "simplex_build_np",
    "NSimplexProjector",
    "select_pivots",
    "truncate_apexes_np",
    "measure_distortion",
    "distortion_from_ratios",
]
