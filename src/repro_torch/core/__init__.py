"""The n-simplex technique: Algorithms 1/2, the host GEMM projection, the projector."""

from repro_torch.core.simplex import (
    apex_addition_np,
    apex_gemm_np,
    base_lower_triangular,
    simplex_build_np,
)
from repro_torch.core.surrogate import NSimplexProjector, select_pivots, truncate_apexes_np

__all__ = [
    "apex_addition_np",
    "apex_gemm_np",
    "base_lower_triangular",
    "simplex_build_np",
    "NSimplexProjector",
    "select_pivots",
    "truncate_apexes_np",
]
