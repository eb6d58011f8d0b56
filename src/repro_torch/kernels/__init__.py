"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain
PyTorch versions (``ref.py``) and the wrappers that pick between them by the
device of their operands (``ops.py``)."""

from repro_torch.kernels.ops import (
    LAUNCHES,
    SENTINEL_ID,
    apex_bounds,
    apex_bounds_batch,
    apex_bounds_threshold,
    apex_bounds_topk,
    apex_project,
    jsd_pairwise,
    reset_launches,
)

__all__ = [
    "LAUNCHES",
    "SENTINEL_ID",
    "apex_bounds",
    "apex_bounds_batch",
    "apex_bounds_threshold",
    "apex_bounds_topk",
    "apex_project",
    "jsd_pairwise",
    "reset_launches",
]
