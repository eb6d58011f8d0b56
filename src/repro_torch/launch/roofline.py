"""Roofline terms for one NVIDIA H100 (SXM, published dense peaks from
NVIDIA's data sheet, at the full 700 W power limit).

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS              [dense bf16]
  memory     = HBM_bytes_per_device / HBM_BW
  collective = collective_bytes_per_chip / NVLINK_BW      [per direction]

``F32_FLOPS`` and ``F64_FLOPS`` (outside the tensor cores) bound the
search kernels, which compute in those types (``chip_smoke.py``'s bounds).

``collective_bytes`` applies the ring convention to a dict of per-op
buffer bytes: all-reduce counts twice (reduce-scatter then all-gather),
the rest once.  The JAX package parses those bytes out of compiled HLO
text; eager PyTorch produces no HLO, so the port counts them where they
are dispatched: ``launch.op_walk`` adds the bytes of each ``c10d``
collective's result on this rank, by kind, as a sharded step runs (on
meta tensors as rank 0 of a production mesh in the dry run,
``launch.dryrun``; or live on a rank, ``op_walk.CollectiveCounter``).  A
chip's collective term is those bytes over one direction of its NVLink.
"""

from __future__ import annotations

from typing import Dict, Mapping

__all__ = [
    "COLLECTIVES",
    "F32_FLOPS",
    "F64_FLOPS",
    "HBM_BW",
    "NVLINK_BW",
    "PEAK_FLOPS",
    "collective_bytes",
    "roofline_terms",
]

PEAK_FLOPS = 989e12          # dense bf16 / fp16 tensor-core FLOP/s
F32_FLOPS = 67e12            # float32 FLOP/s outside the tensor cores
F64_FLOPS = 34e12            # float64 FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink bytes/s per direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def collective_bytes(per_op: Mapping[str, float]) -> Dict[str, float]:
    """Per-op bytes through one chip (missing ops count 0) plus their
    ``"total"`` under the ring convention."""
    out = {c: float(per_op.get(c, 0.0)) for c in COLLECTIVES}
    out["total"] = (
        2.0 * out["all-reduce"]
        + out["all-gather"]
        + out["reduce-scatter"]
        + out["all-to-all"]
        + out["collective-permute"]
    )
    return out


def roofline_terms(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_chip: float,
    n_chips: int,
    model_flops: float,
) -> Dict[str, float]:
    compute_s = flops_per_device / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    collective_s = collective_bytes_per_chip / NVLINK_BW
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    total_flops = flops_per_device * n_chips
    bound_s = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "hlo_flops_total": total_flops,
        "model_flops": model_flops,
        "useful_fraction": (model_flops / total_flops) if total_flops else 0.0,
        # fraction of the dominant-term-bound step time that is useful compute
        "roofline_fraction": (model_flops / (n_chips * PEAK_FLOPS)) / bound_s if bound_s > 0 else 0.0,
    }
