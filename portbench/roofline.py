"""The yardstick of the kernels: published peaks and the least time of a launch.

Frozen copies of the bound formulas that the port's correctness smoke
(``chip_smoke.py``: ``bound``, ``select_bound``, and its K4 / K5 rows)
times its kernels against.  Each input byte is counted read once and each
output byte written once; the operations are those the answer needs.  A
launch is known by its shape class (``repro_torch.kernels.ops.shape_class``)
and the cell's table (N rows, n columns).  Where a class holds only a
bucket (K5's P above 32: P lies in (bucket / 2, bucket]), the least P of
the bucket is counted, and where the work depends on data that a class does
not carry (K3's kept rows), none is counted, so a share can read low and
never high.
"""

from __future__ import annotations

__all__ = ["F32_FLOPS", "F64_FLOPS", "HBM_BPS", "LOG_F64_FLOPS", "least_seconds"]

#: one NVIDIA H100 SXM (data sheet, dense, 700 W): HBM3 bytes/s, and FLOP/s
#: of float32 and float64 outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
#: floating-point operations of one IEEE float64 log on the straight-line
#: path of a positive normal input (DFMA 2, DADD / DMUL 1), read from the
#: SASS of a one-line probe compiled with the kernels' flags on the H100
#: (28 FP64 instructions, 43 flops; CUDA 12.8, sm_90a)
LOG_F64_FLOPS = 43


def _roof(bytes_: float, ops: float, flops: float) -> float:
    return max(bytes_ / HBM_BPS, ops / flops)


def _select(Q, rows, n, dims, q_numel, out_bytes, kept, squares=1, mask_bytes=0, itemsize=4) -> float:
    """A fused selection scan (K2, K3)."""
    return _roof(rows * n * itemsize + q_numel * itemsize + mask_bytes + out_bytes,
                 Q * rows * (2 * (dims - 1) + 3 + 3 * squares) + kept * 6,
                 F64_FLOPS if itemsize == 8 else F32_FLOPS)


def least_seconds(kernel: str, cls: tuple, *, N: int, n: int) -> float:
    """Least seconds one launch of ``kernel`` at shape class ``cls`` can take
    on an (N, n) float32 apex table."""
    tags = set(cls[4:] if kernel == "apex_topk" else cls[3:] if kernel == "apex_threshold" else ())
    itemsize = 8 if "float64" in tags else 4
    mask_bytes = N if "masked" in tags else 0
    if kernel == "apex_bounds":                    # K6 (n, dtype)
        return _roof((N * n + n) * 4 + 2 * N * 4, N * (2 * (n - 1) + 12), F32_FLOPS)
    if kernel == "apex_bounds_batch":              # K1 (Q, dims)
        Q, dims = cls
        return _roof(N * n * 4 + Q * dims * 4 + 2 * Q * N * 4, Q * N * (2 * (dims - 1) + 12), F32_FLOPS)
    if kernel == "apex_topk":                      # K2 (Q, k, key, dims, ...)
        Q, k, key, dims = cls[:4]
        return _select(Q, N, n, dims, Q * dims, Q * k * (4 + 2 * itemsize), Q * k,
                       squares=2 if key == "mid" else 1, mask_bytes=mask_bytes, itemsize=itemsize)
    if kernel == "apex_threshold":                 # K3 (Q, cap, dims, ...)
        Q, cap, dims = cls[:3]
        return _select(Q, N, n, dims, Q * dims, Q * (cap * (4 + 2 * itemsize) + 4), 0,
                       mask_bytes=mask_bytes, itemsize=itemsize)
    if kernel == "apex_project":                   # K4 (B, n, dtype)
        B, m, dtype = cls
        size, h = (8 if dtype == "float64" else 4), m - 1
        return _roof(2 * B * m * size + (h * h + h) * size, B * (2 * h * h + 4 * h + 4),
                     F64_FLOPS if dtype == "float64" else F32_FLOPS)
    if kernel == "jsd_pairwise":                   # K5 (Q, P bucket, d, dtype)
        Q, bucket, d, dtype = cls
        P = bucket if bucket <= 32 else bucket // 2 + 1
        size = 8 if dtype == "float64" else 4
        lf = LOG_F64_FLOPS
        ops = Q * P * d * (4 + lf) + (Q + P) * d * (4 + lf)
        return _roof((Q + P) * d * size + Q * P * size, ops, F64_FLOPS if dtype == "float64" else F32_FLOPS)
    raise KeyError(kernel)
