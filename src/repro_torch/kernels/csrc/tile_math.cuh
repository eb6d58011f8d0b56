// Shared per-pair bound math of the four bound-scan kernels (K1, K2, K3 use
// the GEMM form of pair_bounds; K6 its own difference form).
//
// Every operation is an explicitly rounded intrinsic, so the compiler can
// neither contract nor reorder it: K1, K2 and K3 produce the same bits for
// the same (query, row), which is what lets the selection epilogues be
// checked exactly against a host selection over K1's matrices.  Products
// are IEEE (fused multiply-add on the CUDA cores, never TF32), which the
// soundness slack of the f32 scan assumes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

__device__ __forceinline__ float op_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double op_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float op_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double op_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float op_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double op_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float op_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double op_fma(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float op_sqrt(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double op_sqrt(double a) { return __dsqrt_rn(a); }

template <typename T>
__device__ __forceinline__ T clamp0(T a) { return a < T(0) ? T(0) : a; }

// Head and altitude terms of one apex row truncated to hd + 1 coordinates:
// sq = |x[0:hd]|^2 and alt = sqrt(sum_{i >= hd} x_i^2) over a row `width`
// wide (the k-pivot apex folded from a stored n-pivot row; the identity
// fold when width == hd + 1).
template <typename T>
__device__ __forceinline__ void row_terms(const T* x, int hd, int width, T& sq, T& alt) {
    T s = T(0);
    for (int i = 0; i < hd; ++i) s = op_fma(x[i], x[i], s);
    T t = T(0);
    for (int i = hd; i < width; ++i) t = op_fma(x[i], x[i], t);
    sq = s;
    alt = op_sqrt(clamp0(t));
}

// GEMM-form two-sided bounds of one (query, row) pair:
//   head = max(|q|^2 + |x|^2 - 2 q.x, 0)
//   lwb  = sqrt(max(head + (qa - xa)^2, 0)),  upb = sqrt(max(head + (qa + xa)^2, 0))
// The squared bounds (before the sqrt) from the head dot product
// dot = sum_i q_i x_i, summed in ascending i by op_fma(q[i], x[i], dot): a
// kernel that forms the dot itself (K2 for a group of queries) gets
// pair_bounds' bits.
template <typename T>
__device__ __forceinline__ void bound_squares(T q2, T qa, T x2, T xa, T dot, T& lwb_sq, T& upb_sq) {
    T head = clamp0(op_sub(op_add(q2, x2), op_mul(T(2), dot)));
    T dm = op_sub(qa, xa);
    T dp = op_add(qa, xa);
    lwb_sq = clamp0(op_add(head, op_mul(dm, dm)));
    upb_sq = clamp0(op_add(head, op_mul(dp, dp)));
}

template <typename T>
__device__ __forceinline__ void pair_bounds(const T* q, T q2, T qa, const T* x, T x2, T xa,
                                            int hd, T& lwb, T& upb) {
    T dot = T(0);
    for (int i = 0; i < hd; ++i) dot = op_fma(q[i], x[i], dot);
    T lwb_sq, upb_sq;
    bound_squares(q2, qa, x2, xa, dot, lwb_sq, upb_sq);
    lwb = op_sqrt(lwb_sq);
    upb = op_sqrt(upb_sq);
}

// A table row of compile-time width NW into registers: 16-byte loads
// (float4 / double2) when NW * sizeof(T) is a multiple of 16 and `vec` says
// the table's base is 16-byte aligned (so is every row), scalar loads
// otherwise.
template <typename T, int NW>
__device__ __forceinline__ void load_row(const T* x, bool vec, T (&xr)[NW]) {
    constexpr int kVec = 16 / sizeof(T);
    if constexpr (NW % kVec == 0) {
        if (vec) {
            using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
            const V* xv = reinterpret_cast<const V*>(x);
#pragma unroll
            for (int v = 0; v < NW / kVec; ++v) {
                const V a = __ldg(xv + v);
                if constexpr (sizeof(T) == 4) {
                    xr[4 * v] = a.x;
                    xr[4 * v + 1] = a.y;
                    xr[4 * v + 2] = a.z;
                    xr[4 * v + 3] = a.w;
                } else {
                    xr[2 * v] = a.x;
                    xr[2 * v + 1] = a.y;
                }
            }
            return;
        }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) xr[i] = __ldg(x + i);
}

// row_terms() of a row held in registers, in its order.
template <typename T, int NW>
__device__ __forceinline__ void row_terms_reg(const T (&xr)[NW], int hd, T& sq, T& alt) {
    T s = T(0), t = T(0);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
        if (i < hd) s = op_fma(xr[i], xr[i], s);
        else t = op_fma(xr[i], xr[i], t);
    }
    sq = s;
    alt = op_sqrt(clamp0(t));
}
