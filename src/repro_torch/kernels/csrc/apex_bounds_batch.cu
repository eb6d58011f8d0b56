// K1: two-sided bounds of a (Q, qw) block of query apexes against the
// (N, n) apex table, in GEMM form, with optional dims=k truncation.
//
// Replaces the TPU kernel
// src/repro/kernels/apex_bounds_batch.py::apex_bounds_batch_pallas.
// Bound on this card: bytes.  The two (Q, N) outputs dominate (8 bytes per
// pair in f32) against ~2(k-1) + 12 operations per pair.
// Design: a 2-D grid of (table tile x query tile).  The block stages its
// kBN table rows (coalesced) and kBQ query rows in shared memory, computes
// each row's head norm and folded altitude once, then every thread takes one
// row against the kBQ queries, so each output row of the tile is written
// by consecutive threads.  The per-pair math is pair_bounds() of
// tile_math.cuh, shared bit for bit with the selection epilogues K2/K3.
// No tensor cores: an f32 mma would be TF32 and break the soundness slack.
#include "tile_math.cuh"

namespace {

constexpr int kBN = 128;  // table rows per block (= threads per block)
constexpr int kBQ = 16;   // queries per block

// odd row stride in shared memory keeps per-thread row reads conflict-free
__host__ __device__ inline int odd_stride(int w) { return w | 1; }

template <typename T>
__global__ void apex_bounds_batch_kernel(const T* __restrict__ table, int N, int n,
                                         const T* __restrict__ queries, int Q, int qw, int hd,
                                         T* __restrict__ lwb, T* __restrict__ upb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int sx = odd_stride(n);
    const int sq = odd_stride(qw);
    T* xs = reinterpret_cast<T*>(smem_raw);  // kBN * sx
    T* x2s = xs + kBN * sx;                  // kBN
    T* xas = x2s + kBN;                      // kBN
    T* qs = xas + kBN;                       // kBQ * sq
    T* q2s = qs + kBQ * sq;                  // kBQ
    T* qas = q2s + kBQ;                      // kBQ

    const int row0 = blockIdx.x * kBN;
    const int q0 = blockIdx.y * kBQ;
    const int rows = min(kBN, N - row0);
    const int nq = min(kBQ, Q - q0);

    for (int e = threadIdx.x; e < rows * n; e += blockDim.x)
        xs[(e / n) * sx + (e % n)] = table[(size_t)row0 * n + e];
    for (int e = threadIdx.x; e < nq * qw; e += blockDim.x)
        qs[(e / qw) * sq + (e % qw)] = queries[(size_t)q0 * qw + e];
    __syncthreads();
    if (threadIdx.x < rows) row_terms(xs + threadIdx.x * sx, hd, n, x2s[threadIdx.x], xas[threadIdx.x]);
    if (threadIdx.x < nq) row_terms(qs + threadIdx.x * sq, hd, qw, q2s[threadIdx.x], qas[threadIdx.x]);
    __syncthreads();

    const int r = threadIdx.x;
    if (r >= rows) return;
    const T* x = xs + r * sx;
    for (int j = 0; j < nq; ++j) {
        T l, u;
        pair_bounds(qs + j * sq, q2s[j], qas[j], x, x2s[r], xas[r], hd, l, u);
        const size_t o = (size_t)(q0 + j) * N + row0 + r;
        lwb[o] = l;
        upb[o] = u;
    }
}

template <typename T>
int launch(const T* table, int N, int n, const T* queries, int Q, int qw, int dims, T* lwb,
           T* upb, void* stream) {
    if (N > 0 && Q > 0) {
        const size_t smem =
            sizeof(T) * ((size_t)kBN * (odd_stride(n) + 2) + (size_t)kBQ * (odd_stride(qw) + 2));
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(apex_bounds_batch_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        dim3 grid((N + kBN - 1) / kBN, (Q + kBQ - 1) / kBQ);
        apex_bounds_batch_kernel<T><<<grid, kBN, smem, (cudaStream_t)stream>>>(
            table, N, n, queries, Q, qw, dims - 1, lwb, upb);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_apex_bounds_batch_f32(const float* table, int N, int n, const float* queries,
                                           int Q, int qw, int dims, float* lwb, float* upb,
                                           void* stream) {
    return launch<float>(table, N, n, queries, Q, qw, dims, lwb, upb, stream);
}

extern "C" int repro_apex_bounds_batch_f64(const double* table, int N, int n,
                                           const double* queries, int Q, int qw, int dims,
                                           double* lwb, double* upb, void* stream) {
    return launch<double>(table, N, n, queries, Q, qw, dims, lwb, upb, stream);
}
