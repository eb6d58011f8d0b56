// K1: two-sided bounds of a (Q, qw) block of query apexes against the
// (N, n) apex table, in GEMM form, with optional dims=k truncation.
//
// Replaces the TPU kernel
// src/repro/kernels/apex_bounds_batch.py::apex_bounds_batch_pallas.
// Bound on this card: bytes.  The two (Q, N) outputs dominate (8 bytes per
// pair in f32) against ~2(k-1) + 12 operations per pair.
// Two plans; the wrapper runs the stream plan at every Q (on an NVIDIA H100
// 80GB HBM3 at 700 W it beat the tile plan at every Q measured, 1 to 1024:
// PERF.md), and the tile plan only when its caller forces it:
//   * stream (the index's per-query overflow routes run Q = 1): read the
//     table once and write the (Q, N) outputs.  One thread per row, no
//     shared-memory staging of rows: the row goes straight into registers,
//     as 16-byte vector loads when the row width is a compile-time 16-byte
//     multiple and the base is aligned (n = 20 f32: five float4), else scalar
//     loads; a block holds up to kStreamChunkQ queries and their row terms in
//     shared memory, read as broadcasts; each thread writes its row's outputs,
//     so consecutive threads write consecutive addresses.  A larger Q is cut
//     into chunks of kStreamChunkQ queries; the chunk index varies fastest
//     over the blocks, so the chunks of one row block run together and share
//     its rows in L2.  A chunk's shared memory, kStreamChunkQ * (qw + 2)
//     values, is less than the tile plan's kBN * (n + 2), so the stream plan
//     launches wherever the tile plan does.  n is a template parameter for the
//     widths the index uses (the compiler keeps the row in registers and
//     unrolls the i loops), with a runtime-n fallback that reads the row from
//     global memory.
//   * tile (the first design, kept to be timed against and as the bit
//     reference of the stream plan's tests): a 2-D grid of (table tile x
//     query tile).  The block stages its kBN table rows (coalesced) and kBQ
//     query rows in shared memory, computes each row's head norm and folded
//     altitude once, then every thread takes one row against the kBQ
//     queries, so each output row of the tile is written by consecutive
//     threads.
// Both use row_terms() / pair_bounds() of tile_math.cuh in the same order
// (sums in ascending i with op_fma), so their outputs are bit-equal to each
// other and to the selection epilogues K2/K3.  No tensor cores: an f32 mma
// would be TF32 and break the soundness slack.
#include "tile_math.cuh"

namespace {

// queries per block of the stream plan (a larger Q takes several chunks)
constexpr int kStreamChunkQ = 64;
constexpr int kStreamThreads = 256;

// request more than the default 48 KiB of dynamic shared memory where a
// block needs it
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One row per thread.  NW > 0: the row width n == NW at compile time, held
// in registers (16-byte loads when `vec`); NW == 0: any n, read from global.
template <typename T, int NW>
__global__ void apex_bounds_stream_kernel(const T* __restrict__ table, int N, int n,
                                          const T* __restrict__ queries, int Q, int qw, int hd,
                                          bool vec, T* __restrict__ lwb, T* __restrict__ upb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int chunks = (Q + kStreamChunkQ - 1) / kStreamChunkQ;
    const int q0 = (int)(blockIdx.x % chunks) * kStreamChunkQ;
    const int nq = min(kStreamChunkQ, Q - q0);
    T* qs = reinterpret_cast<T*>(smem_raw);  // nq * qw
    T* q2s = qs + nq * qw;                   // nq
    T* qas = q2s + nq;                       // nq
    for (int e = threadIdx.x; e < nq * qw; e += blockDim.x) qs[e] = queries[(size_t)q0 * qw + e];
    __syncthreads();
    if (threadIdx.x < nq) row_terms(qs + threadIdx.x * qw, hd, qw, q2s[threadIdx.x], qas[threadIdx.x]);
    __syncthreads();
    const int row = (int)(blockIdx.x / chunks) * blockDim.x + threadIdx.x;
    if (row >= N) return;
    lwb += (size_t)q0 * N;
    upb += (size_t)q0 * N;
    const T* x = table + (size_t)row * n;
    if constexpr (NW > 0) {
        T xr[NW];
        load_row(x, vec, xr);
        T x2, xa;
        row_terms_reg(xr, hd, x2, xa);
        for (int j = 0; j < nq; ++j) {
            const T* q = qs + j * qw;
            T dot = T(0);
#pragma unroll
            for (int i = 0; i < NW; ++i)
                if (i < hd) dot = op_fma(q[i], xr[i], dot);
            T lsq, usq;
            bound_squares(q2s[j], qas[j], x2, xa, dot, lsq, usq);
            lwb[(size_t)j * N + row] = op_sqrt(lsq);
            upb[(size_t)j * N + row] = op_sqrt(usq);
        }
    } else {
        T x2, xa;
        row_terms(x, hd, n, x2, xa);
        for (int j = 0; j < nq; ++j) {
            T l, u;
            pair_bounds(qs + j * qw, q2s[j], qas[j], x, x2, xa, hd, l, u);
            lwb[(size_t)j * N + row] = l;
            upb[(size_t)j * N + row] = u;
        }
    }
}

template <typename T, int NW>
cudaError_t launch_stream_n(const T* table, int N, int n, const T* queries, int Q, int qw, int hd,
                            bool vec, T* lwb, T* upb, cudaStream_t st) {
    const int nq = Q < kStreamChunkQ ? Q : kStreamChunkQ;
    const size_t smem = sizeof(T) * (size_t)nq * (qw + 2);
    const cudaError_t e = allow_smem(apex_bounds_stream_kernel<T, NW>, smem);
    if (e != cudaSuccess) return e;
    const size_t blocks = (size_t)((N + kStreamThreads - 1) / kStreamThreads) *
                          ((Q + kStreamChunkQ - 1) / kStreamChunkQ);
    if (blocks > 0x7fffffffu) return cudaErrorInvalidValue;
    apex_bounds_stream_kernel<T, NW><<<(unsigned)blocks, kStreamThreads, smem, st>>>(
        table, N, n, queries, Q, qw, hd, vec, lwb, upb);
    return cudaSuccess;
}

template <typename T>
cudaError_t launch_stream(const T* table, int N, int n, const T* queries, int Q, int qw, int hd,
                          T* lwb, T* upb, cudaStream_t st) {
    const bool vec = reinterpret_cast<uintptr_t>(table) % 16 == 0;
    switch (n) {
        case 10: return launch_stream_n<T, 10>(table, N, n, queries, Q, qw, hd, vec, lwb, upb, st);
        case 16: return launch_stream_n<T, 16>(table, N, n, queries, Q, qw, hd, vec, lwb, upb, st);
        case 20: return launch_stream_n<T, 20>(table, N, n, queries, Q, qw, hd, vec, lwb, upb, st);
        case 32: return launch_stream_n<T, 32>(table, N, n, queries, Q, qw, hd, vec, lwb, upb, st);
        default: return launch_stream_n<T, 0>(table, N, n, queries, Q, qw, hd, vec, lwb, upb, st);
    }
}

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

// plan: 0 tile, 1 stream
template <typename T>
int launch(const T* table, int N, int n, const T* queries, int Q, int qw, int dims, int plan,
           T* lwb, T* upb, void* stream) {
    if (plan < 0 || plan > 1) return (int)cudaErrorInvalidValue;
    if (N == 0 || Q == 0) return (int)cudaGetLastError();
    cudaError_t e;
    if (plan == 1) {
        e = launch_stream<T>(table, N, n, queries, Q, qw, dims - 1, lwb, upb, (cudaStream_t)stream);
    } else {
        const size_t smem =
            sizeof(T) * ((size_t)kBN * (odd_stride(n) + 2) + (size_t)kBQ * (odd_stride(qw) + 2));
        e = allow_smem(apex_bounds_batch_kernel<T>, smem);
        if (e == cudaSuccess) {
            dim3 grid((N + kBN - 1) / kBN, (Q + kBQ - 1) / kBQ);
            apex_bounds_batch_kernel<T><<<grid, kBN, smem, (cudaStream_t)stream>>>(
                table, N, n, queries, Q, qw, dims - 1, lwb, upb);
        }
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// plan: 0 tile, 1 stream
extern "C" int repro_apex_bounds_batch_f32(const float* table, int N, int n, const float* queries,
                                           int Q, int qw, int dims, int plan, float* lwb,
                                           float* upb, void* stream) {
    return launch<float>(table, N, n, queries, Q, qw, dims, plan, lwb, upb, stream);
}

extern "C" int repro_apex_bounds_batch_f64(const double* table, int N, int n,
                                           const double* queries, int Q, int qw, int dims,
                                           int plan, double* lwb, double* upb, void* stream) {
    return launch<double>(table, N, n, queries, Q, qw, dims, plan, lwb, upb, stream);
}
