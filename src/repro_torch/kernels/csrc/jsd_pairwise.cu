// K5: pairwise sqrt-Jensen-Shannon distance, in bits, between the rows of two
// raw nonnegative blocks X (Q, d) and Y (P, d), each row L1-normalised here:
//   x^_qj = x_qj / max(sum_j x_qj, 1e-12)   (y^ likewise)
//   out[q, p] = sqrt(clip((hx_q / 2 + hy_p / 2 - sum_j xlogx((x^_qj + y^_pj) / 2)) / ln 2, 0, 1))
//   xlogx(v) = v log v for v > 1e-12, else 0;  hx_q = sum_j xlogx(x^_qj), hy_p likewise.
//
// Replaces the TPU kernel src/repro/kernels/jsd_distance.py::jsd_pairwise_pallas
// (whose wrapper normalises the rows and computes hx and hy outside the
// Pallas kernel).
//
// Bound on this card: operations.  Every (pair, coordinate) takes one IEEE
// log (a software routine of ~28 FP64 instructions on its fast path) plus ~4
// operations, against one read of each input coordinate.  But most calls on
// the main path are small: the refinement evaluates one query against <= 256
// rows, so a call is bound by its latency (launches, and the serial chain of
// d logs a single thread would run), not by the card's FP64 rate.
//
// Design: one launch per call does everything (row sums, division, both row
// entropies, cross term); the wrapper only allocates the output.  The
// launch code (ops.jsd_plan) picks one of two plans from (Q, P, d):
//   * split plan (few pairs): `lanes` lanes (a power of two <= 32) share one
//     pair.  Lane l takes the coordinates j = l, l + lanes, ... and a fixed
//     xor-shuffle tree sums the lanes' partials.  Each lane group sums both
//     rows, normalises, and accumulates hx, hy and the cross term with the
//     same split and the same tree, so a row paired with itself (x^ = y^,
//     m = x^ exactly) gives cross = hx = hy and exactly 0.  A 1 x 256 call
//     spreads over 64 blocks and each serial log chain is 3 * d / lanes long.
//   * tile plan (many pairs, e.g. the 1M x 20 build): a block of 256 threads
//     takes bq X rows x bp Y rows (bq, bp <= 128, <= 4 pairs per thread, so
//     each thread runs up to 4 independent log chains).  A warp per row sums
//     the tile's rows (one fixed 32-lane tree for X and Y rows alike); then,
//     for each 8-column chunk of d, the block stages the normalised chunk and
//     its xlogx values in shared memory (the tile's entropy logs spread over
//     all threads), one thread per row adds the chunk's xlogx values to its
//     row entropy in column order, and each thread adds its pairs' cross terms
//     in the same column order.  So again cross = hx = hy for a row against
//     itself.  d has no cap (the TPU kernel's d <= 512 was a VMEM budget).
// xlogx takes log(1) = 0 for v <= 1e-12 instead of branching, so the log
// chains stay straight-line code the compiler can interleave.
#include <math.h>

#include "tile_math.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kSplitThreads = 128;
constexpr int kMaxTileRows = 128;   // bq and bp of the tile plan
constexpr int kMaxPPT = 4;          // pairs per thread of the tile plan
constexpr int kDC = 8;              // columns per staged chunk
constexpr int kSC = kDC + 1;        // odd chunk stride
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float op_log(float v) { return logf(v); }
__device__ __forceinline__ double op_log(double v) { return log(v); }
__device__ __forceinline__ float op_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double op_div(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ __forceinline__ T xlogx(T v) {
    return op_mul(v, op_log(v > T(1e-12) ? v : T(1)));
}

template <typename T>
__device__ __forceinline__ T clamp_sum(T s) {
    return s > T(1e-12) ? s : T(1e-12);
}

// Sum over aligned groups of `lanes` lanes; every lane of a group gets the
// same bits (each level adds the same two values in either order).
template <typename T>
__device__ __forceinline__ T group_sum(T v, int lanes) {
    for (int off = lanes >> 1; off > 0; off >>= 1) v = op_add(v, __shfl_xor_sync(kFull, v, off));
    return v;
}

template <typename T>
__device__ __forceinline__ T finish(T hx, T hy, T cross) {
    const T nats = op_sub(op_add(op_mul(T(0.5), hx), op_mul(T(0.5), hy)), cross);
    T bits = op_div(nats, T(0.6931471805599453));
    bits = bits < T(0) ? T(0) : (bits > T(1) ? T(1) : bits);
    return op_sqrt(bits);
}

template <typename T>
__global__ void jsd_split_kernel(const T* __restrict__ X, int Q, const T* __restrict__ Y, int P,
                                 int d, int lanes, T* __restrict__ out) {
    const int lane = threadIdx.x & (lanes - 1);
    const long long g = (long long)blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
    const bool live = g < (long long)Q * P;
    const int q = live ? (int)(g / P) : 0;
    const int p = live ? (int)(g % P) : 0;
    const T* x = X + (size_t)q * d;
    const T* y = Y + (size_t)p * d;
    T sx = T(0), sy = T(0);
    for (int j = lane; j < d; j += lanes) {
        sx = op_add(sx, x[j]);
        sy = op_add(sy, y[j]);
    }
    sx = clamp_sum(group_sum(sx, lanes));
    sy = clamp_sum(group_sum(sy, lanes));
    T hx = T(0), hy = T(0), cross = T(0);
    for (int j = lane; j < d; j += lanes) {
        const T a = op_div(x[j], sx);
        const T b = op_div(y[j], sy);
        hx = op_add(hx, xlogx(a));
        hy = op_add(hy, xlogx(b));
        cross = op_add(cross, xlogx(op_mul(T(0.5), op_add(a, b))));
    }
    hx = group_sum(hx, lanes);
    hy = group_sum(hy, lanes);
    cross = group_sum(cross, lanes);
    if (live && lane == 0) out[(size_t)q * P + p] = finish(hx, hy, cross);
}

template <typename T>
__global__ void jsd_tile_kernel(const T* __restrict__ X, int Q, const T* __restrict__ Y, int P,
                                int d, int bq, int bp, int p_tiles, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int R = bq + bp;             // tile rows: X rows, then Y rows
    T* xs = reinterpret_cast<T*>(smem_raw);  // R * kSC normalised chunk
    T* hs = xs + R * kSC;                    // R * kSC its xlogx values
    T* rs = hs + R * kSC;                    // R clamped row sums
    T* rh = rs + R;                          // R row entropies
    const int q0 = (blockIdx.x / p_tiles) * bq;
    const int p0 = (blockIdx.x % p_tiles) * bp;
    const int tid = threadIdx.x;
    // row r of the tile, or nullptr past the end of X or Y
    auto row_ptr = [&](int r) -> const T* {
        if (r < bq) return q0 + r < Q ? X + (size_t)(q0 + r) * d : nullptr;
        return p0 + r - bq < P ? Y + (size_t)(p0 + r - bq) * d : nullptr;
    };

    const int lane = tid & 31;
    for (int r = tid >> 5; r < R; r += kTileThreads / 32) {
        const T* row = row_ptr(r);
        T s = T(0);
        if (row != nullptr)
            for (int j = lane; j < d; j += 32) s = op_add(s, row[j]);
        s = group_sum(s, 32);
        if (lane == 0) {
            rs[r] = clamp_sum(s);
            rh[r] = T(0);
        }
    }
    __syncthreads();

    const int np = bq * bp;
    int xo[kMaxPPT], yo[kMaxPPT];
#pragma unroll
    for (int i = 0; i < kMaxPPT; ++i) {
        const int e = tid + kTileThreads * i;
        const int ql = e < np ? e / bp : 0;
        const int pl = e < np ? e % bp : 0;
        xo[i] = ql * kSC;
        yo[i] = (bq + pl) * kSC;
    }
    T acc[kMaxPPT];
#pragma unroll
    for (int i = 0; i < kMaxPPT; ++i) acc[i] = T(0);

    for (int c = 0; c < d; c += kDC) {
        const int w = min(kDC, d - c);
        for (int e = tid; e < R * kDC; e += kTileThreads) {
            const int r = e / kDC, j = e % kDC;
            const T* row = row_ptr(r);
            const T v = (row != nullptr && j < w) ? op_div(row[c + j], rs[r]) : T(0);
            xs[r * kSC + j] = v;
            hs[r * kSC + j] = xlogx(v);
        }
        __syncthreads();
        for (int r = tid; r < R; r += kTileThreads) {
            T h = rh[r];
            for (int j = 0; j < w; ++j) h = op_add(h, hs[r * kSC + j]);
            rh[r] = h;
        }
        for (int j = 0; j < w; ++j) {
#pragma unroll
            for (int i = 0; i < kMaxPPT; ++i)
                acc[i] = op_add(acc[i], xlogx(op_mul(T(0.5), op_add(xs[xo[i] + j], xs[yo[i] + j]))));
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kMaxPPT; ++i) {
        const int e = tid + kTileThreads * i;
        if (e >= np) continue;
        const int ql = e / bp, pl = e % bp;
        const int q = q0 + ql, p = p0 + pl;
        if (q < Q && p < P) out[(size_t)q * P + p] = finish(rh[ql], rh[bq + pl], acc[i]);
    }
}

template <typename T>
int launch(const T* X, int Q, const T* Y, int P, int d, int lanes, int bq, int bp, T* out,
           void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (Q <= 0 || P <= 0) return (int)cudaGetLastError();
    if (d < 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    if (lanes > 1) {
        const long long blocks = ((long long)Q * P * lanes + kSplitThreads - 1) / kSplitThreads;
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
        jsd_split_kernel<T><<<(unsigned)blocks, kSplitThreads, 0, st>>>(X, Q, Y, P, d, lanes, out);
        return (int)cudaGetLastError();
    }
    if (bq < 1 || bp < 1 || bq > kMaxTileRows || bp > kMaxTileRows ||
        bq * bp > kTileThreads * kMaxPPT)
        return (int)cudaErrorInvalidValue;
    const int p_tiles = (P + bp - 1) / bp;
    const long long blocks = (long long)((Q + bq - 1) / bq) * p_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = sizeof(T) * (size_t)(bq + bp) * (2 * kSC + 2);
    jsd_tile_kernel<T><<<(unsigned)blocks, kTileThreads, smem, st>>>(X, Q, Y, P, d, bq, bp,
                                                                      p_tiles, out);
    return (int)cudaGetLastError();
}

}  // namespace

// lanes > 1: the split plan (bq, bp unused); lanes == 1: the tile plan.
extern "C" int repro_jsd_pairwise_f32(const float* X, int Q, const float* Y, int P, int d,
                                      int lanes, int bq, int bp, float* out, void* stream) {
    return launch<float>(X, Q, Y, P, d, lanes, bq, bp, out, stream);
}

extern "C" int repro_jsd_pairwise_f64(const double* X, int Q, const double* Y, int P, int d,
                                      int lanes, int bq, int bp, double* out, void* stream) {
    return launch<double>(X, Q, Y, P, d, lanes, bq, bp, out, stream);
}
