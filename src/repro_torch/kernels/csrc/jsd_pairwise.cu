// K5: pairwise sqrt-Jensen-Shannon distance, in bits, between the rows of two
// L1-normalised blocks X (Q, d) and Y (P, d):
//   out[q, p] = sqrt(clip((hx_q / 2 + hy_p / 2 - sum_j xlogx((x_qj + y_pj) / 2)) / ln 2, 0, 1))
//   xlogx(v) = v log v for v > 1e-12, else 0;  hx_q = sum_j xlogx(x_qj), hy_p likewise.
//
// Replaces the TPU kernel src/repro/kernels/jsd_distance.py::jsd_pairwise_pallas
// (whose wrapper computes hx and hy outside the Pallas kernel).
// Bound on this card: operations.  Every (pair, coordinate) takes one IEEE
// log, a software routine of FP64 (or FP32) instructions, plus ~4 operations,
// against one read of each input coordinate.
// Design: a first kernel sums each row's entropy with the same sequential
// loop and the same explicitly rounded operations as the pair loop, so a row
// paired with itself (m = x exactly) gives exactly 0.  The pair kernel gives
// each block of 256 threads a (bq x bp) tile of pairs, bp * bq = 256, with bp
// chosen per call from Q and P to waste the fewest threads (a (1, P)
// refinement call spreads over P, the (1M, 20) build over Q).  The block
// stages kDC-column chunks of its X and Y rows in shared memory and loops
// over d, so d has no cap (the TPU kernel's d <= 512 was a VMEM budget);
// each thread accumulates its pair's cross term in the operand dtype.
#include <math.h>

#include "tile_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDC = 16;  // columns per staged chunk

__device__ __forceinline__ float op_log(float v) { return logf(v); }
__device__ __forceinline__ double op_log(double v) { return log(v); }
__device__ __forceinline__ float op_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double op_div(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ __forceinline__ T xlogx(T v) {
    return v > T(1e-12) ? op_mul(v, op_log(v)) : T(0);
}

template <typename T>
__global__ void row_entropy_kernel(const T* __restrict__ X, int R, int d, T* __restrict__ h) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const T* x = X + (size_t)r * d;
    T acc = T(0);
    for (int j = 0; j < d; ++j) acc = op_add(acc, xlogx(x[j]));
    h[r] = acc;
}

template <typename T>
__global__ void jsd_pair_kernel(const T* __restrict__ X, int Q, const T* __restrict__ Y, int P,
                                int d, const T* __restrict__ hx, const T* __restrict__ hy, int bp,
                                int p_tiles, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr int sc = kDC + 1;  // odd chunk stride
    const int bq = kThreads / bp;
    T* xs = reinterpret_cast<T*>(smem_raw);  // bq * sc
    T* ys = xs + bq * sc;                    // bp * sc
    const int q0 = (blockIdx.x / p_tiles) * bq;
    const int p0 = (blockIdx.x % p_tiles) * bp;
    const int tq = threadIdx.x / bp;
    const int tp = threadIdx.x % bp;

    T acc = T(0);
    for (int c = 0; c < d; c += kDC) {
        const int w = min(kDC, d - c);
        for (int e = threadIdx.x; e < bq * kDC; e += kThreads) {
            const int r = e / kDC, j = e % kDC;
            xs[r * sc + j] = (q0 + r < Q && j < w) ? X[(size_t)(q0 + r) * d + c + j] : T(0);
        }
        for (int e = threadIdx.x; e < bp * kDC; e += kThreads) {
            const int r = e / kDC, j = e % kDC;
            ys[r * sc + j] = (p0 + r < P && j < w) ? Y[(size_t)(p0 + r) * d + c + j] : T(0);
        }
        __syncthreads();
        const T* xr = xs + tq * sc;
        const T* yr = ys + tp * sc;
        for (int j = 0; j < w; ++j) acc = op_add(acc, xlogx(op_mul(T(0.5), op_add(xr[j], yr[j]))));
        __syncthreads();
    }
    const int q = q0 + tq, p = p0 + tp;
    if (q < Q && p < P) {
        const T nats = op_sub(op_add(op_mul(T(0.5), hx[q]), op_mul(T(0.5), hy[p])), acc);
        T bits = op_div(nats, T(0.6931471805599453));
        bits = bits < T(0) ? T(0) : (bits > T(1) ? T(1) : bits);
        out[(size_t)q * P + p] = op_sqrt(bits);
    }
}

// bp (pairs along P per block, a power of two) that pads the fewest pairs
int pick_bp(int Q, int P) {
    long long best = -1;
    int bp_best = 1;
    for (int bp = 1; bp <= kThreads; bp *= 2) {
        const int bq = kThreads / bp;
        const long long cost =
            (long long)((Q + bq - 1) / bq) * bq * (long long)((P + bp - 1) / bp) * bp;
        if (best < 0 || cost < best) {
            best = cost;
            bp_best = bp;
        }
    }
    return bp_best;
}

template <typename T>
int launch(const T* X, int Q, const T* Y, int P, int d, T* hx, T* hy, T* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (Q <= 0 || P <= 0) return (int)cudaGetLastError();
    row_entropy_kernel<T><<<(Q + kThreads - 1) / kThreads, kThreads, 0, st>>>(X, Q, d, hx);
    int err = (int)cudaGetLastError();
    if (err) return err;
    row_entropy_kernel<T><<<(P + kThreads - 1) / kThreads, kThreads, 0, st>>>(Y, P, d, hy);
    err = (int)cudaGetLastError();
    if (err) return err;
    const int bp = pick_bp(Q, P);
    const int bq = kThreads / bp;
    const int p_tiles = (P + bp - 1) / bp;
    const long long blocks = (long long)((Q + bq - 1) / bq) * p_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const size_t smem = sizeof(T) * (size_t)(bq + bp) * (kDC + 1);
    jsd_pair_kernel<T><<<(unsigned)blocks, kThreads, smem, st>>>(X, Q, Y, P, d, hx, hy, bp,
                                                                  p_tiles, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_jsd_pairwise_f32(const float* X, int Q, const float* Y, int P, int d,
                                      float* hx, float* hy, float* out, void* stream) {
    return launch<float>(X, Q, Y, P, d, hx, hy, out, stream);
}

extern "C" int repro_jsd_pairwise_f64(const double* X, int Q, const double* Y, int P, int d,
                                      double* hx, double* hy, double* out, void* stream) {
    return launch<double>(X, Q, Y, P, d, hx, hy, out, stream);
}
