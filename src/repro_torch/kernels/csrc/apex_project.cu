// K4: apexes of a (B, n) block of pivot-distance rows, the batch n-simplex
// projection in GEMM form.  Per row, with d the row's n pivot distances:
//   g_j = (d_0^2 + sq_norms_j - d_{j+1}^2) / 2           (j < n - 1)
//   w   = g . Linv^T,  altitude = sqrt(max(d_0^2 - |w|^2, 0))
// and the apex is (w, altitude).
//
// Replaces the TPU kernel src/repro/kernels/apex_project.py::apex_project_pallas.
// Bound on this card: bytes.  It reads B * n distances and writes B * n apex
// coordinates once, against ~2(n-1)^2 operations per row: at the 1M x 20 f64
// table build that is ~0.1 ms of HBM traffic against ~0.02 ms of FP64 work.
// Design: one thread per row.  Linv and sq_norms are staged once per block in
// shared memory (19 x 19 f64 = 2.9 KB at n = 20) and read as broadcasts.  The
// block's kRows distance rows are staged coalesced; each thread turns its own
// row into g in place, accumulates w and |w|^2 with explicitly rounded FMAs
// into a second shared tile, and the tile is written back coalesced.  f64
// operands accumulate in f64 (the TPU kernel accumulates f64 operands in
// f32).  The TPU kernel's 128-lane padding and its sq_norms == 0 lane mask
// are layout artifacts and are not carried over.
#include "tile_math.cuh"

namespace {

constexpr int kRows = 64;  // distance rows per block (= threads per block)

// odd row stride in shared memory keeps per-thread row reads conflict-free
__host__ __device__ inline int odd_stride(int w) { return w | 1; }

template <typename T>
__global__ void apex_project_kernel(const T* __restrict__ dist, int B, int n,
                                    const T* __restrict__ linv, const T* __restrict__ sq_norms,
                                    T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = n - 1;
    const int s = odd_stride(n);
    T* L = reinterpret_cast<T*>(smem_raw);  // h * h, row-major Linv
    T* sq = L + h * h;                      // h
    T* ds = sq + h;                         // kRows * s: distances, then g in place
    T* os = ds + kRows * s;                 // kRows * s: apexes

    for (int e = threadIdx.x; e < h * h; e += blockDim.x) L[e] = linv[e];
    for (int e = threadIdx.x; e < h; e += blockDim.x) sq[e] = sq_norms[e];
    const int row0 = blockIdx.x * kRows;
    const int rows = min(kRows, B - row0);
    for (int e = threadIdx.x; e < rows * n; e += blockDim.x)
        ds[(e / n) * s + (e % n)] = dist[(size_t)row0 * n + e];
    __syncthreads();

    const int r = threadIdx.x;
    if (r < rows) {
        T* d = ds + r * s;
        T* o = os + r * s;
        const T d1sq = op_mul(d[0], d[0]);
        // g_j overwrites d_{j+1}, which nothing else reads
        for (int j = 0; j < h; ++j)
            d[j + 1] = op_mul(T(0.5), op_sub(op_add(d1sq, sq[j]), op_mul(d[j + 1], d[j + 1])));
        const T* g = d + 1;
        T w2 = T(0);
        for (int i = 0; i < h; ++i) {
            const T* Li = L + i * h;
            T acc = T(0);
            for (int j = 0; j < h; ++j) acc = op_fma(g[j], Li[j], acc);
            o[i] = acc;
            w2 = op_fma(acc, acc, w2);
        }
        o[h] = op_sqrt(clamp0(op_sub(d1sq, w2)));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * n; e += blockDim.x)
        out[(size_t)row0 * n + e] = os[(e / n) * s + (e % n)];
}

template <typename T>
int launch(const T* dist, int B, int n, const T* linv, const T* sq_norms, T* out, void* stream) {
    if (B > 0) {
        const int h = n - 1;
        const size_t smem = sizeof(T) * ((size_t)h * h + h + 2 * (size_t)kRows * odd_stride(n));
        if (smem > 48 * 1024)
            cudaFuncSetAttribute(apex_project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        const int blocks = (B + kRows - 1) / kRows;
        apex_project_kernel<T><<<blocks, kRows, smem, (cudaStream_t)stream>>>(dist, B, n, linv,
                                                                             sq_norms, out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_apex_project_f32(const float* dist, int B, int n, const float* linv,
                                      const float* sq_norms, float* out, void* stream) {
    return launch<float>(dist, B, n, linv, sq_norms, out, stream);
}

extern "C" int repro_apex_project_f64(const double* dist, int B, int n, const double* linv,
                                      const double* sq_norms, double* out, void* stream) {
    return launch<double>(dist, B, n, linv, sq_norms, out, stream);
}
