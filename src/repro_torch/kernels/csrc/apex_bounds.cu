// K6: two-sided bounds of ONE query apex against the (N, n) apex table.
//
// Replaces the TPU kernel src/repro/kernels/apex_bounds.py::apex_bounds_pallas.
// Bound on this card: bytes.  It reads the table once (N * n elements) and
// writes two (N,) outputs, against ~3n operations per row.
// Design: one thread per row, difference form sum_i (x_i - q_i)^2 as the TPU
// kernel computes it; the query sits in shared memory; no tiling beyond the
// rows a warp reads together.  f32 and f64.
#include "tile_math.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void apex_bounds_kernel(const T* __restrict__ table, int N, int n,
                                   const T* __restrict__ query, T* __restrict__ lwb,
                                   T* __restrict__ upb) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* q = reinterpret_cast<T*>(smem_raw);
    for (int i = threadIdx.x; i < n; i += blockDim.x) q[i] = query[i];
    __syncthreads();
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= N) return;
    const T* x = table + (size_t)row * n;
    T head = T(0);
    for (int i = 0; i < n - 1; ++i) {
        T d = op_sub(x[i], q[i]);
        head = op_fma(d, d, head);
    }
    const T dm = op_sub(x[n - 1], q[n - 1]);
    const T dp = op_add(x[n - 1], q[n - 1]);
    lwb[row] = op_sqrt(clamp0(op_add(head, op_mul(dm, dm))));
    upb[row] = op_sqrt(clamp0(op_add(head, op_mul(dp, dp))));
}

template <typename T>
int launch(const T* table, int N, int n, const T* query, T* lwb, T* upb, void* stream) {
    if (N > 0) {
        const int blocks = (N + kThreads - 1) / kThreads;
        apex_bounds_kernel<T><<<blocks, kThreads, n * sizeof(T), (cudaStream_t)stream>>>(
            table, N, n, query, lwb, upb);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_apex_bounds_f32(const float* table, int N, int n, const float* query,
                                     float* lwb, float* upb, void* stream) {
    return launch<float>(table, N, n, query, lwb, upb, stream);
}

extern "C" int repro_apex_bounds_f64(const double* table, int N, int n, const double* query,
                                     double* lwb, double* upb, void* stream) {
    return launch<double>(table, N, n, query, lwb, upb, stream);
}
