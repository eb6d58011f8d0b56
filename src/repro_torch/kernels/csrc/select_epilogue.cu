// K2 and K3: the fused selection epilogues of the (Q, N) bound scan.
//
// Replace the TPU kernels in src/repro/kernels/select_epilogue.py:
//   K2 apex_topk_pallas      — per query, the k rows with the smallest
//                              (key, id), key in {lwb, upb, mid};
//   K3 apex_threshold_pallas — per query, the cap smallest (lwb, id) among
//                              rows with lwb <= t[q] (f32 compare), plus the
//                              exact count of such rows, even when it
//                              overflows cap.
// Bound on this card: operations.  Both read the f32 table once
// (N * n * 4 bytes) and do ~2(k-1) + 12 operations per (query, row) pair;
// only O(Q * width) triples leave the kernel.
//
// Design.  The TPU carries one running selection across its sequential grid;
// CUDA blocks run in no order, so the scan is split into per-slice partial
// selections and a second kernel merges them:
//   * select_partial_kernel: grid (slices, Q).  A block scans its slice of
//     rows for one query, computing each pair with pair_bounds() (the same
//     function as K1, so the bounds are bit-identical) and packing the key
//     as (float_bits(key) << 32) | id with the sign bit cleared: every key is
//     >= 0, so the packed uint64 orders exactly like (key, id) and a -0.0
//     cannot pack as the largest key.  Keys below the running width-th best
//     are appended to a shared candidate buffer; a full buffer is bitonic
//     sorted and merged into the sorted running selection (elementwise min
//     against the reversed candidates, then a bitonic merge).  K3 also counts
//     its passing rows.
//   * select_merge_kernel: grid (Q).  Merges the slices' sorted selections
//     the same way, sums the counts in slice order, and writes ids with
//     their lwb/upb recomputed by pair_bounds() from the table row.
// Masked rows (rowmask == 0) never enter a selection or a count; empty slots
// come out as the sentinel id 2^31 - 1 with +inf bounds.  The output does not
// depend on block order: a selection of distinct packed keys is unique.
//
// Largest selection width held: kMaxWidth = 4096 (shared memory: running
// selection + candidate buffer of 4096 uint64 each, 64 KB).  Wider requests
// are refused here; the index routes them to per-query K1 plus exact
// refinement, as the reference does on capacity overflow.
#include "tile_math.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kMinCand = 1024;   // candidate buffer length floor
constexpr int kMaxWidth = 4096;
constexpr u64 kEmpty = ~0ull;
constexpr int kSentinelId = 0x7fffffff;

enum Mode { kLwb = 0, kUpb = 1, kMid = 2, kThreshold = 3 };

__device__ __forceinline__ u64 pack_key(float key, int id) {
    const unsigned int bits = __float_as_uint(key) & 0x7fffffffu;
    return ((u64)bits << 32) | (unsigned int)id;
}

// One compare-exchange network stage over a[0:len) (len a power of two).
__device__ __forceinline__ void bitonic_stage(u64* a, int len, int size, int stride) {
    for (int i = threadIdx.x; i < len / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 x = a[lo], y = a[hi];
        if ((x > y) == up) {
            a[lo] = y;
            a[hi] = x;
        }
    }
    __syncthreads();
}

__device__ void bitonic_sort(u64* a, int len) {
    __syncthreads();
    for (int size = 2; size <= len; size <<= 1)
        for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_stage(a, len, size, stride);
}

// Sort a bitonic sequence a[0:len) ascending.
__device__ void bitonic_merge(u64* a, int len) {
    __syncthreads();
    for (int stride = len >> 1; stride > 0; stride >>= 1) bitonic_stage(a, len, len, stride);
}

// run[0:wp) sorted ascending, cand[0:wp) sorted ascending: keep the wp
// smallest of the union in run, sorted.
__device__ void merge_sorted(u64* run, const u64* cand, int wp) {
    __syncthreads();
    for (int i = threadIdx.x; i < wp; i += blockDim.x) {
        const u64 v = cand[wp - 1 - i];
        if (v < run[i]) run[i] = v;
    }
    bitonic_merge(run, wp);
}

// Fold cand[0:nc) (unsorted) into the sorted running selection run[0:wp).
__device__ void flush(u64* run, u64* cand, int nc, int wp, int tl) {
    for (int i = nc + threadIdx.x; i < tl; i += blockDim.x) cand[i] = kEmpty;
    bitonic_sort(cand, tl);
    merge_sorted(run, cand, wp);
}

template <int MODE>
__global__ void select_partial_kernel(const float* __restrict__ table, int N, int n,
                                      const float* __restrict__ queries, int qw, int hd,
                                      const uint8_t* __restrict__ rowmask,
                                      const float* __restrict__ thresholds, int width, int wp,
                                      int tl, int slice_rows, u64* __restrict__ part_keys,
                                      int* __restrict__ part_counts) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    u64* run = reinterpret_cast<u64*>(smem_raw);  // wp
    u64* cand = run + wp;                          // tl
    float* qs = reinterpret_cast<float*>(cand + tl);
    __shared__ int ncand;
    __shared__ int count;

    const int s = blockIdx.x;
    const int S = gridDim.x;
    const int q = blockIdx.y;
    for (int i = threadIdx.x; i < qw; i += blockDim.x) qs[i] = queries[(size_t)q * qw + i];
    for (int i = threadIdx.x; i < wp; i += blockDim.x) run[i] = kEmpty;
    if (threadIdx.x == 0) {
        ncand = 0;
        count = 0;
    }
    __syncthreads();
    float q2, qa;
    row_terms(qs, hd, qw, q2, qa);
    const float t = MODE == kThreshold ? thresholds[q] : 0.0f;

    const int r0 = s * slice_rows;
    const int r1 = min(N, r0 + slice_rows);
    int my_count = 0;
    u64 thr = kEmpty;  // the running width-th best key: only smaller keys matter
    for (int base = r0; base < r1; base += blockDim.x) {
        const int row = base + threadIdx.x;
        if (row < r1 && (rowmask == nullptr || rowmask[row])) {
            const float* x = table + (size_t)row * n;
            float x2, xa, l, u;
            row_terms(x, hd, n, x2, xa);
            pair_bounds(qs, q2, qa, x, x2, xa, hd, l, u);
            bool pass = true;
            float key;
            if (MODE == kThreshold) {
                pass = l <= t;
                my_count += pass;
                key = l;
            } else {
                key = MODE == kLwb ? l : (MODE == kUpb ? u : op_mul(0.5f, op_add(l, u)));
            }
            if (pass) {
                const u64 pk = pack_key(key, row);
                if (pk < thr) cand[atomicAdd(&ncand, 1)] = pk;
            }
        }
        __syncthreads();
        const int nc = ncand;
        if (nc > tl - (int)blockDim.x) {
            flush(run, cand, nc, wp, tl);
            if (threadIdx.x == 0) ncand = 0;
        }
        thr = run[width - 1];
        __syncthreads();
    }
    const int nc = ncand;
    if (nc > 0) flush(run, cand, nc, wp, tl);
    atomicAdd(&count, my_count);
    __syncthreads();
    u64* out = part_keys + ((size_t)q * S + s) * wp;
    for (int i = threadIdx.x; i < wp; i += blockDim.x) out[i] = run[i];
    if (threadIdx.x == 0 && part_counts != nullptr) part_counts[(size_t)q * S + s] = count;
}

__global__ void select_merge_kernel(const float* __restrict__ table, int n,
                                    const float* __restrict__ queries, int qw, int hd,
                                    const u64* __restrict__ part_keys,
                                    const int* __restrict__ part_counts, int S, int width, int wp,
                                    int* __restrict__ ids, float* __restrict__ lwb,
                                    float* __restrict__ upb, int* __restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    u64* run = reinterpret_cast<u64*>(smem_raw);  // wp
    u64* cand = run + wp;                          // wp
    float* qs = reinterpret_cast<float*>(cand + wp);
    const int q = blockIdx.x;
    const u64* part = part_keys + (size_t)q * S * wp;
    for (int i = threadIdx.x; i < wp; i += blockDim.x) run[i] = part[i];
    for (int i = threadIdx.x; i < qw; i += blockDim.x) qs[i] = queries[(size_t)q * qw + i];
    for (int s = 1; s < S; ++s) {
        __syncthreads();
        for (int i = threadIdx.x; i < wp; i += blockDim.x) cand[i] = part[(size_t)s * wp + i];
        merge_sorted(run, cand, wp);
    }
    __syncthreads();
    float q2, qa;
    row_terms(qs, hd, qw, q2, qa);
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
        const u64 key = run[i];
        const size_t o = (size_t)q * width + i;
        if (key == kEmpty) {
            ids[o] = kSentinelId;
            lwb[o] = __int_as_float(0x7f800000);
            upb[o] = __int_as_float(0x7f800000);
        } else {
            const int row = (int)(key & 0xffffffffull);
            const float* x = table + (size_t)row * n;
            float x2, xa, l, u;
            row_terms(x, hd, n, x2, xa);
            pair_bounds(qs, q2, qa, x, x2, xa, hd, l, u);
            ids[o] = row;
            lwb[o] = l;
            upb[o] = u;
        }
    }
    if (threadIdx.x == 0 && counts != nullptr) {
        int c = 0;
        for (int s = 0; s < S; ++s) c += part_counts[(size_t)q * S + s];
        counts[q] = c;
    }
}

int next_pow2(int w) {
    int p = 1;
    while (p < w) p <<= 1;
    return p;
}

template <int MODE>
int launch_partial(dim3 grid, size_t smem, cudaStream_t st, const float* table, int N, int n,
                   const float* queries, int qw, int hd, const uint8_t* rowmask,
                   const float* thresholds, int width, int wp, int tl, int slice_rows,
                   u64* part_keys, int* part_counts) {
    cudaFuncSetAttribute(select_partial_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    select_partial_kernel<MODE><<<grid, kThreads, smem, st>>>(table, N, n, queries, qw, hd,
                                                             rowmask, thresholds, width, wp, tl,
                                                             slice_rows, part_keys, part_counts);
    return (int)cudaGetLastError();
}

int run_select(int mode, const float* table, int N, int n, const float* queries, int Q, int qw,
               int dims, const uint8_t* rowmask, const float* thresholds, int width, int slices,
               u64* part_keys, int* part_counts, int* ids, float* lwb, float* upb, int* counts,
               void* stream) {
    if (width < 1 || width > kMaxWidth || width > N || slices < 1) return (int)cudaErrorInvalidValue;
    if (Q == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const int hd = dims - 1;
    const int wp = next_pow2(width);
    const int tl = wp > kMinCand ? wp : kMinCand;
    const int slice_rows = (N + slices - 1) / slices;
    const size_t q_bytes = ((size_t)qw * sizeof(float) + 15) / 16 * 16;
    const size_t smem = (size_t)(wp + tl) * sizeof(u64) + q_bytes;
    dim3 grid(slices, Q);
    int err = 0;
    switch (mode) {
        case kLwb: err = launch_partial<kLwb>(grid, smem, st, table, N, n, queries, qw, hd, rowmask, thresholds, width, wp, tl, slice_rows, part_keys, part_counts); break;
        case kUpb: err = launch_partial<kUpb>(grid, smem, st, table, N, n, queries, qw, hd, rowmask, thresholds, width, wp, tl, slice_rows, part_keys, part_counts); break;
        case kMid: err = launch_partial<kMid>(grid, smem, st, table, N, n, queries, qw, hd, rowmask, thresholds, width, wp, tl, slice_rows, part_keys, part_counts); break;
        case kThreshold: err = launch_partial<kThreshold>(grid, smem, st, table, N, n, queries, qw, hd, rowmask, thresholds, width, wp, tl, slice_rows, part_keys, part_counts); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != 0) return err;
    const size_t msmem = (size_t)2 * wp * sizeof(u64) + q_bytes;
    cudaFuncSetAttribute(select_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)msmem);
    select_merge_kernel<<<Q, kThreads, msmem, st>>>(table, n, queries, qw, hd, part_keys,
                                                    part_counts, slices, width, wp, ids, lwb, upb,
                                                    counts);
    return (int)cudaGetLastError();
}

}  // namespace

// K2.  key_mode: 0 lwb, 1 upb, 2 mid.  part_keys: (Q, slices, next_pow2(k)) scratch.
extern "C" int repro_apex_topk(const float* table, int N, int n, const float* queries, int Q,
                               int qw, int dims, const uint8_t* rowmask, int key_mode, int k,
                               int slices, unsigned long long* part_keys, int* ids, float* lwb,
                               float* upb, void* stream) {
    if (key_mode < kLwb || key_mode > kMid) return (int)cudaErrorInvalidValue;
    return run_select(key_mode, table, N, n, queries, Q, qw, dims, rowmask, nullptr, k, slices,
                      part_keys, nullptr, ids, lwb, upb, nullptr, stream);
}

// K3.  part_keys: (Q, slices, next_pow2(cap)); part_counts: (Q, slices).
extern "C" int repro_apex_threshold(const float* table, int N, int n, const float* queries, int Q,
                                    int qw, int dims, const uint8_t* rowmask,
                                    const float* thresholds, int cap, int slices,
                                    unsigned long long* part_keys, int* part_counts, int* ids,
                                    float* lwb, float* upb, int* counts, void* stream) {
    return run_select(kThreshold, table, N, n, queries, Q, qw, dims, rowmask, thresholds, cap,
                      slices, part_keys, part_counts, ids, lwb, upb, counts, stream);
}
