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
// (N * n * 4 bytes) and do ~2(dims-1) + 12 operations per (query, row) pair;
// only O(Q * width) triples leave the kernel.  What holds them back is the
// instruction stream per (query, row) pair and, with one query per block
// (the first design), re-reading the 80 MB table once per query: ~5 GB for a
// 64-query call, which the 50 MB L2 cannot hold.
//
// Design.  The TPU carries one running selection across its sequential grid;
// CUDA blocks run in no order, so the scan is split into per-slice partial
// selections and a second kernel merges them.  Selection state: per query a
// sorted running selection run[0:wp) (wp = next_pow2(width)) and an unsorted
// candidate buffer cand[0:tl).  Keys are packed as
// (float_bits(key) << 32) | id with the sign bit cleared: every key is >= 0,
// so the packed uint64 orders exactly like (key, id) and a -0.0 cannot pack
// as the largest key.  A key enters cand only if it is below the query's
// running width-th best; a full buffer is bitonic sorted and merged into run
// (elementwise min against the reversed candidates, then a bitonic merge).
//   * K2 with G > 1, topk_group_kernel: grid (query groups, slices); the
//     group index varies fastest, so the blocks of one slice run together and
//     share it in L2, and the table is read once per group of G queries, not
//     once per query.  G comes from ops.topk_plan:
//     G = min(32, Q, 64 KiB / ((wp + tl) * 8)) with tl = max(wp, 512), then
//     balanced over the groups; run_topk refuses a G outside that budget
//     (kGroupBytes, kMaxGroup, kMinCandGroup).  Before balancing that is
//     G = 15 at k <= 32, 14 at k <= 64, 12 at k <= 128, 10 at k <= 256, 8 at
//     k <= 512, 4 at k <= 1024, 2 at k <= 2048 and 1 above (at Q = 64 and
//     k = 10 or 64: 5 groups of 13).  Each thread takes one row of the slice at a time,
//     forms its row terms once and evaluates it against the group's queries
//     kGR = 16 at a time (8 for the mid key): the head dot products share
//     each x_i read and read the query coordinates as shared-memory float4
//     broadcasts.  Then a squared-domain pre-filter (sq_cut) drops, without
//     its two sqrts, every row that cannot beat the query's running
//     width-th best key; one warp vote skips the kGR slots when no lane has
//     a candidate.  Rows that pass
//     take bound_squares() and the sqrt, the same operations in the same
//     order as K1's pair_bounds(), so every kept key has K1's bits; a warp
//     appends its candidates with one shared atomic.  The first candidates
//     are folded as soon as they fill the selection, which sets a threshold
//     after one tile.
//   * K2 with G = 1 (one query, or k > 2048) and K3: select_partial_kernel,
//     grid (slices, Q), one query per block, the first design.  K3
//     also counts its passing rows.
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

// queries per register chunk of topk_group_kernel: 16, but 8 for the mid
// key, whose two squared bounds per slot cost registers (at 16 the kernel
// keeps fewer blocks on an SM and runs slower)
__host__ __device__ constexpr int group_regs(int mode) { return mode == kMid ? 8 : 16; }
// K2's group plan: a group's selection state, G * (wp + tl) * 8 bytes with
// tl = max(wp, kMinCandGroup), fits kGroupBytes, and G <= kMaxGroup.
// ops.topk_plan picks G under the same constants (_TOPK_MIN_CAND,
// _TOPK_GROUP_BYTES, _TOPK_MAX_GROUP; a CPU test holds them equal), and
// run_topk refuses a G that breaks them.
constexpr int kMinCandGroup = 512;  // candidate buffer length floor of K2
constexpr int kGroupBytes = 65536;  // 64 KiB
constexpr int kMaxGroup = 32;
constexpr unsigned kFull = 0xffffffffu;

// Append the lanes' passing keys to one candidate buffer with one shared
// atomic per warp.  Every lane of the warp must call it.
__device__ __forceinline__ void warp_append(bool pass, u64 pk, u64* cand, int* ncand) {
    const unsigned m = __ballot_sync(kFull, pass);
    if (m == 0) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(m) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(ncand, __popc(m));
    base = __shfl_sync(kFull, base, leader);
    if (pass) cand[base + __popc(m & ((1u << lane) - 1u))] = pk;
}

// K2's squared-domain pre-filter.  For a running width-th best key t (the
// high word of the packed key), sq_cut(t, c) >= every float s >= 0 with
// sqrt_rn(s) <= c * t (c = 1 or 2): sqrt_rn(s) <= c t gives
// s <= (c t + ulp(c t) / 2)^2 <= (c t)^2 (1 + 2^-22) for a normal c t, and
// the 2^-140 covers a subnormal one.  A row whose squared bound exceeds it
// cannot enter the selection, so its sqrts are skipped; the rows that pass
// take the exact sqrt and pack, so every kept key has K1's bits.
__device__ __forceinline__ float sq_cut(u64 thr, float c) {
    if (thr == kEmpty) return __int_as_float(0x7f800000);
    const double t = (double)c * (double)__uint_as_float((unsigned int)(thr >> 32));
    return __double2float_ru(t * t * (1.0 + 0x1p-20) + 0x1p-140);
}

// K2: one block per (query group, slice).  Shared memory, in order: the
// group's head coordinates i-major qsT[i * Gp + g] (Gp = G rounded up to
// kGR, zero-padded), their |q|^2, altitudes and pre-filter cuts, then per
// query the running selection, the candidate buffer, the running width-th
// best key and the candidate count.
template <int MODE, int kGR = group_regs(MODE)>
__global__ void topk_group_kernel(const float* __restrict__ table, int N, int n,
                                  const float* __restrict__ queries, int Q, int qw, int hd,
                                  const uint8_t* __restrict__ rowmask, int width, int wp, int tl,
                                  int G, int slice_rows, u64* __restrict__ part_keys) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int Gp = (G + kGR - 1) / kGR * kGR;
    const int T = blockDim.x;
    float* qsT = reinterpret_cast<float*>(smem_raw);  // hd * Gp
    float* q2s = qsT + (size_t)hd * Gp;               // Gp
    float* qas = q2s + Gp;                             // Gp
    float* cut1 = qas + Gp;                            // Gp: sq_cut(thr, 1)
    float* cut2 = cut1 + Gp;                           // Gp: sq_cut(thr, 2)
    u64* run = reinterpret_cast<u64*>(cut2 + Gp);      // G * wp
    u64* cand = run + (size_t)G * wp;                 // G * tl
    u64* thr = cand + (size_t)G * tl;                 // G
    int* ncand = reinterpret_cast<int*>(thr + G);     // G

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * G;
    const int gq = min(G, Q - q0);   // live queries of this group
    const int s = blockIdx.y;
    const int S = gridDim.y;
    for (int e = tid; e < hd * Gp; e += T) {
        const int i = e / Gp, g = e % Gp;
        qsT[e] = g < gq ? queries[(size_t)(q0 + g) * qw + i] : 0.0f;
    }
    for (int g = tid; g < Gp; g += T) {
        float a = 0.0f, b = 0.0f;
        if (g < gq) row_terms(queries + (size_t)(q0 + g) * qw, hd, qw, a, b);
        q2s[g] = a;
        qas[g] = b;
        // padded slots never pass the pre-filter
        cut1[g] = cut2[g] = g < gq ? sq_cut(kEmpty, 1.0f) : -1.0f;
    }
    for (int i = tid; i < G * wp; i += T) run[i] = kEmpty;
    for (int g = tid; g < G; g += T) {
        thr[g] = kEmpty;
        ncand[g] = 0;
    }
    __syncthreads();

    const int r0 = s * slice_rows;
    const int r1 = min(N, r0 + slice_rows);
    for (int base = r0; base < r1; base += T) {
        const int row = base + tid;
        const bool valid = row < r1 && (rowmask == nullptr || rowmask[row]);
        const float* x = table + (size_t)min(row, r1 - 1) * n;   // past r1: computed, never kept
        float x2, xa;
        row_terms(x, hd, n, x2, xa);
        for (int g0 = 0; g0 < gq; g0 += kGR) {
            float dot[kGR];
#pragma unroll
            for (int r = 0; r < kGR; ++r) dot[r] = 0.0f;
#pragma unroll 4
            for (int i = 0; i < hd; ++i) {
                const float xi = x[i];
                const float4* qv = reinterpret_cast<const float4*>(qsT + (size_t)i * Gp + g0);
#pragma unroll
                for (int v = 0; v < kGR / 4; ++v) {
                    const float4 qq = qv[v];
                    dot[4 * v] = op_fma(qq.x, xi, dot[4 * v]);
                    dot[4 * v + 1] = op_fma(qq.y, xi, dot[4 * v + 1]);
                    dot[4 * v + 2] = op_fma(qq.z, xi, dot[4 * v + 2]);
                    dot[4 * v + 3] = op_fma(qq.w, xi, dot[4 * v + 3]);
                }
            }
            // the squared-domain pre-filter of all kGR slots first (straight-
            // line code), then one vote: most tiles have no candidate at all
            unsigned maybe = 0;
#pragma unroll
            for (int r = 0; r < kGR; ++r) {
                const int g = g0 + r;
                float lsq, usq;
                bound_squares(q2s[g], qas[g], x2, xa, dot[r], lsq, usq);
                const bool m = MODE == kLwb ? lsq <= cut1[g]
                               : MODE == kUpb ? usq <= cut1[g]
                                              : (lsq <= cut1[g] && usq <= cut2[g]);
                maybe |= (unsigned)(valid && m) << r;
            }
            if (__any_sync(kFull, maybe != 0)) {
#pragma unroll
                for (int r = 0; r < kGR; ++r) {
                    const int g = g0 + r;
                    const bool m = (maybe >> r) & 1u;
                    if (__any_sync(kFull, m)) {   // g < gq: padded slots never pass
                        u64 pk = kEmpty;
                        if (m) {
                            float lsq, usq;
                            bound_squares(q2s[g], qas[g], x2, xa, dot[r], lsq, usq);
                            const float l = op_sqrt(lsq), u = op_sqrt(usq);
                            const float key = MODE == kLwb ? l : (MODE == kUpb ? u : op_mul(0.5f, op_add(l, u)));
                            pk = pack_key(key, row);
                        }
                        warp_append(m && pk < thr[g], pk, cand + (size_t)g * tl, &ncand[g]);
                    }
                }
            }
        }
        __syncthreads();
        // fold a buffer that might not hold the next tile, or the first
        // candidates while the selection is not yet full (that sets a
        // threshold early); sort only the next power of two of the buffer
        for (int g = 0; g < gq; ++g) {
            const int nc = ncand[g];
            if (nc > tl - T || (thr[g] == kEmpty && nc >= width)) {
                int len = wp;
                while (len < nc) len <<= 1;
                flush(run + (size_t)g * wp, cand + (size_t)g * tl, nc, wp, len);
                if (tid == 0) {
                    ncand[g] = 0;
                    thr[g] = run[(size_t)g * wp + width - 1];
                    cut1[g] = sq_cut(thr[g], 1.0f);
                    cut2[g] = sq_cut(thr[g], 2.0f);
                }
            }
        }
        __syncthreads();
    }
    for (int g = 0; g < gq; ++g) {
        const int nc = ncand[g];
        if (nc > 0) {
            int len = wp;
            while (len < nc) len <<= 1;
            flush(run + (size_t)g * wp, cand + (size_t)g * tl, nc, wp, len);
        }
    }
    __syncthreads();
    for (int g = 0; g < gq; ++g) {
        u64* out = part_keys + ((size_t)(q0 + g) * S + s) * wp;
        for (int i = tid; i < wp; i += T) out[i] = run[(size_t)g * wp + i];
    }
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

int launch_merge(cudaStream_t st, const float* table, int n, const float* queries, int Q, int qw,
                 int hd, const u64* part_keys, const int* part_counts, int slices, int width,
                 int wp, int* ids, float* lwb, float* upb, int* counts) {
    const size_t q_bytes = ((size_t)qw * sizeof(float) + 15) / 16 * 16;
    const size_t msmem = (size_t)2 * wp * sizeof(u64) + q_bytes;
    cudaFuncSetAttribute(select_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)msmem);
    select_merge_kernel<<<Q, kThreads, msmem, st>>>(table, n, queries, qw, hd, part_keys,
                                                    part_counts, slices, width, wp, ids, lwb, upb,
                                                    counts);
    return (int)cudaGetLastError();
}

// K3: one query per block, then the merge.
int run_threshold(const float* table, int N, int n, const float* queries, int Q, int qw,
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
    int err = launch_partial<kThreshold>(grid, smem, st, table, N, n, queries, qw, hd, rowmask,
                                         thresholds, width, wp, tl, slice_rows, part_keys,
                                         part_counts);
    if (err != 0) return err;
    return launch_merge(st, table, n, queries, Q, qw, hd, part_keys, part_counts, slices, width,
                        wp, ids, lwb, upb, counts);
}

template <int MODE>
int launch_group(dim3 grid, size_t smem, cudaStream_t st, const float* table, int N, int n,
                 const float* queries, int Q, int qw, int hd, const uint8_t* rowmask, int width,
                 int wp, int tl, int G, int slice_rows, u64* part_keys) {
    cudaError_t e = cudaFuncSetAttribute(topk_group_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    topk_group_kernel<MODE><<<grid, kThreads, smem, st>>>(table, N, n, queries, Q, qw, hd, rowmask,
                                                          width, wp, tl, G, slice_rows, part_keys);
    return (int)cudaGetLastError();
}

// K2: grouped scan, then the shared merge.
int run_topk(int mode, const float* table, int N, int n, const float* queries, int Q, int qw,
             int dims, const uint8_t* rowmask, int width, int G, int slices, u64* part_keys,
             int* ids, float* lwb, float* upb, void* stream) {
    if (width < 1 || width > kMaxWidth || width > N || slices < 1 || G < 1 || G > kMaxGroup)
        return (int)cudaErrorInvalidValue;
    const int wp = next_pow2(width);
    const int tl = wp > kMinCandGroup ? wp : kMinCandGroup;
    if ((size_t)G * (wp + tl) * sizeof(u64) > (size_t)kGroupBytes) return (int)cudaErrorInvalidValue;
    if (Q == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const int hd = dims - 1;
    if (G == 1) {
        // one query per block (select_partial_kernel)
        const int tl1 = wp > kMinCand ? wp : kMinCand;
        const size_t q_bytes = ((size_t)qw * sizeof(float) + 15) / 16 * 16;
        const size_t smem1 = (size_t)(wp + tl1) * sizeof(u64) + q_bytes;
        const int slice_rows = (N + slices - 1) / slices;
        dim3 grid(slices, Q);
        int err;
        switch (mode) {
            case kLwb: err = launch_partial<kLwb>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, part_keys, nullptr); break;
            case kUpb: err = launch_partial<kUpb>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, part_keys, nullptr); break;
            case kMid: err = launch_partial<kMid>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, part_keys, nullptr); break;
            default: return (int)cudaErrorInvalidValue;
        }
        if (err != 0) return err;
        return launch_merge(st, table, n, queries, Q, qw, hd, part_keys, nullptr, slices, width, wp,
                            ids, lwb, upb, nullptr);
    }
    const int gr = group_regs(mode);
    const int Gp = (G + gr - 1) / gr * gr;
    const size_t smem = (size_t)Gp * (hd + 4) * sizeof(float) +
                        (size_t)G * (wp + tl + 1) * sizeof(u64) + (size_t)G * sizeof(int);
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    const int slice_rows = (N + slices - 1) / slices;
    dim3 grid((Q + G - 1) / G, slices);
    int err;
    switch (mode) {
        case kLwb: err = launch_group<kLwb>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, width, wp, tl, G, slice_rows, part_keys); break;
        case kUpb: err = launch_group<kUpb>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, width, wp, tl, G, slice_rows, part_keys); break;
        case kMid: err = launch_group<kMid>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, width, wp, tl, G, slice_rows, part_keys); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != 0) return err;
    return launch_merge(st, table, n, queries, Q, qw, hd, part_keys, nullptr, slices, width, wp,
                        ids, lwb, upb, nullptr);
}

}  // namespace

// K2.  key_mode: 0 lwb, 1 upb, 2 mid; group: queries per block (G);
// part_keys: (Q, slices, next_pow2(k)) scratch.
extern "C" int repro_apex_topk(const float* table, int N, int n, const float* queries, int Q,
                               int qw, int dims, const uint8_t* rowmask, int key_mode, int k,
                               int group, int slices, unsigned long long* part_keys, int* ids,
                               float* lwb, float* upb, void* stream) {
    return run_topk(key_mode, table, N, n, queries, Q, qw, dims, rowmask, k, group, slices,
                    part_keys, ids, lwb, upb, stream);
}

// K3.  part_keys: (Q, slices, next_pow2(cap)); part_counts: (Q, slices).
extern "C" int repro_apex_threshold(const float* table, int N, int n, const float* queries, int Q,
                                    int qw, int dims, const uint8_t* rowmask,
                                    const float* thresholds, int cap, int slices,
                                    unsigned long long* part_keys, int* part_counts, int* ids,
                                    float* lwb, float* upb, int* counts, void* stream) {
    return run_threshold(table, N, n, queries, Q, qw, dims, rowmask, thresholds, cap, slices,
                         part_keys, part_counts, ids, lwb, upb, counts, stream);
}
