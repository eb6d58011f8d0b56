// K2 and K3: the fused selection epilogues of the (Q, N) bound scan.
//
// Replace the TPU kernels in src/repro/kernels/select_epilogue.py:
//   K2 apex_topk_pallas      — per query, the k rows with the smallest
//                              (key, id), key in {lwb, upb, mid};
//   K3 apex_threshold_pallas — per query, the cap smallest (lwb, id) among
//                              rows with lwb <= t[q] (f32 compare), plus the
//                              exact count of such rows, even when it
//                              overflows cap.
// Bound on this card: operations at 64 queries (bytes for one query, and
// for K3 at dims 10).  Both read the f32 table once (N * n * 4 bytes) and
// need per (query, row) pair the head dot product and the squared bound the
// key is decided on, 2(dims-1) + 6 operations (+ 3 for K2's mid key, which
// needs both), no sqrt; only O(Q * width) triples leave the kernel.  What
// holds them back is the instruction stream per (query, row) pair and, with
// one query per block (the first design), re-reading the 80 MB table once
// per query: ~5 GB for a 64-query call, which the 50 MB L2 cannot hold.
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
//   * group_scan_kernel (K2 with G > 1, and K3 at every G): grid (query
//     groups, slices); the group index varies fastest, so the blocks of one
//     slice run together and share it in L2, and the table is read once per
//     group of G queries, not once per query.  Each thread takes one row of
//     the slice at a time, forms its row terms once and evaluates it against
//     the group's queries kGR = 16 at a time (8 for the mid key): the head
//     dot products share each x_i read and read the query coordinates as
//     shared-memory float4 broadcasts.  Then a squared-domain pre-filter
//     (sq_cut) drops, without its two sqrts, every row that cannot beat the
//     query's running width-th best key; one warp vote skips the kGR slots
//     when no lane has a candidate.  Rows that pass take bound_squares() and
//     the sqrt, the same operations in the same order as K1's pair_bounds(),
//     so every kept key has K1's bits; a warp appends its candidates with one
//     shared atomic.  The first candidates are folded as soon as they fill
//     the selection, which sets a threshold after one tile.
//     K2's G comes from ops.topk_plan: G = min(32, Q, 64 KiB / ((wp + tl) * 8))
//     with tl = max(wp, 512), then balanced over the groups; run_topk refuses
//     a G outside that budget (kGroupBytes, kMaxGroup, kMinCandGroup).
//     Before balancing that is G = 15 at k <= 32, 14 at k <= 64, 12 at
//     k <= 128, 10 at k <= 256, 8 at k <= 512, 4 at k <= 1024, 2 at k <= 2048
//     and 1 above (at Q = 64 and k = 10 or 64: 5 groups of 13).
//   * K3 in group_scan_kernel: the threshold t[q] is fixed before the scan,
//     so the pre-filter is exact from the first row.  sq_max(t) is the
//     largest float s with sqrt_rn(s) <= t (sqrt_rn is monotone, so a squared
//     lwb passes the f32 compare l <= t exactly when it is <= sq_max(t)):
//     rows are counted in the squared domain, with no sqrt, and the count is
//     exact even when it overflows cap.  A row under the selection's cut
//     takes the sqrt, the f32 compare l <= t and the pack.  Counts are kept
//     per warp (ballot + popc) and summed in warp order.  A query keeps no
//     sorted selection: its 512-key shared candidate buffer spills, unsorted,
//     into its own part_keys slot in global memory (wp + max(wp, 512) keys);
//     when the slot would overflow, select_compact (a radix select) keeps its
//     cap smallest keys and tightens the cut to them.  So shared memory
//     holds only the buffers: G = 16 queries in 64 KiB at any cap up to
//     4096, and a query whose count overflows cap pays a select per wp
//     spilled keys at most, not a sort per buffer.  At the widths the index
//     uses (n = 20 and others, a template parameter) each row is read once
//     into registers with float4 loads.  A slice leaves its min(count, cap)
//     best keys, in any order.
//   * K2 with G = 1 (one query, or k > 2048): select_partial_kernel, grid
//     (slices, Q), one query per block, the first design.  K3 runs it only
//     when its caller asks for group 0 (the first design, kept to be timed
//     against); it also counts its passing rows.
//   * select_gather_kernel (K3): grid (Q, ceil(slices / 8)).  Each block
//     moves the kept keys of 8 slices together, keeps the cap smallest with
//     select_compact and writes them sorted; a query that overflows cap
//     leaves up to cap keys per slice, which one block per query would
//     merge alone.
//   * select_merge_kernel: grid (Q).  Merges the sorted selections (K2: the
//     slices'; K3: the gather's) the same way, sums K3's counts in slice
//     order, and writes ids with their lwb/upb recomputed by pair_bounds()
//     from the table row.
// Masked rows (rowmask == 0) never enter a selection or a count; empty slots
// come out as the sentinel id 2^31 - 1 with +inf bounds.  The output does not
// depend on block order: a selection of distinct packed keys is unique.
//
// Largest selection width held: kMaxWidth = 4096 (shared memory of the
// one-query-per-block kernel and of the merges: two buffers of 4096 uint64,
// 64 KB).  Wider requests
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
                                      int tl, int slice_rows, int slot,
                                      u64* __restrict__ part_keys,
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
    u64* out = part_keys + ((size_t)q * S + s) * slot;
    for (int i = threadIdx.x; i < wp; i += blockDim.x) out[i] = run[i];
    if (threadIdx.x == 0 && part_counts != nullptr) part_counts[(size_t)q * S + s] = count;
}

// queries per register chunk of group_scan_kernel: 16, but 8 for the mid
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
// K3's group plan: a group's candidate buffers, G * kThrCand * 8 bytes, fit
// kThrGroupBytes, and G <= kMaxGroup (the keys a query keeps live in its
// part_keys slots).  ops.threshold_plan picks G under the same constants
// (_THR_GROUP_BYTES, _THR_CAND; a CPU test holds them equal), and
// run_threshold refuses a G that breaks them.
constexpr int kThrCand = 512;          // K3's candidate buffer length
constexpr int kThrGroupBytes = 65536;  // 64 KiB: three blocks on an SM
// K3's slot per (query, slice) holds thr_slot(wp) = wp + max(wp, kThrCand)
// keys, so a select frees room for at least wp more; the gather gives each
// block kGatherSlices slices.  ops mirrors both (_THR_CAND, _THR_GATHER).
constexpr int kGatherSlices = 8;
__host__ __device__ inline int thr_slot(int wp) { return wp + (wp > kThrCand ? wp : kThrCand); }
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
// take the exact sqrt and pack, so every kept key has K1's bits.  A t of
// +inf, or a bound whose high word is no finite float, cuts nothing.
__device__ __forceinline__ float sq_cut(u64 thr, float c) {
    if ((unsigned int)(thr >> 32) >= 0x7f800000u) return __int_as_float(0x7f800000);  // kEmpty too
    const double t = (double)c * (double)__uint_as_float((unsigned int)(thr >> 32));
    return __double2float_ru(t * t * (1.0 + 0x1p-20) + 0x1p-140);
}

// K3's exact squared threshold: the largest float s with sqrt_rn(s) <= t, so
// that for every squared bound s (>= -0, or NaN) sqrt_rn(s) <= t exactly when
// s <= sq_max(t).  A t below 0 or NaN passes nothing (-1); +inf passes every
// non-NaN s.  Starting from the rounded t * t, the preimage of t under
// sqrt_rn is a few ulps wide, so each loop steps a few times at most.
__device__ float sq_max(float t) {
    const float inf = __int_as_float(0x7f800000);
    if (!(t >= 0.0f)) return -1.0f;
    if (t == inf) return inf;
    float s = op_mul(t, t);
    while (s < inf) {
        const float up = __int_as_float(__float_as_int(s) + 1);
        if (!(op_sqrt(up) <= t)) break;
        s = up;
    }
    while (op_sqrt(s) > t) s = __int_as_float(__float_as_int(s) - 1);  // stops at +0: sqrt(0) <= t
    return s;
}

// K3: keep the k smallest of the n distinct keys in slot[0:n) (global
// memory, n > k >= 1), moved to slot[0:k) in any order.  A radix select
// over 8-bit digits from the top finds the k-th smallest key, or stops at
// the first bucket that holds exactly the keys still needed; every thread
// gets back `bound`, the k-th key or the largest key of that bucket, and
// exactly k keys are <= bound.  Each pass over the slot loads kSelBatch
// keys per thread before using them, so the passes wait on L2 once per
// batch, not once per key.  hist: 256 ints; scratch: 3 + warps ints.
constexpr int kSelBatch = 6;

__device__ u64 select_compact(u64* slot, int n, int k, int* hist, int* scratch) {
    const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
    u64 prefix = 0, mask = 0;
    int need = k;
    for (int shift = 56; shift >= 0; shift -= 8) {
        for (int i = tid; i < 256; i += T) hist[i] = 0;
        __syncthreads();
        for (int base = 0; base < n; base += kSelBatch * T) {
            u64 key[kSelBatch];
#pragma unroll
            for (int r = 0; r < kSelBatch; ++r) {
                const int i = base + r * T + tid;
                key[r] = i < n ? slot[i] : kEmpty;
            }
#pragma unroll
            for (int r = 0; r < kSelBatch; ++r) {
                const int i = base + r * T + tid;
                const int d = i < n && (key[r] & mask) == prefix ? (int)(key[r] >> shift) & 255 : -1;
                const unsigned peers = __match_any_sync(kFull, d);
                if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
            }
        }
        __syncthreads();
        if (warp == 0) {
            // lane j holds digits 8j..8j+7: a warp scan finds the digit
            // where the running count reaches `need`
            int c[8], sum = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) sum += (c[j] = hist[lane * 8 + j]);
            int incl = sum;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int v = __shfl_up_sync(kFull, incl, o);
                if (lane >= o) incl += v;
            }
            int before = incl - sum;
            if (before < need && need <= incl) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (before + c[j] >= need) {
                        scratch[0] = lane * 8 + j;
                        scratch[1] = need - before;
                        scratch[2] = c[j];
                        break;
                    }
                    before += c[j];
                }
            }
        }
        __syncthreads();
        prefix |= (u64)scratch[0] << shift;
        mask |= (u64)255 << shift;
        need = scratch[1];
        const bool done = scratch[2] == need;
        __syncthreads();
        if (done) break;
    }
    const u64 bound = prefix | ~mask;
    // in-place compaction: a kept key moves to an index no larger than its
    // own, and a batch is loaded in full before any of its writes
    int* wcount = scratch + 3;
    int out = 0;
    for (int base = 0; base < n; base += kSelBatch * T) {
        u64 key[kSelBatch];
#pragma unroll
        for (int r = 0; r < kSelBatch; ++r) {
            const int i = base + r * T + tid;
            key[r] = i < n ? slot[i] : kEmpty;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kSelBatch; ++r) {
            const bool keep = base + r * T + tid < n && key[r] <= bound;
            const unsigned b = __ballot_sync(kFull, keep);
            if (lane == 0) wcount[warp] = __popc(b);
            __syncthreads();
            int pos = out, total = 0;
            for (int w = 0; w < T / 32; ++w) {
                pos += w < warp ? wcount[w] : 0;
                total += wcount[w];
            }
            if (keep) slot[pos + __popc(b & ((1u << lane) - 1u))] = key[r];
            out += total;
            __syncthreads();
        }
    }
    return bound;
}

// Shared memory of group_scan_kernel, in order: the group's head coordinates
// i-major qsT[i * Gp + g] (Gp = G rounded up to kGR, zero-padded), their
// |q|^2, altitudes and two cuts; for K3 also its thresholds, per-warp counts
// and select_compact's histogram and scratch; then (16-byte aligned) per
// query the running selection (K2 only: K3 keeps its kept keys in its
// part_keys slot in global memory), the candidate buffer, the running
// width-th best key, the candidate count and (K3) the slot's fill.
__host__ __device__ inline size_t group_words(int mode, int Gp, int hd, int warps) {
    return (size_t)Gp * (hd + 4) + (mode == kThreshold ? (size_t)Gp * (1 + warps) + 256 + 3 + warps : 0);
}
__host__ __device__ inline size_t group_smem_bytes(int mode, int G, int Gp, int hd, int wp, int tl,
                                                   int warps) {
    const bool thr = mode == kThreshold;
    return (group_words(mode, Gp, hd, warps) * sizeof(float) + 15) / 16 * 16 +
           (size_t)G * ((thr ? 0 : wp) + tl + 1) * sizeof(u64) + (size_t)G * (thr ? 2 : 1) * sizeof(int);
}

// K2 and K3 (G > 1): one block per (query group, slice).  cut1 is the
// selection's pre-filter cut; cut2 is K2's mid-key cut on the upper bound,
// and K3's exact count cut sq_max(t).  NW > 0 (K3 at the widths the index
// uses): the table width n == NW at compile time, so each row is read once
// into registers (as float4 loads when `vec`: NW % 4 == 0 and the table
// 16-byte aligned) and the i loops unroll; NW == 0 reads the row's
// coordinates from global memory in each query chunk.
template <int MODE, int NW, int kGR = group_regs(MODE)>
__global__ void group_scan_kernel(const float* __restrict__ table, int N, int n,
                                  const float* __restrict__ queries, int Q, int qw, int hd,
                                  const uint8_t* __restrict__ rowmask,
                                  const float* __restrict__ thresholds, int width, int wp, int tl,
                                  int G, int slice_rows, int slot, bool vec,
                                  u64* __restrict__ part_keys, int* __restrict__ part_counts) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr bool kThr = MODE == kThreshold;
    const int Gp = (G + kGR - 1) / kGR * kGR;
    const int T = blockDim.x;
    const int warps = T / 32;
    float* qsT = reinterpret_cast<float*>(smem_raw);  // hd * Gp
    float* q2s = qsT + (size_t)hd * Gp;               // Gp
    float* qas = q2s + Gp;                             // Gp
    float* cut1 = qas + Gp;                            // Gp
    float* cut2 = cut1 + Gp;                           // Gp
    float* tq = cut2 + Gp;                             // Gp (K3)
    int* wcnt = reinterpret_cast<int*>(tq + (kThr ? Gp : 0));   // warps * Gp (K3)
    int* hist = wcnt + (kThr ? (size_t)warps * Gp : 0);         // 256 (K3)
    int* sscr = hist + (kThr ? 256 : 0);                        // 3 + warps (K3)
    u64* run_s = reinterpret_cast<u64*>(smem_raw + (group_words(MODE, Gp, hd, warps) * sizeof(float) + 15) / 16 * 16);
    u64* cand = run_s + (kThr ? 0 : (size_t)G * wp);  // G * tl (run_s: G * wp, K2)
    u64* thr = cand + (size_t)G * tl;                 // G
    int* ncand = reinterpret_cast<int*>(thr + G);     // G
    int* filled = ncand + G;                          // G (K3)

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int q0 = blockIdx.x * G;
    const int gq = min(G, Q - q0);   // live queries of this group
    const int s = blockIdx.y;
    const int S = gridDim.y;
    auto slot_of = [&](int g) { return part_keys + ((size_t)(q0 + g) * S + s) * slot; };
    // K3: move g's candidates to its slot; when they would overflow it,
    // first keep the slot's `width` smallest keys (select_compact) and
    // tighten g's cut to them
    auto spill = [&](int g, int nc) {
        u64* sl = slot_of(g);
        int f = filled[g];
        if (f + nc > slot) {
            const u64 b = select_compact(sl, f, width, hist, sscr);
            f = width;
            if (tid == 0) {
                thr[g] = b;
                cut1[g] = fminf(cut2[g], sq_cut(b, 1.0f));
            }
        }
        for (int i = tid; i < nc; i += T) sl[f + i] = cand[(size_t)g * tl + i];
        __syncthreads();
        if (tid == 0) {
            filled[g] = f + nc;
            ncand[g] = 0;
        }
    };
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
        if (kThr) {
            const float t = g < gq ? thresholds[q0 + g] : -1.0f;
            tq[g] = t;
            cut1[g] = cut2[g] = sq_max(t);
        } else {
            cut1[g] = cut2[g] = g < gq ? sq_cut(kEmpty, 1.0f) : -1.0f;
        }
    }
    if (kThr) {
        for (int i = tid; i < warps * Gp; i += T) wcnt[i] = 0;
    } else {
        for (int i = tid; i < G * wp; i += T) run_s[i] = kEmpty;
    }
    for (int g = tid; g < G; g += T) {
        thr[g] = kEmpty;
        ncand[g] = 0;
        if (kThr) filled[g] = 0;
    }
    __syncthreads();

    const int r0 = s * slice_rows;
    const int r1 = min(N, r0 + slice_rows);
    for (int base = r0; base < r1; base += T) {
        const int row = base + tid;
        const bool valid = row < r1 && (rowmask == nullptr || rowmask[row]);
        const float* x = table + (size_t)min(row, r1 - 1) * n;   // past r1: computed, never kept
        float x2, xa;
        float xr[NW > 0 ? NW : 1];
        if constexpr (NW > 0) {
            load_row(x, vec, xr);
            row_terms_reg(xr, hd, x2, xa);
        } else {
            row_terms(x, hd, n, x2, xa);
        }
        for (int g0 = 0; g0 < gq; g0 += kGR) {
            float dot[kGR];
#pragma unroll
            for (int r = 0; r < kGR; ++r) dot[r] = 0.0f;
            if constexpr (NW > 0) {
#pragma unroll
                for (int i = 0; i < NW; ++i) {
                    if (i < hd) {
                        const float xi = xr[i];
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
                }
            } else {
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
            }
            // the squared-domain pre-filter of all kGR slots first (straight-
            // line code), then one vote: most tiles have no candidate at all.
            // K3 also marks the rows it counts (lsq <= sq_max(t): exact).
            unsigned maybe = 0, hits = 0;
#pragma unroll
            for (int r = 0; r < kGR; ++r) {
                const int g = g0 + r;
                float lsq, usq;
                bound_squares(q2s[g], qas[g], x2, xa, dot[r], lsq, usq);
                const bool m = MODE == kLwb || kThr ? lsq <= cut1[g]
                               : MODE == kUpb       ? usq <= cut1[g]
                                                    : (lsq <= cut1[g] && usq <= cut2[g]);
                maybe |= (unsigned)(valid && m) << r;
                if (kThr) hits |= (unsigned)(valid && lsq <= cut2[g]) << r;
            }
            if (kThr && __any_sync(kFull, hits != 0)) {
                int* wc = wcnt + (size_t)(tid >> 5) * Gp + g0;
#pragma unroll
                for (int r = 0; r < kGR; ++r) {
                    const unsigned b = __ballot_sync(kFull, (hits >> r) & 1u);
                    if (lane == 0) wc[r] += __popc(b);
                }
            }
            if (__any_sync(kFull, maybe != 0)) {
#pragma unroll
                for (int r = 0; r < kGR; ++r) {
                    const int g = g0 + r;
                    const bool m = (maybe >> r) & 1u;
                    if (__any_sync(kFull, m)) {   // g < gq: padded slots never pass
                        u64 pk = kEmpty;
                        bool keep = m;
                        if (m) {
                            float lsq, usq;
                            bound_squares(q2s[g], qas[g], x2, xa, dot[r], lsq, usq);
                            const float l = op_sqrt(lsq);
                            float key = l;
                            if (kThr) {
                                keep = l <= tq[g];   // the f32 compare itself
                            } else if (MODE != kLwb) {
                                const float u = op_sqrt(usq);
                                key = MODE == kUpb ? u : op_mul(0.5f, op_add(l, u));
                            }
                            pk = pack_key(key, row);
                        }
                        warp_append(keep && pk < thr[g], pk, cand + (size_t)g * tl, &ncand[g]);
                    }
                }
            }
        }
        __syncthreads();
        // fold (K3: spill) a buffer that might not hold the next tile; K2
        // also folds its first candidates as soon as they fill the selection
        // (that sets a threshold early)
        for (int g = 0; g < gq; ++g) {
            const int nc = ncand[g];
            if (kThr) {
                if (nc > tl - T) spill(g, nc);
            } else if (nc > tl - T || (thr[g] == kEmpty && nc >= width)) {
                u64* run = run_s + (size_t)g * wp;
                int len = wp;
                while (len < nc) len <<= 1;
                flush(run, cand + (size_t)g * tl, nc, wp, len);
                if (tid == 0) {
                    ncand[g] = 0;
                    thr[g] = run[width - 1];
                    cut1[g] = sq_cut(thr[g], 1.0f);
                    cut2[g] = sq_cut(thr[g], 2.0f);
                }
            }
        }
        __syncthreads();
    }
    if (kThr) {
        // the slot ends with the slice's min(count, width) best keys, in
        // any order, where the gather reads them
        for (int g = 0; g < gq; ++g) {
            const int nc = ncand[g];
            if (nc > 0) spill(g, nc);
            __syncthreads();
            if (filled[g] > width) select_compact(slot_of(g), filled[g], width, hist, sscr);
        }
        for (int g = tid; g < gq; g += T) {
            int c = 0;
            for (int w = 0; w < warps; ++w) c += wcnt[(size_t)w * Gp + g];
            part_counts[(size_t)(q0 + g) * S + s] = c;
        }
    } else {
        for (int g = 0; g < gq; ++g) {
            const int nc = ncand[g];
            if (nc > 0) {
                int len = wp;
                while (len < nc) len <<= 1;
                flush(run_s + (size_t)g * wp, cand + (size_t)g * tl, nc, wp, len);
            }
        }
        __syncthreads();
        for (int g = 0; g < gq; ++g) {
            u64* out = slot_of(g);
            for (int i = tid; i < wp; i += T) out[i] = run_s[(size_t)g * wp + i];
        }
    }
}

// K3's first merge level: grid (Q, M).  Block (q, m) takes slices
// [m * S / M, (m + 1) * S / M) of query q: it moves their kept keys (each
// slice's first min(count, width), in any order) to the front of their
// slots, which lie side by side in part_keys, keeps the width smallest with
// select_compact, sorts them in shared memory and writes them, padded empty
// to wp, to gather[q, m].  M blocks per query share a query's slices, so a
// query whose count overflows cap does not merge S slices of cap keys alone.
__global__ void select_gather_kernel(u64* __restrict__ part_keys,
                                     const int* __restrict__ part_counts, int S, int width,
                                     int wp, int slot, u64* __restrict__ gather) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    u64* keys = reinterpret_cast<u64*>(smem_raw);  // wp
    __shared__ int hist[256];
    __shared__ int scratch[3 + 32];
    const int q = blockIdx.x, m = blockIdx.y, M = gridDim.y;
    const int T = blockDim.x, tid = threadIdx.x;
    const int s0 = m * S / M, s1 = (m + 1) * S / M;
    u64* region = part_keys + ((size_t)q * S + s0) * slot;
    // slice s's keys land in [n, n + ns) with n <= (s - s0) * wp, before its
    // own slot ((s - s0) * slot, slot >= 2 wp); a barrier after each slice
    // keeps the next slice's writes behind this slice's reads
    int n = 0;
    for (int s = s0; s < s1; ++s) {
        const int ns = min(part_counts[(size_t)q * S + s], width);
        const u64* src = region + (size_t)(s - s0) * slot;
        if (s > s0) {
            for (int base = 0; base < ns; base += kSelBatch * T) {
                u64 key[kSelBatch];
#pragma unroll
                for (int r = 0; r < kSelBatch; ++r) {
                    const int i = base + r * T + tid;
                    key[r] = i < ns ? src[i] : kEmpty;
                }
#pragma unroll
                for (int r = 0; r < kSelBatch; ++r) {
                    const int i = base + r * T + tid;
                    if (i < ns) region[n + i] = key[r];
                }
            }
        }
        n += ns;
        __syncthreads();
    }
    if (n > width) {
        select_compact(region, n, width, hist, scratch);
        n = width;
    }
    int len = 1;
    while (len < n) len <<= 1;
    for (int i = tid; i < len; i += T) keys[i] = i < n ? region[i] : kEmpty;
    bitonic_sort(keys, len);
    u64* out = gather + ((size_t)q * M + m) * wp;
    for (int i = tid; i < wp; i += T) out[i] = i < len ? keys[i] : kEmpty;
}

// Final merge: grid (Q).  Merges the query's P sorted partials of wp keys
// (K2: its slices' selections; K3: the gather's), sums part_counts over S
// slices in slice order (K3), and writes ids with their lwb/upb recomputed
// by pair_bounds() from the table row.
__global__ void select_merge_kernel(const float* __restrict__ table, int n,
                                    const float* __restrict__ queries, int qw, int hd,
                                    const u64* __restrict__ parts, int P,
                                    const int* __restrict__ part_counts, int S, int width, int wp,
                                    int* __restrict__ ids, float* __restrict__ lwb,
                                    float* __restrict__ upb, int* __restrict__ counts) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    u64* run = reinterpret_cast<u64*>(smem_raw);  // wp
    u64* cand = run + wp;                          // wp
    float* qs = reinterpret_cast<float*>(cand + wp);
    const int q = blockIdx.x;
    const u64* part = parts + (size_t)q * P * wp;
    for (int i = threadIdx.x; i < wp; i += blockDim.x) run[i] = part[i];
    for (int i = threadIdx.x; i < qw; i += blockDim.x) qs[i] = queries[(size_t)q * qw + i];
    for (int p = 1; p < P; ++p) {
        __syncthreads();
        for (int i = threadIdx.x; i < wp; i += blockDim.x) cand[i] = part[(size_t)p * wp + i];
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
                   const float* thresholds, int width, int wp, int tl, int slice_rows, int slot,
                   u64* part_keys, int* part_counts) {
    cudaFuncSetAttribute(select_partial_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    select_partial_kernel<MODE><<<grid, kThreads, smem, st>>>(table, N, n, queries, qw, hd,
                                                             rowmask, thresholds, width, wp, tl,
                                                             slice_rows, slot, part_keys,
                                                             part_counts);
    return (int)cudaGetLastError();
}

int launch_merge(cudaStream_t st, const float* table, int n, const float* queries, int Q, int qw,
                 int hd, const u64* parts, int P, const int* part_counts, int slices, int width,
                 int wp, int* ids, float* lwb, float* upb, int* counts) {
    const size_t q_bytes = ((size_t)qw * sizeof(float) + 15) / 16 * 16;
    const size_t msmem = (size_t)2 * wp * sizeof(u64) + q_bytes;
    cudaFuncSetAttribute(select_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)msmem);
    select_merge_kernel<<<Q, kThreads, msmem, st>>>(table, n, queries, qw, hd, parts, P,
                                                    part_counts, slices, width, wp, ids, lwb, upb,
                                                    counts);
    return (int)cudaGetLastError();
}

int launch_gather(cudaStream_t st, u64* part_keys, const int* part_counts, int Q, int slices, int M,
                  int width, int wp, int slot, u64* gather) {
    const size_t gsmem = (size_t)wp * sizeof(u64);
    cudaFuncSetAttribute(select_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)gsmem);
    select_gather_kernel<<<dim3(Q, M), kThreads, gsmem, st>>>(part_keys, part_counts, slices, width,
                                                               wp, slot, gather);
    return (int)cudaGetLastError();
}

template <int MODE, int NW>
int launch_group(dim3 grid, size_t smem, cudaStream_t st, const float* table, int N, int n,
                 const float* queries, int Q, int qw, int hd, const uint8_t* rowmask,
                 const float* thresholds, int width, int wp, int tl, int G, int slice_rows,
                 int slot, u64* part_keys, int* part_counts) {
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(group_scan_kernel<MODE, NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const bool vec = reinterpret_cast<uintptr_t>(table) % 16 == 0;
    group_scan_kernel<MODE, NW><<<grid, kThreads, smem, st>>>(table, N, n, queries, Q, qw, hd, rowmask,
                                                              thresholds, width, wp, tl, G, slice_rows,
                                                              slot, vec, part_keys, part_counts);
    return (int)cudaGetLastError();
}

// K3: grouped scan (G >= 1) or one query per block (G = 0), then the gather
// (M = ceil(slices / kGatherSlices) blocks per query) and the merge.
// part_keys holds Q * slices slots of thr_slot(cap) keys, then the
// gather's Q * M * next_pow2(cap) keys.
int run_threshold(const float* table, int N, int n, const float* queries, int Q, int qw,
                  int dims, const uint8_t* rowmask, const float* thresholds, int width, int G,
                  int slices, u64* part_keys, int* part_counts, int* ids, float* lwb, float* upb,
                  int* counts, void* stream) {
    if (width < 1 || width > kMaxWidth || width > N || slices < 1 || G < 0 || G > kMaxGroup ||
        (size_t)G * kThrCand * sizeof(u64) > (size_t)kThrGroupBytes)
        return (int)cudaErrorInvalidValue;
    if (Q == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const int hd = dims - 1;
    const int wp = next_pow2(width);
    const int slot = thr_slot(wp);
    const int slice_rows = (N + slices - 1) / slices;
    int err;
    if (G == 0) {
        const int tl = wp > kMinCand ? wp : kMinCand;
        const size_t q_bytes = ((size_t)qw * sizeof(float) + 15) / 16 * 16;
        const size_t smem = (size_t)(wp + tl) * sizeof(u64) + q_bytes;
        err = launch_partial<kThreshold>(dim3(slices, Q), smem, st, table, N, n, queries, qw, hd,
                                         rowmask, thresholds, width, wp, tl, slice_rows, slot,
                                         part_keys, part_counts);
    } else {
        constexpr int gr = group_regs(kThreshold);
        const int Gp = (G + gr - 1) / gr * gr;
        const size_t smem = group_smem_bytes(kThreshold, G, Gp, hd, wp, kThrCand, kThreads / 32);
        const dim3 grid((Q + G - 1) / G, slices);
#define K3_LAUNCH(NW)                                                                            \
    launch_group<kThreshold, NW>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask,      \
                                 thresholds, width, wp, kThrCand, G, slice_rows, slot,          \
                                 part_keys, part_counts)
        switch (n) {
            case 10: err = K3_LAUNCH(10); break;
            case 16: err = K3_LAUNCH(16); break;
            case 20: err = K3_LAUNCH(20); break;
            case 32: err = K3_LAUNCH(32); break;
            default: err = K3_LAUNCH(0); break;
        }
#undef K3_LAUNCH
    }
    if (err != 0) return err;
    const int M = (slices + kGatherSlices - 1) / kGatherSlices;
    u64* gather = part_keys + (size_t)Q * slices * slot;
    err = launch_gather(st, part_keys, part_counts, Q, slices, M, width, wp, slot, gather);
    if (err != 0) return err;
    return launch_merge(st, table, n, queries, Q, qw, hd, gather, M, part_counts, slices, width,
                        wp, ids, lwb, upb, counts);
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
    const int slice_rows = (N + slices - 1) / slices;
    if (G == 1) {
        // one query per block (select_partial_kernel)
        const int tl1 = wp > kMinCand ? wp : kMinCand;
        const size_t q_bytes = ((size_t)qw * sizeof(float) + 15) / 16 * 16;
        const size_t smem1 = (size_t)(wp + tl1) * sizeof(u64) + q_bytes;
        dim3 grid(slices, Q);
        int err;
        switch (mode) {
            case kLwb: err = launch_partial<kLwb>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, wp, part_keys, nullptr); break;
            case kUpb: err = launch_partial<kUpb>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, wp, part_keys, nullptr); break;
            case kMid: err = launch_partial<kMid>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, wp, part_keys, nullptr); break;
            default: return (int)cudaErrorInvalidValue;
        }
        if (err != 0) return err;
        return launch_merge(st, table, n, queries, Q, qw, hd, part_keys, slices, nullptr, slices,
                            width, wp, ids, lwb, upb, nullptr);
    }
    const int gr = group_regs(mode);
    const int Gp = (G + gr - 1) / gr * gr;
    const size_t smem = group_smem_bytes(mode, G, Gp, hd, wp, tl, kThreads / 32);
    dim3 grid((Q + G - 1) / G, slices);
    int err;
    switch (mode) {
        case kLwb: err = launch_group<kLwb, 0>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, tl, G, slice_rows, wp, part_keys, nullptr); break;
        case kUpb: err = launch_group<kUpb, 0>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, tl, G, slice_rows, wp, part_keys, nullptr); break;
        case kMid: err = launch_group<kMid, 0>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, tl, G, slice_rows, wp, part_keys, nullptr); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != 0) return err;
    return launch_merge(st, table, n, queries, Q, qw, hd, part_keys, slices, nullptr, slices, width,
                        wp, ids, lwb, upb, nullptr);
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

// K3.  group: queries per block (G >= 1), or 0 for one query per block (the
// first design); part_keys: Q * slices * thr_slot(wp)
// + Q * ceil(slices / 8) * wp keys, wp = next_pow2(cap); part_counts:
// (Q, slices).
extern "C" int repro_apex_threshold(const float* table, int N, int n, const float* queries, int Q,
                                    int qw, int dims, const uint8_t* rowmask,
                                    const float* thresholds, int cap, int group, int slices,
                                    unsigned long long* part_keys, int* part_counts, int* ids,
                                    float* lwb, float* upb, int* counts, void* stream) {
    return run_threshold(table, N, n, queries, Q, qw, dims, rowmask, thresholds, cap, group,
                         slices, part_keys, part_counts, ids, lwb, upb, counts, stream);
}
