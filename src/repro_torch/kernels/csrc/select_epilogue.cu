// K2 and K3: the fused selection epilogues of the (Q, N) bound scan.
//
// Replace the TPU kernels in src/repro/kernels/select_epilogue.py:
//   K2 apex_topk_pallas      — per query, the k rows with the smallest
//                              (key, id), key in {lwb, upb, mid};
//   K3 apex_threshold_pallas — per query, the cap smallest (lwb, id) among
//                              rows with lwb <= t[q], plus the exact count
//                              of such rows, even when it overflows cap.
// Both work in the table's dtype, as the TPU kernels do: every kernel below
// is a template on the scalar T (float or double) and its packed key K.  An
// f32 key is the u64 (bits(|key|) << 32) | id; an f64 key is the 96-bit
// (bits(|key|) << 32) | id, held in an unsigned __int128, and the radix
// passes walk its 96 bits.  f64 bounds come from pair_bounds<double>, the
// rounding routine K1's f64 scan uses (--fmad=false, no TF32), and K3's f64
// thresholds are compared in f64.
// Bound on this card: operations at 64 queries (bytes for one query, and
// for K3 at dims 10).  Both read the table once (N * n * 4 bytes) and
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
// Widths.  Up to kMaxWidth = 4096 the plans above hold a query's selection
// in shared memory (the one-query-per-block kernel and the merges keep two
// buffers of next_pow2(width) keys: 64 KB of f32 keys, 128 KB of f64 keys).
// Any wider selection takes the global-memory plan (run_wide), for K2 and
// K3 alike:
//   * group_scan_kernel with SPILL (K3's scan; K2 with its own key and a
//     count of the slice's live rows): each (query, slice) spills into a
//     slot of min(wp + max(wp, 512), slice rows) keys in global memory and
//     is cut to its width smallest keys by select_compact when full;
//   * wide_gather_kernel, grid (Q, ceil(slices / 8)): moves 8 slices' kept
//     keys together and keeps the width smallest (a radix select of the
//     width-th key and a compaction of the keys at or below it);
//   * wide_sort_kernel, grid (Q): the same over the gather blocks' keys,
//     then an LSD radix sort of the kept keys (8-bit digits, stable block
//     scatter) through two global buffers of width keys;
//   * select_write_kernel, grid (ceil(width / 256), Q): ids and lwb/upb
//     recomputed by pair_bounds(), and K3's counts.
// The scratch is the caller's (ops.py sizes it and splits the queries into
// chunks that fit its budget).
#include "tile_math.cuh"

namespace {

typedef unsigned long long u64;
typedef unsigned __int128 u128;

constexpr int kThreads = 256;
constexpr int kMinCand = 1024;   // candidate buffer length floor
constexpr int kMaxWidth = 4096;
constexpr int kSentinelId = 0x7fffffff;

enum Mode { kLwb = 0, kUpb = 1, kMid = 2, kThreshold = 3 };

// The packed key of a scalar type, and the bits its radix passes walk.
template <typename T> struct KeyOf;
template <> struct KeyOf<float> {
    typedef u64 type;
    static constexpr int kBits = 64;
};
template <> struct KeyOf<double> {
    typedef u128 type;
    static constexpr int kBits = 96;
};

// The empty key: larger than every packed (key, id).
template <typename K>
__host__ __device__ __forceinline__ K key_empty() { return ~(K)0; }

__device__ __forceinline__ u64 pack_key(float key, int id) {
    const unsigned int bits = __float_as_uint(key) & 0x7fffffffu;
    return ((u64)bits << 32) | (unsigned int)id;
}

__device__ __forceinline__ u128 pack_key(double key, int id) {
    const u64 bits = (u64)__double_as_longlong(key) & 0x7fffffffffffffffull;
    return ((u128)bits << 32) | (unsigned int)id;
}

template <typename T>
__device__ __forceinline__ T scalar_inf() { return (T)__int_as_float(0x7f800000); }

// One compare-exchange network stage over a[0:len) (len a power of two).
template <typename K>
__device__ __forceinline__ void bitonic_stage(K* a, int len, int size, int stride) {
    for (int i = threadIdx.x; i < len / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const K x = a[lo], y = a[hi];
        if ((x > y) == up) {
            a[lo] = y;
            a[hi] = x;
        }
    }
    __syncthreads();
}

template <typename K>
__device__ void bitonic_sort(K* a, int len) {
    __syncthreads();
    for (int size = 2; size <= len; size <<= 1)
        for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_stage(a, len, size, stride);
}

// Sort a bitonic sequence a[0:len) ascending.
template <typename K>
__device__ void bitonic_merge(K* a, int len) {
    __syncthreads();
    for (int stride = len >> 1; stride > 0; stride >>= 1) bitonic_stage(a, len, len, stride);
}

// run[0:wp) sorted ascending, cand[0:wp) sorted ascending: keep the wp
// smallest of the union in run, sorted.
template <typename K>
__device__ void merge_sorted(K* run, const K* cand, int wp) {
    __syncthreads();
    for (int i = threadIdx.x; i < wp; i += blockDim.x) {
        const K v = cand[wp - 1 - i];
        if (v < run[i]) run[i] = v;
    }
    bitonic_merge(run, wp);
}

// Fold cand[0:nc) (unsorted) into the sorted running selection run[0:wp).
template <typename K>
__device__ void flush(K* run, K* cand, int nc, int wp, int tl) {
    for (int i = nc + threadIdx.x; i < tl; i += blockDim.x) cand[i] = key_empty<K>();
    bitonic_sort(cand, tl);
    merge_sorted(run, cand, wp);
}

template <typename T, int MODE>
__global__ void select_partial_kernel(const T* __restrict__ table, int N, int n,
                                      const T* __restrict__ queries, int qw, int hd,
                                      const uint8_t* __restrict__ rowmask,
                                      const T* __restrict__ thresholds, int width, int wp,
                                      int tl, int slice_rows, int slot,
                                      typename KeyOf<T>::type* __restrict__ part_keys,
                                      int* __restrict__ part_counts) {
    typedef typename KeyOf<T>::type K;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    K* run = reinterpret_cast<K*>(smem_raw);  // wp
    K* cand = run + wp;                        // tl
    T* qs = reinterpret_cast<T*>(cand + tl);
    __shared__ int ncand;
    __shared__ int count;

    const int s = blockIdx.x;
    const int S = gridDim.x;
    const int q = blockIdx.y;
    for (int i = threadIdx.x; i < qw; i += blockDim.x) qs[i] = queries[(size_t)q * qw + i];
    for (int i = threadIdx.x; i < wp; i += blockDim.x) run[i] = key_empty<K>();
    if (threadIdx.x == 0) {
        ncand = 0;
        count = 0;
    }
    __syncthreads();
    T q2, qa;
    row_terms(qs, hd, qw, q2, qa);
    const T t = MODE == kThreshold ? thresholds[q] : T(0);

    const int r0 = s * slice_rows;
    const int r1 = min(N, r0 + slice_rows);
    int my_count = 0;
    K thr = key_empty<K>();  // the running width-th best key: only smaller keys matter
    for (int base = r0; base < r1; base += blockDim.x) {
        const int row = base + threadIdx.x;
        if (row < r1 && (rowmask == nullptr || rowmask[row])) {
            const T* x = table + (size_t)row * n;
            T x2, xa, l, u;
            row_terms(x, hd, n, x2, xa);
            pair_bounds(qs, q2, qa, x, x2, xa, hd, l, u);
            bool pass = true;
            T key;
            if (MODE == kThreshold) {
                pass = l <= t;
                my_count += pass;
                key = l;
            } else {
                key = MODE == kLwb ? l : (MODE == kUpb ? u : op_mul(T(0.5), op_add(l, u)));
            }
            if (pass) {
                const K pk = pack_key(key, row);
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
    K* out = part_keys + ((size_t)q * S + s) * slot;
    for (int i = threadIdx.x; i < wp; i += blockDim.x) out[i] = run[i];
    if (threadIdx.x == 0 && part_counts != nullptr) part_counts[(size_t)q * S + s] = count;
}

// queries per register chunk of group_scan_kernel: 16, but 8 for the mid
// key, whose two squared bounds per slot cost registers (at 16 the kernel
// keeps fewer blocks on an SM and runs slower)
__host__ __device__ constexpr int group_regs(int mode) { return mode == kMid ? 8 : 16; }
// K2's group plan: a group's selection state, G * (wp + tl) * sizeof(key)
// bytes with tl = max(wp, kMinCandGroup), fits kGroupBytes, and
// G <= kMaxGroup.  ops.topk_plan picks G under the same constants
// (_TOPK_MIN_CAND, _TOPK_GROUP_BYTES, _TOPK_MAX_GROUP; a CPU test holds them
// equal), and run_topk refuses a G that breaks them.
constexpr int kMinCandGroup = 512;  // candidate buffer length floor of K2
constexpr int kGroupBytes = 65536;  // 64 KiB
constexpr int kMaxGroup = 32;
// K3's group plan (and the wide plan's, K2 too): a group's candidate
// buffers, G * kThrCand * sizeof(key) bytes, fit kThrGroupBytes, and
// G <= kMaxGroup (the keys a query keeps live in its part_keys slots).
// ops.threshold_plan and ops.wide_plan pick G under the same constants
// (_THR_GROUP_BYTES, _THR_CAND; a CPU test holds them equal), and
// run_threshold and run_wide refuse a G that breaks them.
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
template <typename K>
__device__ __forceinline__ void warp_append(bool pass, K pk, K* cand, int* ncand) {
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
// high word of the packed key), sq_cut(t, c) >= every s >= 0 with
// sqrt_rn(s) <= c * t (c = 1 or 2).  f32: sqrt_rn(s) <= c t gives
// s <= (c t + ulp(c t) / 2)^2 <= (c t)^2 (1 + 2^-22) for a normal c t, and
// the 2^-140 covers a subnormal one.  f64: (c t)^2 rounded up, times
// 1 + 2^-48 rounded up (the sqrt's half ulp and the mid key's sum are each
// below 2^-52 relative), plus 2^-1000 for a subnormal c t.  A row whose
// squared bound exceeds the cut cannot enter the selection, so its sqrts are
// skipped; the rows that pass take the exact sqrt and pack, so every kept
// key has K1's bits.  A t of +inf, or a bound whose high word is no finite
// float, cuts nothing.
__device__ __forceinline__ float sq_cut(u64 thr, float c) {
    if ((unsigned int)(thr >> 32) >= 0x7f800000u) return __int_as_float(0x7f800000);  // empty too
    const double t = (double)c * (double)__uint_as_float((unsigned int)(thr >> 32));
    return __double2float_ru(t * t * (1.0 + 0x1p-20) + 0x1p-140);
}

__device__ __forceinline__ double sq_cut(u128 thr, double c) {
    const u64 hb = (u64)(thr >> 32);
    if (hb >= 0x7ff0000000000000ull) return __longlong_as_double(0x7ff0000000000000ll);  // empty too
    const double t = __dmul_ru(c, __longlong_as_double((long long)hb));
    return __dadd_ru(__dmul_ru(__dmul_ru(t, t), 1.0 + 0x1p-48), 0x1p-1000);
}

__device__ __forceinline__ float step_bits(float s, int d) { return __int_as_float(__float_as_int(s) + d); }
__device__ __forceinline__ double step_bits(double s, int d) {
    return __longlong_as_double(__double_as_longlong(s) + d);
}

// K3's exact squared threshold: the largest s with sqrt_rn(s) <= t, so
// that for every squared bound s (>= -0, or NaN) sqrt_rn(s) <= t exactly when
// s <= sq_max(t).  A t below 0 or NaN passes nothing (-1); +inf passes every
// non-NaN s.  Starting from the rounded t * t, the preimage of t under
// sqrt_rn is a few ulps wide, so each loop steps a few times at most.
template <typename T>
__device__ T sq_max(T t) {
    const T inf = scalar_inf<T>();
    if (!(t >= T(0))) return T(-1);
    if (t == inf) return inf;
    T s = op_mul(t, t);
    while (s < inf) {
        const T up = step_bits(s, 1);
        if (!(op_sqrt(up) <= t)) break;
        s = up;
    }
    while (op_sqrt(s) > t) s = step_bits(s, -1);  // stops at +0: sqrt(0) <= t
    return s;
}

template <typename T>
__device__ __forceinline__ T min_of(T a, T b) { return b < a ? b : a; }

// Keep the k smallest of the n distinct keys in slot[0:n) (global or shared
// memory, n > k >= 1), moved to slot[0:k) in any order.  A radix select
// over 8-bit digits from the top of the key's KBITS finds the k-th smallest
// key, or stops at the first bucket that holds exactly the keys still
// needed; every thread gets back `bound`, the k-th key or the largest key
// of that bucket, and exactly k keys are <= bound.  Each pass over the slot
// loads kSelBatch keys per thread before using them, so the passes wait on
// L2 once per batch, not once per key.  hist: 256 ints; scratch: 3 + warps
// ints.
constexpr int kSelBatch = 6;

// The key's low KBITS bits set.
template <typename K, int KBITS>
__device__ __forceinline__ K low_bits() {
    if constexpr (KBITS == 8 * (int)sizeof(K)) {
        return ~(K)0;
    } else {
        return ((K)1 << KBITS) - 1;
    }
}

template <typename K, int KBITS>
__device__ K select_compact(K* slot, int n, int k, int* hist, int* scratch) {
    const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5;
    K prefix = 0, mask = 0;
    int need = k;
    for (int shift = KBITS - 8; shift >= 0; shift -= 8) {
        for (int i = tid; i < 256; i += T) hist[i] = 0;
        __syncthreads();
        for (int base = 0; base < n; base += kSelBatch * T) {
            K key[kSelBatch];
#pragma unroll
            for (int r = 0; r < kSelBatch; ++r) {
                const int i = base + r * T + tid;
                key[r] = i < n ? slot[i] : key_empty<K>();
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
        prefix |= (K)scratch[0] << shift;
        mask |= (K)255 << shift;
        need = scratch[1];
        const bool done = scratch[2] == need;
        __syncthreads();
        if (done) break;
    }
    // the digits not searched are free below the prefix; bits above KBITS
    // are 0 in every packed key (the empty key never lies in a slot)
    const K bound = prefix | (~mask & low_bits<K, KBITS>());
    // in-place compaction: a kept key moves to an index no larger than its
    // own, and a batch is loaded in full before any of its writes
    int* wcount = scratch + 3;
    int out = 0;
    for (int base = 0; base < n; base += kSelBatch * T) {
        K key[kSelBatch];
#pragma unroll
        for (int r = 0; r < kSelBatch; ++r) {
            const int i = base + r * T + tid;
            key[r] = i < n ? slot[i] : key_empty<K>();
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

// Move src[0:ns) to dst[0:ns), dst <= src, overlapping or not: each batch
// is loaded in full (a barrier) before any of its stores, and a store of
// batch b lands below every key of the later batches.
template <typename K>
__device__ void move_keys(K* dst, const K* src, int ns) {
    if (dst == src) return;
    const int T = blockDim.x, tid = threadIdx.x;
    for (int base = 0; base < ns; base += kSelBatch * T) {
        K key[kSelBatch];
#pragma unroll
        for (int r = 0; r < kSelBatch; ++r) {
            const int i = base + r * T + tid;
            if (i < ns) key[r] = src[i];
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < kSelBatch; ++r) {
            const int i = base + r * T + tid;
            if (i < ns) dst[i] = key[r];
        }
    }
    __syncthreads();
}

// One head-coordinate step of kGR dot products: q from shared memory as
// 16-byte broadcasts (float4 or double2).
template <int kGR>
__device__ __forceinline__ void dot_step(const float* qrow, float xi, float (&dot)[kGR]) {
    const float4* qv = reinterpret_cast<const float4*>(qrow);
#pragma unroll
    for (int v = 0; v < kGR / 4; ++v) {
        const float4 qq = qv[v];
        dot[4 * v] = op_fma(qq.x, xi, dot[4 * v]);
        dot[4 * v + 1] = op_fma(qq.y, xi, dot[4 * v + 1]);
        dot[4 * v + 2] = op_fma(qq.z, xi, dot[4 * v + 2]);
        dot[4 * v + 3] = op_fma(qq.w, xi, dot[4 * v + 3]);
    }
}

template <int kGR>
__device__ __forceinline__ void dot_step(const double* qrow, double xi, double (&dot)[kGR]) {
    const double2* qv = reinterpret_cast<const double2*>(qrow);
#pragma unroll
    for (int v = 0; v < kGR / 2; ++v) {
        const double2 qq = qv[v];
        dot[2 * v] = op_fma(qq.x, xi, dot[2 * v]);
        dot[2 * v + 1] = op_fma(qq.y, xi, dot[2 * v + 1]);
    }
}

// Shared memory of group_scan_kernel, in order: the group's head coordinates
// i-major qsT[i * Gp + g] (Gp = G rounded up to kGR, zero-padded), their
// |q|^2, altitudes and two cuts (scalars T); for K3 also its thresholds (T);
// with SPILL per-warp counts, select_compact's histogram and scratch (ints);
// then (16-byte aligned) per query the running selection (K2 without SPILL
// only: a spilling query keeps its kept keys in its part_keys slot in global
// memory), the candidate buffer, the running width-th best key, the
// candidate count and (SPILL) the slot's fill.  f32 K3 keeps the layout
// (and bytes) of the f32-only kernel.
template <typename T>
__host__ __device__ inline size_t group_head_bytes(int mode, bool spill, int Gp, int hd, int warps) {
    const size_t scalars = (size_t)Gp * (hd + 4) + (mode == kThreshold ? (size_t)Gp : 0);
    const size_t ints = spill ? (size_t)Gp * warps + 256 + 3 + warps : 0;
    return (scalars * sizeof(T) + ints * sizeof(int) + 15) / 16 * 16;
}
template <typename T>
__host__ __device__ inline size_t group_smem_bytes(int mode, bool spill, int G, int Gp, int hd, int wp,
                                                   int tl, int warps) {
    typedef typename KeyOf<T>::type K;
    return group_head_bytes<T>(mode, spill, Gp, hd, warps) +
           (size_t)G * ((spill ? 0 : wp) + tl + 1) * sizeof(K) + (size_t)G * (spill ? 2 : 1) * sizeof(int);
}

// K2 and K3 (G > 1, and every G of the wide plan): one block per (query
// group, slice).  cut1 is the selection's pre-filter cut; cut2 is K2's
// mid-key cut on the upper bound, and K3's exact count cut sq_max(t).  NW > 0
// (K3 at the widths the index uses): the table width n == NW at compile
// time, so each row is read once into registers (16-byte loads when `vec`:
// NW * sizeof(T) % 16 == 0 and the table 16-byte aligned) and the i loops
// unroll; NW == 0 reads the row's coordinates from global memory in each
// query chunk.  SPILL (K3 always; K2 in the wide plan) keeps each query's
// keys in its global slot instead of a shared-memory selection, and counts
// per (query, slice): K3 its passing rows, K2 the slice's live rows, so the
// slot ends with min(count, width) keys either way.
template <typename T, int MODE, int NW, bool SPILL, int kGR = group_regs(MODE)>
__global__ void group_scan_kernel(const T* __restrict__ table, int N, int n,
                                  const T* __restrict__ queries, int Q, int qw, int hd,
                                  const uint8_t* __restrict__ rowmask,
                                  const T* __restrict__ thresholds, int width, int wp, int tl,
                                  int G, int slice_rows, int slot, bool vec,
                                  typename KeyOf<T>::type* __restrict__ part_keys,
                                  int* __restrict__ part_counts) {
    typedef typename KeyOf<T>::type K;
    constexpr int KBITS = KeyOf<T>::kBits;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr bool kThr = MODE == kThreshold;
    static_assert(SPILL || !kThr, "K3 always spills");
    const int Gp = (G + kGR - 1) / kGR * kGR;
    const int T_ = blockDim.x;
    const int warps = T_ / 32;
    T* qsT = reinterpret_cast<T*>(smem_raw);  // hd * Gp
    T* q2s = qsT + (size_t)hd * Gp;           // Gp
    T* qas = q2s + Gp;                         // Gp
    T* cut1 = qas + Gp;                        // Gp
    T* cut2 = cut1 + Gp;                       // Gp
    T* tq = cut2 + Gp;                         // Gp (K3)
    int* wcnt = reinterpret_cast<int*>(tq + (kThr ? Gp : 0));    // warps * Gp (SPILL)
    int* hist = wcnt + (SPILL ? (size_t)warps * Gp : 0);          // 256 (SPILL)
    int* sscr = hist + (SPILL ? 256 : 0);                         // 3 + warps (SPILL)
    K* run_s = reinterpret_cast<K*>(smem_raw + group_head_bytes<T>(MODE, SPILL, Gp, hd, warps));
    K* cand = run_s + (SPILL ? 0 : (size_t)G * wp);  // G * tl (run_s: G * wp, K2 without SPILL)
    K* thr = cand + (size_t)G * tl;                  // G
    int* ncand = reinterpret_cast<int*>(thr + G);    // G
    int* filled = ncand + G;                         // G (SPILL)

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int q0 = blockIdx.x * G;
    const int gq = min(G, Q - q0);   // live queries of this group
    const int s = blockIdx.y;
    const int S = gridDim.y;
    auto slot_of = [&](int g) { return part_keys + ((size_t)(q0 + g) * S + s) * slot; };
    // SPILL: move g's candidates to its slot; when they would overflow it,
    // first keep the slot's `width` smallest keys (select_compact) and
    // tighten g's cuts to them
    auto spill = [&](int g, int nc) {
        K* sl = slot_of(g);
        int f = filled[g];
        if (f + nc > slot) {
            const K b = select_compact<K, KBITS>(sl, f, width, hist, sscr);
            f = width;
            if (tid == 0) {
                thr[g] = b;
                if (kThr) {
                    cut1[g] = min_of(cut2[g], sq_cut(b, T(1)));
                } else {
                    cut1[g] = sq_cut(b, T(1));
                    cut2[g] = sq_cut(b, T(2));
                }
            }
        }
        for (int i = tid; i < nc; i += T_) sl[f + i] = cand[(size_t)g * tl + i];
        __syncthreads();
        if (tid == 0) {
            filled[g] = f + nc;
            ncand[g] = 0;
        }
    };
    for (int e = tid; e < hd * Gp; e += T_) {
        const int i = e / Gp, g = e % Gp;
        qsT[e] = g < gq ? queries[(size_t)(q0 + g) * qw + i] : T(0);
    }
    for (int g = tid; g < Gp; g += T_) {
        T a = T(0), b = T(0);
        if (g < gq) row_terms(queries + (size_t)(q0 + g) * qw, hd, qw, a, b);
        q2s[g] = a;
        qas[g] = b;
        // padded slots never pass the pre-filter
        if (kThr) {
            const T t = g < gq ? thresholds[q0 + g] : T(-1);
            tq[g] = t;
            cut1[g] = cut2[g] = sq_max(t);
        } else {
            cut1[g] = cut2[g] = g < gq ? scalar_inf<T>() : T(-1);
        }
    }
    if (SPILL) {
        for (int i = tid; i < warps * Gp; i += T_) wcnt[i] = 0;
    } else {
        for (int i = tid; i < G * wp; i += T_) run_s[i] = key_empty<K>();
    }
    for (int g = tid; g < G; g += T_) {
        thr[g] = key_empty<K>();
        ncand[g] = 0;
        if (SPILL) filled[g] = 0;
    }
    __syncthreads();

    const int r0 = s * slice_rows;
    const int r1 = min(N, r0 + slice_rows);
    for (int base = r0; base < r1; base += T_) {
        const int row = base + tid;
        const bool valid = row < r1 && (rowmask == nullptr || rowmask[row]);
        if (SPILL && !kThr) {
            // K2's count: the slice's live rows, the same for every query
            const unsigned b = __ballot_sync(kFull, valid);
            if (lane == 0) wcnt[(size_t)(tid >> 5) * Gp] += __popc(b);
        }
        const T* x = table + (size_t)min(row, r1 - 1) * n;   // past r1: computed, never kept
        T x2, xa;
        T xr[NW > 0 ? NW : 1];
        if constexpr (NW > 0) {
            load_row(x, vec, xr);
            row_terms_reg(xr, hd, x2, xa);
        } else {
            row_terms(x, hd, n, x2, xa);
        }
        for (int g0 = 0; g0 < gq; g0 += kGR) {
            T dot[kGR];
#pragma unroll
            for (int r = 0; r < kGR; ++r) dot[r] = T(0);
            if constexpr (NW > 0) {
#pragma unroll
                for (int i = 0; i < NW; ++i) {
                    if (i < hd) dot_step<kGR>(qsT + (size_t)i * Gp + g0, xr[i], dot);
                }
            } else {
#pragma unroll 4
                for (int i = 0; i < hd; ++i) dot_step<kGR>(qsT + (size_t)i * Gp + g0, x[i], dot);
            }
            // the squared-domain pre-filter of all kGR slots first (straight-
            // line code), then one vote: most tiles have no candidate at all.
            // K3 also marks the rows it counts (lsq <= sq_max(t): exact).
            unsigned maybe = 0, hits = 0;
#pragma unroll
            for (int r = 0; r < kGR; ++r) {
                const int g = g0 + r;
                T lsq, usq;
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
                        K pk = key_empty<K>();
                        bool keep = m;
                        if (m) {
                            T lsq, usq;
                            bound_squares(q2s[g], qas[g], x2, xa, dot[r], lsq, usq);
                            const T l = op_sqrt(lsq);
                            T key = l;
                            if (kThr) {
                                keep = l <= tq[g];   // the compare itself, in T
                            } else if (MODE != kLwb) {
                                const T u = op_sqrt(usq);
                                key = MODE == kUpb ? u : op_mul(T(0.5), op_add(l, u));
                            }
                            pk = pack_key(key, row);
                        }
                        warp_append(keep && pk < thr[g], pk, cand + (size_t)g * tl, &ncand[g]);
                    }
                }
            }
        }
        __syncthreads();
        // fold (SPILL: spill) a buffer that might not hold the next tile; K2
        // also folds its first candidates as soon as they fill the selection
        // (that sets a threshold early)
        for (int g = 0; g < gq; ++g) {
            const int nc = ncand[g];
            if (SPILL) {
                if (nc > tl - T_) spill(g, nc);
            } else if (nc > tl - T_ || (thr[g] == key_empty<K>() && nc >= width)) {
                K* run = run_s + (size_t)g * wp;
                int len = wp;
                while (len < nc) len <<= 1;
                flush(run, cand + (size_t)g * tl, nc, wp, len);
                if (tid == 0) {
                    ncand[g] = 0;
                    thr[g] = run[width - 1];
                    cut1[g] = sq_cut(thr[g], T(1));
                    cut2[g] = sq_cut(thr[g], T(2));
                }
            }
        }
        __syncthreads();
    }
    if (SPILL) {
        // the slot ends with the slice's min(count, width) best keys, in
        // any order, where the gather reads them
        for (int g = 0; g < gq; ++g) {
            const int nc = ncand[g];
            if (nc > 0) spill(g, nc);
            __syncthreads();
            if (filled[g] > width) select_compact<K, KBITS>(slot_of(g), filled[g], width, hist, sscr);
        }
        for (int g = tid; g < gq; g += T_) {
            int c = 0;
            for (int w = 0; w < warps; ++w) c += wcnt[(size_t)w * Gp + (kThr ? g : 0)];
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
            K* out = slot_of(g);
            for (int i = tid; i < wp; i += T_) out[i] = run_s[(size_t)g * wp + i];
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
// Slice s's keys land in [n, n + ns) with n <= (s - s0) * wp, at or before
// its own slot ((s - s0) * slot, slot >= 2 wp).
template <typename K, int KBITS>
__global__ void select_gather_kernel(K* __restrict__ part_keys, const int* __restrict__ part_counts,
                                     int S, int width, int wp, int slot, K* __restrict__ gather) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    K* keys = reinterpret_cast<K*>(smem_raw);  // wp
    __shared__ int hist[256];
    __shared__ int scratch[3 + 32];
    const int q = blockIdx.x, m = blockIdx.y, M = gridDim.y;
    const int T = blockDim.x, tid = threadIdx.x;
    const int s0 = m * S / M, s1 = (m + 1) * S / M;
    K* region = part_keys + ((size_t)q * S + s0) * slot;
    int n = 0;
    for (int s = s0; s < s1; ++s) {
        const int ns = min(part_counts[(size_t)q * S + s], width);
        move_keys(region + n, region + (size_t)(s - s0) * slot, ns);
        n += ns;
    }
    if (n > width) {
        select_compact<K, KBITS>(region, n, width, hist, scratch);
        n = width;
    }
    int len = 1;
    while (len < n) len <<= 1;
    for (int i = tid; i < len; i += T) keys[i] = i < n ? region[i] : key_empty<K>();
    bitonic_sort(keys, len);
    K* out = gather + ((size_t)q * M + m) * wp;
    for (int i = tid; i < wp; i += T) out[i] = i < len ? keys[i] : key_empty<K>();
}

// Final merge: grid (Q).  Merges the query's P sorted partials of wp keys
// (K2: its slices' selections; K3: the gather's), sums part_counts over S
// slices in slice order (K3), and writes ids with their lwb/upb recomputed
// by pair_bounds() from the table row.
template <typename T>
__global__ void select_merge_kernel(const T* __restrict__ table, int n,
                                    const T* __restrict__ queries, int qw, int hd,
                                    const typename KeyOf<T>::type* __restrict__ parts, int P,
                                    const int* __restrict__ part_counts, int S, int width, int wp,
                                    int* __restrict__ ids, T* __restrict__ lwb,
                                    T* __restrict__ upb, int* __restrict__ counts) {
    typedef typename KeyOf<T>::type K;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    K* run = reinterpret_cast<K*>(smem_raw);  // wp
    K* cand = run + wp;                        // wp
    T* qs = reinterpret_cast<T*>(cand + wp);
    const int q = blockIdx.x;
    const K* part = parts + (size_t)q * P * wp;
    for (int i = threadIdx.x; i < wp; i += blockDim.x) run[i] = part[i];
    for (int i = threadIdx.x; i < qw; i += blockDim.x) qs[i] = queries[(size_t)q * qw + i];
    for (int p = 1; p < P; ++p) {
        __syncthreads();
        for (int i = threadIdx.x; i < wp; i += blockDim.x) cand[i] = part[(size_t)p * wp + i];
        merge_sorted(run, cand, wp);
    }
    __syncthreads();
    T q2, qa;
    row_terms(qs, hd, qw, q2, qa);
    for (int i = threadIdx.x; i < width; i += blockDim.x) {
        const K key = run[i];
        const size_t o = (size_t)q * width + i;
        if (key == key_empty<K>()) {
            ids[o] = kSentinelId;
            lwb[o] = scalar_inf<T>();
            upb[o] = scalar_inf<T>();
        } else {
            const int row = (int)(key & 0xffffffffu);
            const T* x = table + (size_t)row * n;
            T x2, xa, l, u;
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

// The wide plan's first merge level: grid (Q, M).  Block (q, m) moves the
// kept keys of slices [m * S / M, (m + 1) * S / M) (each slice's first
// min(count, width)) to the front of the first slot and keeps the width
// smallest there (select_compact), unsorted; gcount[q, m] is how many it
// kept.  Slice s's keys land at or before its own slot: the earlier slices
// left at most one slot's keys each.
template <typename K, int KBITS>
__global__ void wide_gather_kernel(K* __restrict__ part_keys, const int* __restrict__ part_counts,
                                   int S, int width, int slot, int* __restrict__ gcount) {
    __shared__ int hist[256];
    __shared__ int scratch[3 + 32];
    const int q = blockIdx.x, m = blockIdx.y, M = gridDim.y;
    const int s0 = m * S / M, s1 = (m + 1) * S / M;
    K* region = part_keys + ((size_t)q * S + s0) * slot;
    int n = 0;
    for (int s = s0; s < s1; ++s) {
        const int ns = min(part_counts[(size_t)q * S + s], width);
        move_keys(region + n, region + (size_t)(s - s0) * slot, ns);
        n += ns;
    }
    if (n > width) {
        select_compact<K, KBITS>(region, n, width, hist, scratch);
        n = width;
    }
    if (threadIdx.x == 0) gcount[(size_t)q * M + m] = n;
}

// One stable LSD radix pass of a block over src[0:n) -> dst by the 8-bit
// digit at `shift`: a histogram, its exclusive scan, then tiles of blockDim
// keys scattered in their order (a key's place among its digit's keys of
// the tile is its rank in its warp plus the counts of the earlier warps).
// hist, base: 256 ints; wdig: warps * 256 ints, zero on entry and on exit.
template <typename K>
__device__ void radix_pass(const K* src, K* dst, int n, int shift, int* hist, int* base, int* wdig) {
    const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31, warp = tid >> 5, warps = T / 32;
    for (int i = tid; i < 256; i += T) hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += T) {
        const int i = i0 + tid;
        const int d = i < n ? (int)(src[i] >> shift) & 255 : -1;
        const unsigned peers = __match_any_sync(kFull, d);
        if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
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
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            base[lane * 8 + j] = before;
            before += c[j];
        }
    }
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += T) {
        const int i = i0 + tid;
        K key = 0;
        int d = -1;
        if (i < n) {
            key = src[i];
            d = (int)(key >> shift) & 255;
        }
        const unsigned peers = __match_any_sync(kFull, d);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        if (d >= 0 && lane == __ffs(peers) - 1) wdig[warp * 256 + d] = __popc(peers);
        __syncthreads();
        if (d >= 0) {
            int off = base[d] + rank;
            for (int w = 0; w < warp; ++w) off += wdig[w * 256 + d];
            dst[off] = key;
        }
        __syncthreads();
        for (int dd = tid; dd < 256; dd += T) {
            int add = 0;
            for (int w = 0; w < warps; ++w) {
                add += wdig[w * 256 + dd];
                wdig[w * 256 + dd] = 0;
            }
            base[dd] += add;
        }
        __syncthreads();
    }
}

// The wide plan's last merge level: grid (Q).  Moves the query's M gather
// blocks' keys together (block m's keys lie at the start of its first
// slice's slot, past every earlier block's), keeps the width smallest
// (select_compact), and sorts them with KBITS / 8 stable radix passes from
// the low digit up, region -> buf_a -> buf_b -> ... -> buf_b (an even number
// of passes ends in buf_b).  nsel[q] is how many keys it kept.
template <typename K, int KBITS>
__global__ void wide_sort_kernel(K* __restrict__ part_keys, const int* __restrict__ gcount, int S, int M,
                                 int width, int slot, K* __restrict__ buf_a, K* __restrict__ buf_b,
                                 int* __restrict__ nsel) {
    static_assert((KBITS / 8) % 2 == 0, "the passes end in buf_b");
    __shared__ int hist[256];
    __shared__ int base[256];
    __shared__ int scratch[3 + 32];
    __shared__ int wdig[(kThreads / 32) * 256];
    const int q = blockIdx.x;
    K* region = part_keys + (size_t)q * S * slot;
    int n = 0;
    for (int m = 0; m < M; ++m) {
        const int c = gcount[(size_t)q * M + m];
        move_keys(region + n, region + (size_t)(m * S / M) * slot, c);
        n += c;
    }
    if (n > width) {
        select_compact<K, KBITS>(region, n, width, hist, scratch);
        n = width;
    }
    for (int i = threadIdx.x; i < (kThreads / 32) * 256; i += blockDim.x) wdig[i] = 0;
    __syncthreads();
    K* a = buf_a + (size_t)q * width;
    K* b = buf_b + (size_t)q * width;
    const K* src = region;
    for (int shift = 0; shift < KBITS; shift += 8) {
        K* dst = (shift / 8) % 2 == 0 ? a : b;
        radix_pass(src, dst, n, shift, hist, base, wdig);
        src = dst;
    }
    if (threadIdx.x == 0) nsel[q] = n;
}

// The wide plan's output: grid (ceil(width / blockDim), Q).  Slot i of
// query q is sorted[q, i] (i < nsel[q]) with its lwb/upb recomputed by
// pair_bounds() from the table row, else the sentinel with +inf bounds; K3's
// count is the sum of part_counts over the S slices in slice order.
template <typename T>
__global__ void select_write_kernel(const T* __restrict__ table, int n, const T* __restrict__ queries,
                                    int qw, int hd, const typename KeyOf<T>::type* __restrict__ sorted,
                                    const int* __restrict__ nsel, int width,
                                    const int* __restrict__ part_counts, int S, int* __restrict__ ids,
                                    T* __restrict__ lwb, T* __restrict__ upb, int* __restrict__ counts) {
    const int q = blockIdx.y;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (counts != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        int c = 0;
        for (int s = 0; s < S; ++s) c += part_counts[(size_t)q * S + s];
        counts[q] = c;
    }
    if (i >= width) return;
    const size_t o = (size_t)q * width + i;
    if (i >= nsel[q]) {
        ids[o] = kSentinelId;
        lwb[o] = scalar_inf<T>();
        upb[o] = scalar_inf<T>();
        return;
    }
    const T* qq = queries + (size_t)q * qw;
    T q2, qa;
    row_terms(qq, hd, qw, q2, qa);
    const int row = (int)(sorted[(size_t)q * width + i] & 0xffffffffu);
    const T* x = table + (size_t)row * n;
    T x2, xa, l, u;
    row_terms(x, hd, n, x2, xa);
    pair_bounds(qq, q2, qa, x, x2, xa, hd, l, u);
    ids[o] = row;
    lwb[o] = l;
    upb[o] = u;
}

int next_pow2(int w) {
    int p = 1;
    while (p < w) p <<= 1;
    return p;
}

template <typename T, int MODE>
int launch_partial(dim3 grid, size_t smem, cudaStream_t st, const T* table, int N, int n,
                   const T* queries, int qw, int hd, const uint8_t* rowmask, const T* thresholds,
                   int width, int wp, int tl, int slice_rows, int slot,
                   typename KeyOf<T>::type* part_keys, int* part_counts) {
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(select_partial_kernel<T, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    select_partial_kernel<T, MODE><<<grid, kThreads, smem, st>>>(table, N, n, queries, qw, hd, rowmask,
                                                                 thresholds, width, wp, tl, slice_rows,
                                                                 slot, part_keys, part_counts);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_merge(cudaStream_t st, const T* table, int n, const T* queries, int Q, int qw, int hd,
                 const typename KeyOf<T>::type* parts, int P, const int* part_counts, int slices,
                 int width, int wp, int* ids, T* lwb, T* upb, int* counts) {
    typedef typename KeyOf<T>::type K;
    const size_t q_bytes = ((size_t)qw * sizeof(T) + 15) / 16 * 16;
    const size_t msmem = (size_t)2 * wp * sizeof(K) + q_bytes;
    if (msmem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(select_merge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)msmem);
    if (e != cudaSuccess) return (int)e;
    select_merge_kernel<T><<<Q, kThreads, msmem, st>>>(table, n, queries, qw, hd, parts, P, part_counts,
                                                       slices, width, wp, ids, lwb, upb, counts);
    return (int)cudaGetLastError();
}

template <typename K, int KBITS>
int launch_gather(cudaStream_t st, K* part_keys, const int* part_counts, int Q, int slices, int M,
                  int width, int wp, int slot, K* gather) {
    const size_t gsmem = (size_t)wp * sizeof(K);
    cudaError_t e = cudaFuncSetAttribute(select_gather_kernel<K, KBITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsmem);
    if (e != cudaSuccess) return (int)e;
    select_gather_kernel<K, KBITS><<<dim3(Q, M), kThreads, gsmem, st>>>(part_keys, part_counts, slices,
                                                                        width, wp, slot, gather);
    return (int)cudaGetLastError();
}

template <typename T, int MODE, int NW, bool SPILL>
int launch_group(dim3 grid, size_t smem, cudaStream_t st, const T* table, int N, int n,
                 const T* queries, int Q, int qw, int hd, const uint8_t* rowmask,
                 const T* thresholds, int width, int wp, int tl, int G, int slice_rows, int slot,
                 typename KeyOf<T>::type* part_keys, int* part_counts) {
    if (smem > 232448) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(group_scan_kernel<T, MODE, NW, SPILL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const bool vec = reinterpret_cast<uintptr_t>(table) % 16 == 0;
    group_scan_kernel<T, MODE, NW, SPILL><<<grid, kThreads, smem, st>>>(
        table, N, n, queries, Q, qw, hd, rowmask, thresholds, width, wp, tl, G, slice_rows, slot, vec,
        part_keys, part_counts);
    return (int)cudaGetLastError();
}

// The spilling scan (K3, and K2 in the wide plan) at the table widths the
// index uses, with the row in registers; other widths read it per chunk.
template <typename T, int MODE>
int launch_spill_scan(dim3 grid, size_t smem, cudaStream_t st, const T* table, int N, int n,
                      const T* queries, int Q, int qw, int hd, const uint8_t* rowmask,
                      const T* thresholds, int width, int wp, int G, int slice_rows, int slot,
                      typename KeyOf<T>::type* part_keys, int* part_counts) {
#define SPILL_LAUNCH(NW)                                                                          \
    launch_group<T, MODE, NW, true>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask,      \
                                    thresholds, width, wp, kThrCand, G, slice_rows, slot,         \
                                    part_keys, part_counts)
    if constexpr (MODE != kThreshold) {
        return SPILL_LAUNCH(0);
    } else {
        switch (n) {
            case 10: return SPILL_LAUNCH(10);
            case 16: return SPILL_LAUNCH(16);
            case 20: return SPILL_LAUNCH(20);
            case 32: return SPILL_LAUNCH(32);
            default: return SPILL_LAUNCH(0);
        }
    }
#undef SPILL_LAUNCH
}

// K3: grouped scan (G >= 1) or one query per block (G = 0), then the gather
// (M = ceil(slices / kGatherSlices) blocks per query) and the merge.
// part_keys holds Q * slices slots of thr_slot(cap) keys, then the
// gather's Q * M * next_pow2(cap) keys.
template <typename T>
int run_threshold(const T* table, int N, int n, const T* queries, int Q, int qw, int dims,
                  const uint8_t* rowmask, const T* thresholds, int width, int G, int slices,
                  typename KeyOf<T>::type* part_keys, int* part_counts, int* ids, T* lwb, T* upb,
                  int* counts, void* stream) {
    typedef typename KeyOf<T>::type K;
    constexpr int KBITS = KeyOf<T>::kBits;
    if (width < 1 || width > kMaxWidth || width > N || slices < 1 || G < 0 || G > kMaxGroup ||
        (size_t)G * kThrCand * sizeof(K) > (size_t)kThrGroupBytes)
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
        const size_t q_bytes = ((size_t)qw * sizeof(T) + 15) / 16 * 16;
        const size_t smem = (size_t)(wp + tl) * sizeof(K) + q_bytes;
        err = launch_partial<T, kThreshold>(dim3(slices, Q), smem, st, table, N, n, queries, qw, hd,
                                            rowmask, thresholds, width, wp, tl, slice_rows, slot,
                                            part_keys, part_counts);
    } else {
        constexpr int gr = group_regs(kThreshold);
        const int Gp = (G + gr - 1) / gr * gr;
        const size_t smem = group_smem_bytes<T>(kThreshold, true, G, Gp, hd, wp, kThrCand, kThreads / 32);
        const dim3 grid((Q + G - 1) / G, slices);
        err = launch_spill_scan<T, kThreshold>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask,
                                               thresholds, width, wp, G, slice_rows, slot, part_keys,
                                               part_counts);
    }
    if (err != 0) return err;
    const int M = (slices + kGatherSlices - 1) / kGatherSlices;
    K* gather = part_keys + (size_t)Q * slices * slot;
    err = launch_gather<K, KBITS>(st, part_keys, part_counts, Q, slices, M, width, wp, slot, gather);
    if (err != 0) return err;
    return launch_merge<T>(st, table, n, queries, Q, qw, hd, gather, M, part_counts, slices, width, wp,
                           ids, lwb, upb, counts);
}

// K2: grouped scan, then the shared merge.
template <typename T>
int run_topk(int mode, const T* table, int N, int n, const T* queries, int Q, int qw, int dims,
             const uint8_t* rowmask, int width, int G, int slices, typename KeyOf<T>::type* part_keys,
             int* ids, T* lwb, T* upb, void* stream) {
    typedef typename KeyOf<T>::type K;
    if (width < 1 || width > kMaxWidth || width > N || slices < 1 || G < 1 || G > kMaxGroup)
        return (int)cudaErrorInvalidValue;
    const int wp = next_pow2(width);
    const int tl = wp > kMinCandGroup ? wp : kMinCandGroup;
    if (G > 1 && (size_t)G * (wp + tl) * sizeof(K) > (size_t)kGroupBytes) return (int)cudaErrorInvalidValue;
    if (Q == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const int hd = dims - 1;
    const int slice_rows = (N + slices - 1) / slices;
    int err;
    if (G == 1) {
        // one query per block (select_partial_kernel)
        const int tl1 = wp > kMinCand ? wp : kMinCand;
        const size_t q_bytes = ((size_t)qw * sizeof(T) + 15) / 16 * 16;
        const size_t smem1 = (size_t)(wp + tl1) * sizeof(K) + q_bytes;
        dim3 grid(slices, Q);
        switch (mode) {
            case kLwb: err = launch_partial<T, kLwb>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, wp, part_keys, nullptr); break;
            case kUpb: err = launch_partial<T, kUpb>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, wp, part_keys, nullptr); break;
            case kMid: err = launch_partial<T, kMid>(grid, smem1, st, table, N, n, queries, qw, hd, rowmask, nullptr, width, wp, tl1, slice_rows, wp, part_keys, nullptr); break;
            default: return (int)cudaErrorInvalidValue;
        }
    } else {
        const int gr = group_regs(mode);
        const int Gp = (G + gr - 1) / gr * gr;
        const size_t smem = group_smem_bytes<T>(mode, false, G, Gp, hd, wp, tl, kThreads / 32);
        dim3 grid((Q + G - 1) / G, slices);
        switch (mode) {
            case kLwb: err = launch_group<T, kLwb, 0, false>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, tl, G, slice_rows, wp, part_keys, nullptr); break;
            case kUpb: err = launch_group<T, kUpb, 0, false>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, tl, G, slice_rows, wp, part_keys, nullptr); break;
            case kMid: err = launch_group<T, kMid, 0, false>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, tl, G, slice_rows, wp, part_keys, nullptr); break;
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (err != 0) return err;
    return launch_merge<T>(st, table, n, queries, Q, qw, hd, part_keys, slices, nullptr, slices, width,
                           wp, ids, lwb, upb, nullptr);
}

// The global-memory plan of K2 (mode 0-2) and K3 (mode 3) at any width:
// the spilling scan into Q * slices slots of `slot` keys (slot >=
// min(thr_slot(wp), slice rows)), the gather, the select and sort, the
// write.  buf_a, buf_b: Q * width keys each; gcount: Q * ceil(slices / 8)
// ints; nsel: Q ints.
template <typename T>
int run_wide(int mode, const T* table, int N, int n, const T* queries, int Q, int qw, int dims,
             const uint8_t* rowmask, const T* thresholds, int width, int G, int slices, int slot,
             typename KeyOf<T>::type* part_keys, typename KeyOf<T>::type* buf_a,
             typename KeyOf<T>::type* buf_b, int* part_counts, int* gcount, int* nsel, int* ids, T* lwb,
             T* upb, int* counts, void* stream) {
    typedef typename KeyOf<T>::type K;
    constexpr int KBITS = KeyOf<T>::kBits;
    if (mode < kLwb || mode > kThreshold || width < 1 || width > N || slices < 1 || G < 1 ||
        G > kMaxGroup || (size_t)G * kThrCand * sizeof(K) > (size_t)kThrGroupBytes || Q > 65535)
        return (int)cudaErrorInvalidValue;
    const int wp = next_pow2(width);
    const int slice_rows = (N + slices - 1) / slices;
    const int need = thr_slot(wp) < slice_rows ? thr_slot(wp) : slice_rows;
    if (slot < need) return (int)cudaErrorInvalidValue;
    if (Q == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const int hd = dims - 1;
    const int gr = group_regs(mode);
    const int Gp = (G + gr - 1) / gr * gr;
    const size_t smem = group_smem_bytes<T>(mode, true, G, Gp, hd, wp, kThrCand, kThreads / 32);
    const dim3 grid((Q + G - 1) / G, slices);
    int err;
    switch (mode) {
        case kLwb: err = launch_spill_scan<T, kLwb>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, G, slice_rows, slot, part_keys, part_counts); break;
        case kUpb: err = launch_spill_scan<T, kUpb>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, G, slice_rows, slot, part_keys, part_counts); break;
        case kMid: err = launch_spill_scan<T, kMid>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, nullptr, width, wp, G, slice_rows, slot, part_keys, part_counts); break;
        default: err = launch_spill_scan<T, kThreshold>(grid, smem, st, table, N, n, queries, Q, qw, hd, rowmask, thresholds, width, wp, G, slice_rows, slot, part_keys, part_counts); break;
    }
    if (err != 0) return err;
    const int M = (slices + kGatherSlices - 1) / kGatherSlices;
    wide_gather_kernel<K, KBITS><<<dim3(Q, M), kThreads, 0, st>>>(part_keys, part_counts, slices, width,
                                                                  slot, gcount);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    wide_sort_kernel<K, KBITS><<<Q, kThreads, 0, st>>>(part_keys, gcount, slices, M, width, slot, buf_a,
                                                       buf_b, nsel);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    select_write_kernel<T><<<dim3((width + kThreads - 1) / kThreads, Q), kThreads, 0, st>>>(
        table, n, queries, qw, hd, buf_b, nsel, width, part_counts, slices, ids, lwb, upb,
        mode == kThreshold ? counts : nullptr);
    return (int)cudaGetLastError();
}

}  // namespace

// The entry points fall in six parts, each an instantiation of its own
// kernels: the build compiles this file once per part (-DREPRO_SELECT_PART=
// 0..5, one nvcc each, all started together) and links the six objects;
// without the macro every part is compiled.
#ifdef REPRO_SELECT_PART
#define SELECT_PART(p) (REPRO_SELECT_PART == (p))
#else
#define SELECT_PART(p) 1
#endif

// K2.  key_mode: 0 lwb, 1 upb, 2 mid; group: queries per block (G);
// part_keys: (Q, slices, next_pow2(k)) scratch of packed keys (u64 for an
// f32 table, 16-byte keys for an f64 table).
#if SELECT_PART(0)
extern "C" int repro_apex_topk(const float* table, int N, int n, const float* queries, int Q,
                               int qw, int dims, const uint8_t* rowmask, int key_mode, int k,
                               int group, int slices, void* part_keys, int* ids,
                               float* lwb, float* upb, void* stream) {
    return run_topk<float>(key_mode, table, N, n, queries, Q, qw, dims, rowmask, k, group, slices,
                           (u64*)part_keys, ids, lwb, upb, stream);
}

#endif

#if SELECT_PART(1)
extern "C" int repro_apex_topk_f64(const double* table, int N, int n, const double* queries, int Q,
                                   int qw, int dims, const uint8_t* rowmask, int key_mode, int k,
                                   int group, int slices, void* part_keys, int* ids,
                                   double* lwb, double* upb, void* stream) {
    return run_topk<double>(key_mode, table, N, n, queries, Q, qw, dims, rowmask, k, group, slices,
                            (u128*)part_keys, ids, lwb, upb, stream);
}

#endif

// K3.  group: queries per block (G >= 1), or 0 for one query per block (the
// first design); part_keys: Q * slices * thr_slot(wp)
// + Q * ceil(slices / 8) * wp keys, wp = next_pow2(cap); part_counts:
// (Q, slices).
#if SELECT_PART(2)
extern "C" int repro_apex_threshold(const float* table, int N, int n, const float* queries, int Q,
                                    int qw, int dims, const uint8_t* rowmask,
                                    const float* thresholds, int cap, int group, int slices,
                                    void* part_keys, int* part_counts, int* ids,
                                    float* lwb, float* upb, int* counts, void* stream) {
    return run_threshold<float>(table, N, n, queries, Q, qw, dims, rowmask, thresholds, cap, group,
                                slices, (u64*)part_keys, part_counts, ids, lwb, upb, counts, stream);
}

#endif

#if SELECT_PART(3)
extern "C" int repro_apex_threshold_f64(const double* table, int N, int n, const double* queries, int Q,
                                        int qw, int dims, const uint8_t* rowmask,
                                        const double* thresholds, int cap, int group, int slices,
                                        void* part_keys, int* part_counts, int* ids,
                                        double* lwb, double* upb, int* counts, void* stream) {
    return run_threshold<double>(table, N, n, queries, Q, qw, dims, rowmask, thresholds, cap, group,
                                 slices, (u128*)part_keys, part_counts, ids, lwb, upb, counts, stream);
}

#endif

// K2 (mode 0-2, thresholds and counts null) and K3 (mode 3) at any width:
// the global-memory plan (run_wide).
#if SELECT_PART(4)
extern "C" int repro_select_wide_f32(int mode, const float* table, int N, int n, const float* queries,
                                     int Q, int qw, int dims, const uint8_t* rowmask,
                                     const float* thresholds, int width, int group, int slices, int slot,
                                     void* part_keys, void* buf_a, void* buf_b, int* part_counts,
                                     int* gcount, int* nsel, int* ids, float* lwb, float* upb,
                                     int* counts, void* stream) {
    return run_wide<float>(mode, table, N, n, queries, Q, qw, dims, rowmask, thresholds, width, group,
                           slices, slot, (u64*)part_keys, (u64*)buf_a, (u64*)buf_b, part_counts, gcount,
                           nsel, ids, lwb, upb, counts, stream);
}

#endif

#if SELECT_PART(5)
extern "C" int repro_select_wide_f64(int mode, const double* table, int N, int n, const double* queries,
                                     int Q, int qw, int dims, const uint8_t* rowmask,
                                     const double* thresholds, int width, int group, int slices, int slot,
                                     void* part_keys, void* buf_a, void* buf_b, int* part_counts,
                                     int* gcount, int* nsel, int* ids, double* lwb, double* upb,
                                     int* counts, void* stream) {
    return run_wide<double>(mode, table, N, n, queries, Q, qw, dims, rowmask, thresholds, width, group,
                            slices, slot, (u128*)part_keys, (u128*)buf_a, (u128*)buf_b, part_counts,
                            gcount, nsel, ids, lwb, upb, counts, stream);
}
#endif
