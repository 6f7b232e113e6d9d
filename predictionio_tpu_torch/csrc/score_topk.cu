// Streaming score -> top-k for recommendation serving, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/topk.py score_topk /
// _topk_kernel: for each query row, the top k of Q . V^T (f32), with query
// rows at or past rows_valid zeroed, columns at or past n_valid set to
// -3.0e38, and ties broken towards the lowest column index.
//
// Bound on an H100 SXM: the larger of 2*B*d*Np FLOP at the 67 TFLOP/s f32
// rate outside the tensor cores, and 4*(B*d + Np*d + 2*B*k) bytes at
// 3.35 TB/s. At the serving path's largest bucket (B = 64, d = 64,
// Np = 28,672, k = 16) that is 234.9 MFLOP -> 3.51 us against 7.36 MB ->
// 2.20 us: operations bind. Below B = 40 the bytes of V bind (2.20 us).
//
// Every score becomes a 64-bit key whose unsigned order is (value
// descending, index ascending). Keys are distinct, so a row's top k is one
// set in one order, and any exact selection returns the reference's
// answer, ties included, whatever order blocks and warps run in. The key
// of an empty slot (past the end of V) is 0, below every real key. Scores
// are f32 FMA over the dimensions in order (no TF32, no bf16, no split
// sums), the same order in every instantiation, so a row's answer does not
// depend on its batch. The TPU kernel walks the item tiles in order on one
// core with a running (B, k) list in VMEM; blocks on the GPU run in no
// order, so the selection is split in two launches. The path is chosen by k.
//
// k <= 32, the serving path (it buckets k to 16):
//
//   Phase A, select_kernel<RB>, grid (item chunks x row groups of RB rows,
//   RB the next power of two of min(B, 64)), 8 warps a block. The chunks
//   are cut so that one row group gives about 132 blocks (the H100's SMs),
//   and each row group reads V once. The block stages its RB query rows
//   (gathered through ids) in shared memory, and V in tiles of 256 items x
//   32 dims, double-buffered with cp.async; both are zero-padded to a
//   multiple of 4 dims. The warps cover the tile as min(8, RB) warps along
//   rows x 8 / min(8, RB) along items; a lane holds up to 8 rows x 8 items
//   of scores in registers, so each 4 dims cost the warp's rows' float4
//   broadcast loads of Q and one float4 of V per item for up to 256 FMAs.
//   Each row's best k live in one warp, one key a lane, sorted. When a tile
//   is scored, a threshold filter keeps only what can enter: the k-th
//   largest of the lanes' best scores (k lanes hold a score at or above it)
//   and the list's k-th. What passes is
//   compacted, sorted by a bitonic network over the lanes and merged into
//   the list; more than 32 are pushed one at a time (push_key). The rows'
//   networks interleave so their shuffle latencies overlap. Warps that
//   share a row fold their lists as a tree, and the block writes k sorted
//   keys per row.
//
//   Phase B, merge_select_kernel, one block per row: each warp loads its
//   share of the row's sorted chunk lists at once and merges them as a
//   tree, then the 8 warps fold as a tree.
//
// 32 < k <= 1024, the first design, kept as it was:
//
//   Phase A, chunk_topk_kernel, grid (row blocks x item chunks). A block
//   gathers its RB query rows (Q[ids[r]]) into shared memory,
//   dimension-major so a thread's four rows are one 16-byte load, and
//   streams its chunk of V (256 items, or KP when that is more) through
//   shared memory in VT x DK tiles; each tile's global loads are issued
//   into registers while the previous tile is being scored. The chunk's
//   best KP keys are then selected without sorting the whole chunk: runs of
//   KP are sorted (bitonic, alternating direction), and rounds of "keep the
//   larger of each pair of runs, then bitonic-merge what is kept" halve the
//   keys until one sorted run is left.
//
//   Phase B, merge_topk_kernel, one block per row. It stages the chunks'
//   sorted lists through shared memory in groups and reduces each group
//   with the same halving rounds; a group's result is folded into the
//   running best KP the same way.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (predictionio_tpu_torch/ops/_build.py), bound through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 8;          // query rows per phase-A block
constexpr int MAX_CHUNK = 1024;  // the largest KP (a chunk holds at least KP items)
constexpr int MIN_CHUNK = 256;   // items per phase-A block when KP is smaller
constexpr int VT = 128;        // items per shared-memory V tile
constexpr int DK = 32;         // factor dims per shared-memory V tile
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = RB * VT / THREADS;   // 4
constexpr int LOADS = VT * DK / THREADS;             // 16 tile loads per thread
constexpr int MERGE_KEYS = 4096;                     // phase B: lists staged per group
constexpr float NEG = -3.0e38f;

static_assert(RB * VT % THREADS == 0, "row split");
static_assert(ROWS_PER_THREAD == 4, "a thread's rows are one float4 of Q");
static_assert(VT * DK % THREADS == 0, "tile split");
static_assert((MAX_CHUNK & (MAX_CHUNK - 1)) == 0 && (MIN_CHUNK & (MIN_CHUNK - 1)) == 0,
              "chunk widths are powers of two");
static_assert(MIN_CHUNK % VT == 0, "a chunk is whole V tiles");
static_assert(MAX_CHUNK <= MERGE_KEYS, "phase B stages at least one list");

__device__ __forceinline__ uint64_t make_key(float v, int col) {
    uint32_t u = __float_as_uint(v);
    if (u == 0x80000000u) u = 0u;  // -0.0 ranks as +0.0, as in a float compare
    uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<uint64_t>(o) << 32) |
           static_cast<uint64_t>(0xFFFFFFFFu - static_cast<uint32_t>(col));
}

__device__ __forceinline__ float key_value(uint64_t key) {
    uint32_t o = static_cast<uint32_t>(key >> 32);
    uint32_t u = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
    return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(uint64_t key) {
    return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// Selection of the best kp keys of each of `rows` rows (n keys each, n and
// kp powers of two, kp <= n, row stride n), with every thread of the block.
// Sizes are powers of two, so all index arithmetic is shifts and masks.
__device__ void sort_runs(uint64_t* keys, int rows, int n, int kp) {
    // runs of kp sorted: run q descending if q is even, else ascending
    const int lg_half = __ffs(n) - 2;          // log2(n / 2)
    for (int size = 2; size <= kp; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < (rows << lg_half); t += blockDim.x) {
                int r = t >> lg_half;
                int p = t & ((1 << lg_half) - 1);
                int i = 2 * p - (p & (stride - 1));
                uint64_t* row = keys + static_cast<size_t>(r) * n;
                uint64_t a = row[i];
                uint64_t b = row[i + stride];
                bool desc = (i & size) == 0;
                if ((a < b) == desc) {
                    row[i] = b;
                    row[i + stride] = a;
                }
            }
            __syncthreads();
        }
    }
}

// Halving rounds over runs of kp sorted as sort_runs leaves them: the pair
// (run m*2S descending, run m*2S+S ascending) is a bitonic sequence, so the
// elementwise larger of the two is its best kp, itself bitonic; merge it in
// place, descending for even m and ascending for odd m, ready for the next
// round. The best kp of the row end up sorted descending at its start.
__device__ void halve_runs(uint64_t* keys, int rows, int n, int kp) {
    const int lg_kp = __ffs(kp) - 1;
    for (int S = kp; S < n; S <<= 1) {
        const int lg_pairs = __ffs(n) - __ffs(S) - 1;   // log2(n / 2S)
        const int lg_row = lg_pairs + lg_kp;
        for (int t = threadIdx.x; t < (rows << lg_row); t += blockDim.x) {
            int r = t >> lg_row;
            int u = t & ((1 << lg_row) - 1);
            int m = u >> lg_kp;
            int i = m * 2 * S + (u & (kp - 1));
            uint64_t* row = keys + static_cast<size_t>(r) * n;
            uint64_t b = row[i + S];
            if (row[i] < b) row[i] = b;
        }
        __syncthreads();
        if (kp < 2) continue;
        const int lg_hk = lg_kp - 1;
        const int lg_row_m = lg_pairs + lg_hk;
        for (int stride = kp >> 1; stride > 0; stride >>= 1) {
            for (int t = threadIdx.x; t < (rows << lg_row_m); t += blockDim.x) {
                int r = t >> lg_row_m;
                int u = t & ((1 << lg_row_m) - 1);
                int m = u >> lg_hk;
                int p = u & ((1 << lg_hk) - 1);
                int i = m * 2 * S + 2 * p - (p & (stride - 1));
                uint64_t* row = keys + static_cast<size_t>(r) * n;
                uint64_t a = row[i];
                uint64_t b = row[i + stride];
                bool desc = (m & 1) == 0;
                if ((a < b) == desc) {
                    row[i] = b;
                    row[i + stride] = a;
                }
            }
            __syncthreads();
        }
    }
}

__device__ __forceinline__ void select_top_runs(uint64_t* keys, int rows, int n, int kp) {
    sort_runs(keys, rows, n, kp);
    halve_runs(keys, rows, n, kp);
}

__device__ __forceinline__ void load_tile(const float* __restrict__ V, int np, int d,
                                          int col_base, int k0, float (&buf)[LOADS]) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
        int t = threadIdx.x + l * THREADS;
        int it = t / DK;
        int c = t - it * DK;
        int col = col_base + it;
        int dim = k0 + c;
        buf[l] = (col < np && dim < d) ? __ldg(V + static_cast<size_t>(col) * d + dim) : 0.0f;
    }
}

__global__ void __launch_bounds__(THREADS)
chunk_topk_kernel(const float* __restrict__ Q, int nq,
                  const int* __restrict__ ids,
                  const float* __restrict__ V, int np, int d,
                  int B, int rows_valid, int n_valid, int kp, int chunk_w,
                  int n_chunks, uint64_t* __restrict__ cand) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* keys = reinterpret_cast<uint64_t*>(smem);             // RB x chunk_w
    float* qs = reinterpret_cast<float*>(keys + RB * chunk_w);        // d x RB
    float* vs = qs + RB * d;                                          // VT x (DK+1)

    const int row0 = blockIdx.x * RB;
    const int chunk = blockIdx.y;
    const int col0 = chunk * chunk_w;
    const int nrows = min(RB, B - row0);

    float pre[LOADS];
    load_tile(V, np, d, col0, 0, pre);   // in flight while Q is gathered

    for (int t = threadIdx.x; t < RB * d; t += blockDim.x) {
        int r = t / d;
        int c = t - r * d;
        int row = row0 + r;
        float v = 0.0f;
        if (r < nrows && row < rows_valid) {
            int src = ids ? ids[row] : row;
            src = min(max(src, 0), nq - 1);   // out-of-range ids clamp, as a JAX gather does
            v = Q[static_cast<size_t>(src) * d + c];
        }
        qs[c * RB + r] = v;
    }

    const int j = threadIdx.x % VT;                       // this thread's item in the tile
    const int r0 = (threadIdx.x / VT) * ROWS_PER_THREAD;   // its first query row
    const int kt = (d + DK - 1) / DK;
    const int n_tiles = (chunk_w / VT) * kt;
    float acc[ROWS_PER_THREAD];
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int t0 = (tile / kt) * VT;
        const int k0 = (tile - (tile / kt) * kt) * DK;
        if (k0 == 0) {
#pragma unroll
            for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0.0f;
        }
        __syncthreads();  // the previous tile is scored (and, first, qs is set)
#pragma unroll
        for (int l = 0; l < LOADS; ++l) {
            int t = threadIdx.x + l * THREADS;
            int it = t / DK;
            vs[it * (DK + 1) + (t - it * DK)] = pre[l];
        }
        __syncthreads();
        if (tile + 1 < n_tiles) {
            const int nt = tile + 1;
            load_tile(V, np, d, col0 + (nt / kt) * VT, (nt - (nt / kt) * kt) * DK, pre);
        }
        if (r0 < nrows) {  // rows past the batch are never ranked
            const int kmax = min(DK, d - k0);
            const float* vrow = vs + j * (DK + 1);
            const float* qcol = qs + k0 * RB + r0;
            for (int c = 0; c < kmax; ++c) {
                const float v = vrow[c];
                const float4 q = *reinterpret_cast<const float4*>(qcol + c * RB);
                acc[0] = fmaf(q.x, v, acc[0]);
                acc[1] = fmaf(q.y, v, acc[1]);
                acc[2] = fmaf(q.z, v, acc[2]);
                acc[3] = fmaf(q.w, v, acc[3]);
            }
        }
        if (k0 + DK >= d) {
            const int col = col0 + t0 + j;
#pragma unroll
            for (int r = 0; r < ROWS_PER_THREAD; ++r) {
                uint64_t key = 0;  // empty slot past the end of V
                if (col < np) key = make_key(col < n_valid ? acc[r] : NEG, col);
                keys[(r0 + r) * chunk_w + t0 + j] = key;
            }
        }
    }
    __syncthreads();

    select_top_runs(keys, nrows, chunk_w, kp);

    for (int t = threadIdx.x; t < nrows * kp; t += blockDim.x) {
        int r = t / kp;
        int c = t - r * kp;
        size_t dst = (static_cast<size_t>(row0 + r) * n_chunks + chunk) * kp + c;
        cand[dst] = keys[r * chunk_w + c];
    }
}

__global__ void __launch_bounds__(THREADS)
merge_topk_kernel(const uint64_t* __restrict__ cand, int n_chunks, int kp, int k,
                  int group, float* __restrict__ out_vals, int* __restrict__ out_idx) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* best = reinterpret_cast<uint64_t*>(smem);   // kp, descending
    uint64_t* lists = best + kp;                           // group x kp
    const int row = blockIdx.x;
    const int lg_kp = __ffs(kp) - 1;
    const uint64_t* src = cand + static_cast<size_t>(row) * n_chunks * kp;

    for (int g0 = 0; g0 < n_chunks; g0 += group) {
        const int cnt = min(group, n_chunks - g0);
        int runs = 1;
        while (runs < cnt) runs <<= 1;
        __syncthreads();  // the previous group is folded into best
        // stage the group's lists as runs for halve_runs: odd runs
        // reversed (ascending), missing runs empty (key 0)
        for (int t = threadIdx.x; t < (runs << lg_kp); t += blockDim.x) {
            int q = t >> lg_kp;
            int e = t & (kp - 1);
            lists[t] = q < cnt
                ? src[static_cast<size_t>(g0 + q) * kp + ((q & 1) ? kp - 1 - e : e)]
                : 0ull;
        }
        __syncthreads();
        halve_runs(lists, 1, runs << lg_kp, kp);   // ends in a barrier
        if (g0 == 0) {
            for (int p = threadIdx.x; p < kp; p += blockDim.x) best[p] = lists[p];
            continue;
        }
        // best (descending) ++ the group's run reversed (ascending) is
        // bitonic: keep the larger of each pair, then merge the kept half
        for (int p = threadIdx.x; p < kp; p += blockDim.x) {
            uint64_t b = lists[kp - 1 - p];
            if (best[p] < b) best[p] = b;
        }
        __syncthreads();
        for (int stride = kp / 2; stride > 0; stride >>= 1) {
            for (int p = threadIdx.x; p < kp / 2; p += blockDim.x) {
                int i = 2 * p - (p & (stride - 1));
                uint64_t a = best[i];
                uint64_t b = best[i + stride];
                if (a < b) {
                    best[i] = b;
                    best[i + stride] = a;
                }
            }
            __syncthreads();
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
        uint64_t key = best[t];
        out_vals[static_cast<size_t>(row) * k + t] = key_value(key);
        out_idx[static_cast<size_t>(row) * k + t] = key_index(key);
    }
}

// ---- k <= 32: register-blocked scores, a warp-held list per row ----------

constexpr int SEL_MAX_K = 32;       // a row's list is one warp, one key a lane
constexpr int SEL_THREADS = 256;    // 8 warps
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int SEL_TILE = 256;       // items per V tile
constexpr int SEL_DK = 32;          // dims per V tile
constexpr int SEL_SV = SEL_DK + 4;  // floats per tile row: 9 float4s, an odd count, so
                                    // 8 lanes' float4 loads of 8 rows hit 8 bank groups
constexpr int SEL_MAX_RB = 64;      // query rows per block at most
constexpr int SEL_BLOCKS = 132;     // phase-A blocks to aim for per launch: the H100's SMs
constexpr int SEL_MIN_CHUNK = 64;   // items per chunk at least
constexpr int SEL_MAX_SMEM = 232448;  // the most shared memory a block can take (227 KB)
constexpr int MERGE_LISTS = (SEL_BLOCKS + SEL_WARPS - 1) / SEL_WARPS;   // phase B: lists a warp
                                                                       // loads (all of them)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr size_t SEL_VBYTES = sizeof(float) * 2 * SEL_TILE * SEL_SV;

static_assert(SEL_TILE * SEL_DK / 4 % SEL_THREADS == 0, "16-byte tile split");
static_assert(SEL_TILE * SEL_DK % SEL_THREADS == 0, "4-byte tile split");
static_assert(SEL_WARPS * 32 * sizeof(uint64_t) <= SEL_VBYTES, "the fold fits in the V tiles");
static_assert((SEL_SV / 4) % 2 == 1, "odd float4 stride");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint64_t shfl_key(uint64_t v, int src) {
    return __shfl_sync(FULL, static_cast<unsigned long long>(v), src);
}

// Insert x into the warp's sorted list (lane i holds the i-th largest key),
// for an x above the list's k-th key: the lanes below x keep theirs, lane
// pos takes x, the lanes after it shift down by one.
__device__ __forceinline__ void push_key(uint64_t& list, uint64_t x, int lane) {
    const int pos = __popc(__ballot_sync(FULL, list > x));
    const uint64_t up = __shfl_up_sync(FULL, static_cast<unsigned long long>(list), 1);
    list = lane < pos ? list : (lane == pos ? x : up);
}

__device__ __forceinline__ uint64_t shfl_xor(uint64_t v, int mask) {
    return __shfl_xor_sync(FULL, static_cast<unsigned long long>(v), mask);
}
__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) { return a > b ? a : b; }
__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float shfl_val(float v, int src) { return __shfl_sync(FULL, v, src); }
__device__ __forceinline__ float shfl_xor(float v, int mask) {
    return __shfl_xor_sync(FULL, v, mask);
}
__device__ __forceinline__ float kmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float kmin(float a, float b) { return fminf(a, b); }

// N warp lists (one key or score a lane each) sorted descending: a bitonic
// network over the lanes, the N lists' steps interleaved so that their
// shuffle latencies overlap.
template <int N, typename T>
__device__ __forceinline__ void sort_desc(T (&key)[N], int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
#pragma unroll
            for (int i = 0; i < N; ++i) {
                const T other = shfl_xor(key[i], stride);
                key[i] = keep_max ? kmax(key[i], other) : kmin(key[i], other);
            }
        }
}

// The best 32 keys of two descending warp lists, descending: the larger of
// each lane of one list and the other reversed is bitonic, and a bitonic
// merge sorts it. N pairs at once, interleaved.
template <int N>
__device__ __forceinline__ void merge_desc(uint64_t (&list)[N], const uint64_t (&sorted)[N],
                                           int lane) {
#pragma unroll
    for (int i = 0; i < N; ++i) list[i] = kmax(list[i], shfl_key(sorted[i], 31 - lane));
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const uint64_t other = shfl_xor(list[i], stride);
            list[i] = (lane & stride) == 0 ? kmax(list[i], other) : kmin(list[i], other);
        }
}

__device__ __forceinline__ uint64_t merge_desc(uint64_t list, uint64_t sorted, int lane) {
    uint64_t l[1] = {list};
    const uint64_t s1[1] = {sorted};
    merge_desc<1>(l, s1, lane);
    return l[0];
}

// Push every key of the warp (one a lane) above the list's k-th into the
// list, lowest lane first, one at a time: the threshold rises with each.
__device__ __forceinline__ void offer(uint64_t& list, uint64_t key, int lane, int k) {
    uint64_t thr = shfl_key(list, k - 1);
    unsigned b = __ballot_sync(FULL, key > thr);
    while (b) {
        const int src = __ffs(b) - 1;
        push_key(list, shfl_key(key, src), lane);
        thr = shfl_key(list, k - 1);
        b = __ballot_sync(FULL, key > thr) & ~((2u << src) - 1u);
    }
}

// Fold the lists of the `ways` warps that share a row (warps w .. w+ways-1,
// w a multiple of ways) into the first one's, as a tree through shared memory
// (fl: one list of 32 keys per warp). Every thread of the block calls it.
__device__ __forceinline__ void fold_warps(uint64_t& list, uint64_t* fl, int ways, int warp,
                                           int lane) {
    for (int step = 1; step < ways; step <<= 1) {
        fl[warp * 32 + lane] = list;
        __syncthreads();
        if ((warp & (2 * step - 1)) == 0) list = merge_desc(list, fl[(warp + step) * 32 + lane], lane);
        __syncthreads();
    }
}

// cp.async with zero fill: `bytes` of the copy come from gmem, the rest are 0
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(s), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy items [col_base, col_base + SEL_TILE) x dims [k0, k0 + SEL_DK) of V
// into a tile (item-major, SEL_SV floats a row); items at or past col_end
// and dims at or past d are zero. vec: 16-byte copies (d % 4 == 0, V
// 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void stage_v(float* buf, const float* __restrict__ V, int d,
                                        bool vec, int col_base, int col_end, int k0) {
    if (vec) {
#pragma unroll
        for (int l = 0; l < SEL_TILE * SEL_DK / 4 / SEL_THREADS; ++l) {
            const int t = threadIdx.x + l * SEL_THREADS;
            const int item = t / (SEL_DK / 4), q = t % (SEL_DK / 4);
            const int col = col_base + item, dim = k0 + 4 * q;
            const bool ok = col < col_end && dim < d;
            const float* src = ok ? V + static_cast<size_t>(col) * d + dim : V;
            cp_async16_zfill(buf + item * SEL_SV + 4 * q, src, ok ? 16 : 0);
        }
    } else {
#pragma unroll 8
        for (int l = 0; l < SEL_TILE * SEL_DK / SEL_THREADS; ++l) {
            const int t = threadIdx.x + l * SEL_THREADS;
            const int item = t / SEL_DK, c = t % SEL_DK;
            const int col = col_base + item, dim = k0 + c;
            const bool ok = col < col_end && dim < d;
            const float* src = ok ? V + static_cast<size_t>(col) * d + dim : V;
            cp_async4_zfill(buf + item * SEL_SV + c, src, ok ? 4 : 0);
        }
    }
}

template <int RB>
__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const float* __restrict__ Q, int nq, const int* __restrict__ ids,
              const float* __restrict__ V, int np, int d, int vec,
              int B, int rows_valid, int n_valid, int k, int chunk_w, int n_chunks,
              uint64_t* __restrict__ cand) {
    constexpr int WR = RB < SEL_WARPS ? RB : SEL_WARPS;   // warps along rows
    constexpr int WI = SEL_WARPS / WR;                    // warps along items
    constexpr int RW = RB / WR;                           // rows a warp owns
    constexpr int TI = SEL_TILE / (32 * WI);              // items a lane owns
    extern __shared__ __align__(16) unsigned char smem[];
    float* vs = reinterpret_cast<float*>(smem);           // 2 x SEL_TILE x SEL_SV
    float* qs = vs + 2 * SEL_TILE * SEL_SV;               // RB x dp, row-major
    const int dp = (d + 3) & ~3;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // this warp's RW candidate buffers of 32 keys, after qs
    uint64_t* cbuf = reinterpret_cast<uint64_t*>(qs + RB * dp) + warp * RW * 32;
    const int wr = warp / WI, wi = warp - wr * WI;
    const int row0 = blockIdx.y * RB;
    const int chunk = blockIdx.x;
    const int col0 = chunk * chunk_w;
    const int col_end = min(col0 + chunk_w, np);
    const int kt = (dp + SEL_DK - 1) / SEL_DK;
    const int n_stages = ((col_end - col0 + SEL_TILE - 1) / SEL_TILE) * kt;
    const bool live = row0 + wr * RW < B;   // rows past the batch are never ranked

    stage_v(vs, V, d, vec, col0, col_end, 0);   // in flight while Q is gathered
    cp_async_commit();
    for (int t = threadIdx.x; t < RB * dp; t += SEL_THREADS) {
        const int r = t / dp, c = t - r * dp;
        const int row = row0 + r;
        float v = 0.0f;
        if (row < B && row < rows_valid && c < d) {
            int src = ids ? ids[row] : row;
            src = min(max(src, 0), nq - 1);   // out-of-range ids clamp, as a JAX gather does
            v = Q[static_cast<size_t>(src) * d + c];
        }
        qs[t] = v;
    }

    uint64_t list[RW];
    float acc[RW][TI];
#pragma unroll
    for (int i = 0; i < RW; ++i) list[i] = 0;

    for (int s = 0; s < n_stages; ++s) {
        const int tile = s / kt, kc = s - tile * kt;
        if (s + 1 < n_stages) {
            const int nt = (s + 1) / kt;
            stage_v(vs + ((s + 1) & 1) * SEL_TILE * SEL_SV, V, d, vec,
                    col0 + nt * SEL_TILE, col_end, (s + 1 - nt * kt) * SEL_DK);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();   // stage s (and, first, qs) is in shared memory
        if (live) {
            if (kc == 0) {
#pragma unroll
                for (int i = 0; i < RW; ++i)
#pragma unroll
                    for (int t = 0; t < TI; ++t) acc[i][t] = 0.0f;
            }
            const int k0 = kc * SEL_DK;
            const int dk = min(SEL_DK, dp - k0);
            const float* qb = qs + wr * RW * dp + k0;
            const float* vl = vs + (s & 1) * SEL_TILE * SEL_SV +
                              (wi * 32 * TI + lane) * SEL_SV;
            for (int c = 0; c < dk; c += 4) {
                float4 q[RW], v[TI];
#pragma unroll
                for (int i = 0; i < RW; ++i)
                    q[i] = *reinterpret_cast<const float4*>(qb + i * dp + c);
#pragma unroll
                for (int t = 0; t < TI; ++t)
                    v[t] = *reinterpret_cast<const float4*>(vl + t * 32 * SEL_SV + c);
                // dim c of every (row, item), then dim c + 1, ...: back-to-back
                // FMAs are independent, and each score still sums in dim order
#pragma unroll
                for (int t = 0; t < TI; ++t)
#pragma unroll
                    for (int i = 0; i < RW; ++i) acc[i][t] = fmaf(q[i].x, v[t].x, acc[i][t]);
#pragma unroll
                for (int t = 0; t < TI; ++t)
#pragma unroll
                    for (int i = 0; i < RW; ++i) acc[i][t] = fmaf(q[i].y, v[t].y, acc[i][t]);
#pragma unroll
                for (int t = 0; t < TI; ++t)
#pragma unroll
                    for (int i = 0; i < RW; ++i) acc[i][t] = fmaf(q[i].z, v[t].z, acc[i][t]);
#pragma unroll
                for (int t = 0; t < TI; ++t)
#pragma unroll
                    for (int i = 0; i < RW; ++i) acc[i][t] = fmaf(q[i].w, v[t].w, acc[i][t]);
            }
            if (kc == kt - 1) {   // the tile is scored: select from its keys
                const int base = col0 + tile * SEL_TILE + wi * 32 * TI + lane;
                auto score = [&](int i, int t) {   // what the key ranks by
                    return base + t * 32 < n_valid ? acc[i][t] : NEG;
                };
                auto key_of = [&](int i, int t) -> uint64_t {
                    const int col = base + t * 32;
                    return col < col_end ? make_key(score(i, t), col) : 0ull;
                };
                if constexpr (TI == 1) {   // the lanes' keys are the tile's: sort, merge
                    uint64_t top[RW];
#pragma unroll
                    for (int i = 0; i < RW; ++i) top[i] = key_of(i, 0);
                    sort_desc<RW>(top, lane);
                    merge_desc<RW>(list, top, lane);
                } else {
                    // threshold filter, on the scores: k lanes hold a score at
                    // or above the k-th largest of the lanes' best, so the
                    // tile's top k is at or above it; the list's k-th bars
                    // what cannot enter. Ties at the threshold pass, so the
                    // keys that pass hold every key that can enter.
                    float lo[RW];
#pragma unroll
                    for (int i = 0; i < RW; ++i) {
                        lo[i] = neg_inf();
#pragma unroll
                        for (int t = 0; t < TI; ++t)
                            if (base + t * 32 < col_end) lo[i] = fmaxf(lo[i], score(i, t));
                    }
                    sort_desc<RW>(lo, lane);
                    int cnt[RW];
                    const unsigned below = (1u << lane) - 1u;
#pragma unroll
                    for (int i = 0; i < RW; ++i) {
                        const uint64_t thr = shfl_key(list[i], k - 1);
                        lo[i] = fmaxf(shfl_val(lo[i], k - 1), thr ? key_value(thr) : neg_inf());
                        cnt[i] = 0;
#pragma unroll
                        for (int t = 0; t < TI; ++t) {
                            const bool pass = base + t * 32 < col_end && score(i, t) >= lo[i];
                            const unsigned b = __ballot_sync(FULL, pass);
                            const int pos = cnt[i] + __popc(b & below);
                            if (pass && pos < 32) cbuf[i * 32 + pos] = key_of(i, t);
                            cnt[i] += __popc(b);
                        }
                    }
                    __syncwarp();
                    uint64_t top[RW];
#pragma unroll
                    for (int i = 0; i < RW; ++i)
                        top[i] = cnt[i] <= 32 && lane < cnt[i] ? cbuf[i * 32 + lane] : 0ull;
                    sort_desc<RW>(top, lane);
                    merge_desc<RW>(list, top, lane);
#pragma unroll
                    for (int i = 0; i < RW; ++i)
                        if (cnt[i] > 32) {   // more than a batch passed: push them
#pragma unroll
                            for (int t = 0; t < TI; ++t) {
                                const bool pass = base + t * 32 < col_end && score(i, t) >= lo[i];
                                offer(list[i], pass ? key_of(i, t) : 0ull, lane, k);
                            }
                        }
                    __syncwarp();   // cbuf is read before the next tile writes it
                }
            }
        }
        __syncthreads();   // stage s is read before stage s + 2 overwrites it
    }

    if constexpr (WI > 1)   // RW == 1: the WI warps of a row fold into the first
        fold_warps(list[0], reinterpret_cast<uint64_t*>(smem), WI, warp, lane);
    if (wi == 0 && lane < k) {
#pragma unroll
        for (int i = 0; i < RW; ++i) {
            const int row = row0 + wr * RW + i;
            if (row < B) cand[(static_cast<size_t>(row) * n_chunks + chunk) * k + lane] = list[i];
        }
    }
}

__global__ void __launch_bounds__(SEL_THREADS)
merge_select_kernel(const uint64_t* __restrict__ cand, int n_chunks, int k,
                    float* __restrict__ out_vals, int* __restrict__ out_idx) {
    __shared__ uint64_t fl[SEL_WARPS * 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const size_t row = blockIdx.x;
    const uint64_t* src = cand + row * n_chunks * k;
    // warp w takes lists w, w + 8, ... (each sorted, one key a lane; there
    // are at most SEL_BLOCKS) and merges them as a tree
    uint64_t key[MERGE_LISTS];
#pragma unroll
    for (int u = 0; u < MERGE_LISTS; ++u) {
        const int j = warp + u * SEL_WARPS;
        key[u] = j < n_chunks && lane < k ? src[static_cast<size_t>(j) * k + lane] : 0ull;
    }
#pragma unroll
    for (int w = 1; w < MERGE_LISTS; w <<= 1)
#pragma unroll
        for (int u = 0; u + w < MERGE_LISTS; u += 2 * w) key[u] = merge_desc(key[u], key[u + w], lane);
    uint64_t list = key[0];
    fold_warps(list, fl, SEL_WARPS, warp, lane);
    if (warp == 0 && lane < k) {
        out_vals[row * k + lane] = key_value(list);
        out_idx[row * k + lane] = key_index(list);
    }
}

int next_pow2(int x) {
    int p = 1;
    while (p < x) p <<= 1;
    return p;
}

int chunk_width(int kp) { return kp > MIN_CHUNK ? kp : MIN_CHUNK; }

// k <= 32: rows per phase-A block and the item chunks. The chunks depend on
// B and np alone (not on d, which may shrink the rows a block takes), and
// there are at most SEL_BLOCKS of them, which phase B's MERGE_LISTS holds.
struct SelPlan {
    int rb, chunk_w, n_chunks;
};

SelPlan sel_plan(int B, int np) {
    const int rb = next_pow2(B < SEL_MAX_RB ? B : SEL_MAX_RB);
    const int groups = (B + rb - 1) / rb;
    const int target = (SEL_BLOCKS + groups - 1) / groups;
    int chunk_w = (np + target - 1) / target;
    if (chunk_w < SEL_MIN_CHUNK) chunk_w = SEL_MIN_CHUNK;
    return {rb, chunk_w, (np + chunk_w - 1) / chunk_w};
}

// V tiles, Q rows, then 32 candidate keys per row and warp
size_t sel_smem(int rb, int d) {
    return SEL_VBYTES + sizeof(float) * rb * ((d + 3) & ~3) +
           sizeof(uint64_t) * 32 * (rb > SEL_WARPS ? rb : SEL_WARPS);
}

template <int RB>
cudaError_t launch_select(const float* Q, int nq, const int* ids, const float* V, int np,
                          int d, int vec, int B, int rows_valid, int n_valid, int k,
                          const SelPlan& p, uint64_t* cand, cudaStream_t s) {
    const size_t smem = sel_smem(RB, d);
    // the attribute is per device: set it on every launch
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(p.n_chunks, (B + RB - 1) / RB);
    select_kernel<RB><<<grid, SEL_THREADS, smem, s>>>(Q, nq, ids, V, np, d, vec, B, rows_valid,
                                                      n_valid, k, p.chunk_w, p.n_chunks, cand);
    return cudaGetLastError();
}

int score_topk_select(const float* Q, int nq, const int* ids, const float* V, int np, int d,
                      int B, int rows_valid, int n_valid, int k, uint64_t* cand,
                      float* out_vals, int* out_idx, cudaStream_t s) {
    const SelPlan p = sel_plan(B, np);
    int rb = p.rb;
    while (rb > 1 && sel_smem(rb, d) > SEL_MAX_SMEM) rb >>= 1;   // wide d: fewer rows a block
    if (sel_smem(rb, d) > SEL_MAX_SMEM || (B + rb - 1) / rb > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0;
    cudaError_t err;
    switch (rb) {
        case 1: err = launch_select<1>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s); break;
        case 2: err = launch_select<2>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s); break;
        case 4: err = launch_select<4>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s); break;
        case 8: err = launch_select<8>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s); break;
        case 16: err = launch_select<16>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s); break;
        case 32: err = launch_select<32>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s); break;
        default: err = launch_select<64>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_select_kernel<<<B, SEL_THREADS, 0, s>>>(cand, p.n_chunks, k, out_vals, out_idx);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of 64-bit scratch keys one launch needs.
long long pio_score_topk_scratch_elems(int B, int np, int k) {
    if (k <= SEL_MAX_K) return static_cast<long long>(B) * sel_plan(B, np).n_chunks * k;
    const int kp = next_pow2(k);
    const long long w = chunk_width(kp);
    return static_cast<long long>(B) * ((np + w - 1) / w) * kp;
}

// Q: (nq, d) f32; ids: (B,) i32 rows of Q, or null for rows 0..B-1;
// V: (np, d) f32; outputs (B, k) f32 and i32; scratch from
// pio_score_topk_scratch_elems. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launches.
int pio_score_topk(const float* Q, int nq, const int* ids,
                   const float* V, int np, int d,
                   int B, int rows_valid, int n_valid, int k,
                   unsigned long long* scratch,
                   float* out_vals, int* out_idx, void* stream) {
    if (B <= 0 || k <= 0 || k > MAX_CHUNK || k > np || d <= 0 || nq <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint64_t* cand = reinterpret_cast<uint64_t*>(scratch);
    if (k <= SEL_MAX_K)
        return score_topk_select(Q, nq, ids, V, np, d, B, rows_valid, n_valid, k, cand,
                                 out_vals, out_idx, s);

    const int kp = next_pow2(k);
    const int chunk_w = chunk_width(kp);
    const int n_chunks = (np + chunk_w - 1) / chunk_w;
    const size_t smem_a = sizeof(uint64_t) * RB * chunk_w + sizeof(float) * RB * d +
                          sizeof(float) * VT * (DK + 1);
    cudaError_t err;
    if (smem_a > 48 * 1024) {   // the attribute is per device: set it on every launch
        err = cudaFuncSetAttribute(chunk_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem_a));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    dim3 grid_a((B + RB - 1) / RB, n_chunks);
    chunk_topk_kernel<<<grid_a, THREADS, smem_a, s>>>(
        Q, nq, ids, V, np, d, B, rows_valid, n_valid, kp, chunk_w, n_chunks, cand);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    // phase B: as many lists per shared-memory group as MERGE_KEYS holds
    const int group = MERGE_KEYS / kp;
    const size_t smem_b = sizeof(uint64_t) * (kp + group * kp);
    merge_topk_kernel<<<B, THREADS, smem_b, s>>>(cand, n_chunks, kp, k, group,
                                                 out_vals, out_idx);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
