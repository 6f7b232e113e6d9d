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
// k <= 32 (serving buckets k to powers of two from 16: num <= 16 takes k = 16):
//
//   Phase A, select_kernel<RB, false>, grid (item chunks x row groups of RB rows,
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
// 32 < k <= 1024 (kp, the next power of two of k, at least 64):
//
//   Phase A, select_kernel<RB, true>: phase A of the k <= 32 path, with the
//   chunks cut so that every row group gives about 132 blocks (finer bars),
//   run for a short list of J keys: J = ceil(k / (3/4 of the chunks)), at
//   most 32 (1, 2, 3, 6 and 11 at k = 64 ... 1,024 over 132 chunks). It
//   keeps of its list only the J-th key, the chunk's bar, and writes every
//   score of its chunk, as the upper 32 bits of its key, to a (B, np)
//   scratch S (bytes that phase B reads back from L2).
//
//   Phase B, bar_merge_kernel, one block of 1,024 threads per row. The
//   row's bar T is the p-th largest of the chunks' bars, p = ceil(k / J):
//   those p chunks hold J keys each at or above T, so at least k keys reach
//   it and nothing of the top k lies below it (with p past the chunks T = 0
//   and every key is a candidate). The block reads the row's scores (one
//   batch of 16-byte loads, issued before T is known), keeps the keys whose
//   score reaches T's (ties pass) and compacts them into shared memory by a
//   block-wide scan; on random data somewhat more than k. The sort takes one
//   key a thread, at most 1,024: each warp sorts its 32 keys by a bitonic
//   network over shuffles, then rounds of merges put each key at its rank
//   in its pair of runs (its place in its own run plus a binary search in
//   the other: log2(n / 32) barriers). When more than 1,024 keys pass, a
//   radix select over the candidates in shared memory (the bytes below
//   their common leading bits, stopping at the first byte whose boundary
//   bin holds just the keys still needed) finds the k-th key exactly, and
//   only the k keys at or above it are sorted. When more keys reach T than
//   shared memory holds (BAR_CAP; all of them do when V is constant), a
//   radix select over the row's scores in S finds the k-th key: correct,
//   not fast.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (predictionio_tpu_torch/ops/_build.py), bound through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 1024;   // the largest k the kernel takes
constexpr float NEG = -3.0e38f;

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

// The words of a k > 32 launch's scratch before S: one bar per row and
// chunk, rounded up to an even count so that S starts on 16 bytes.
__host__ __device__ __forceinline__ size_t bar_words(int B, int n_chunks) {
    return (static_cast<size_t>(B) * n_chunks + 1) & ~static_cast<size_t>(1);
}

// S's row stride in 32-bit words: np rounded up to 4, 16-byte rows
__host__ __device__ __forceinline__ int score_stride(int np) { return (np + 3) & ~3; }

// BAR = false: the k <= 32 path, cand = (B, n_chunks, k) sorted lists.
// BAR = true: the k > 32 path's phase A, k = J: cand = the (B, n_chunks)
// bars (each list's J-th key), then S, the (B, score_stride(np)) upper
// halves of the row's keys.
template <int RB, bool BAR>
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
                if constexpr (BAR) {   // every score of the tile, for phase B's filter
                    uint32_t* S = reinterpret_cast<uint32_t*>(cand + bar_words(B, n_chunks));
                    const size_t lds = score_stride(np);
#pragma unroll
                    for (int i = 0; i < RW; ++i) {
                        const int row = row0 + wr * RW + i;
#pragma unroll
                        for (int t = 0; t < TI; ++t)
                            if (row < B && base + t * 32 < col_end)
                                S[row * lds + base + t * 32] =
                                    static_cast<uint32_t>(key_of(i, t) >> 32);
                    }
                }
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
    if constexpr (BAR) {
        if (wi == 0 && lane == k - 1) {   // the chunk's J-th key
#pragma unroll
            for (int i = 0; i < RW; ++i) {
                const int row = row0 + wr * RW + i;
                if (row < B) cand[static_cast<size_t>(row) * n_chunks + chunk] = list[i];
            }
        }
    } else if (wi == 0 && lane < k) {
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

// ---- 32 < k <= 1024: a bar from the chunks' J-th keys, then one sort ----

constexpr int BAR_THREADS = 1024;
constexpr int BAR_WARPS = BAR_THREADS / 32;
constexpr int BAR_CAP = 8192;                    // candidate keys a row's block holds
constexpr int BAR_LOADS = 7;                     // 16-byte score loads a thread has in flight:
                                                 // 28,672 scores (ML-20M's catalog) in one batch
constexpr size_t BAR_SMEM = sizeof(uint64_t) * (BAR_CAP + BAR_THREADS);   // candidates, a sort's
                                                                         // other buffer

static_assert(SEL_THREADS == 8 * 32 && BAR_THREADS % 32 == 0, "whole warps");
static_assert(MAX_K <= BAR_THREADS && BAR_THREADS <= BAR_CAP, "a sort takes one key a thread");
static_assert(BAR_LOADS * 4 <= 32, "a thread's passing scores are one 32-bit mask");
static_assert(2 * SEL_BLOCKS <= BAR_THREADS, "two threads rank each chunk's bar");

// buf[0, n2) sorted descending, for distinct keys, n2 a power of two, 64 <=
// n2 <= BAR_THREADS: each warp sorts its 32 keys by a bitonic network over
// the lanes, then rounds of merges put each key of a pair of sorted runs at
// its rank in the pair, its place in its own run plus the keys of the other
// run above it (one binary search). tmp[0, n2) is the other buffer; returns
// the one that holds the result. Every thread calls it; it starts after a
// barrier and ends in one.
__device__ uint64_t* block_sort_desc(uint64_t* buf, uint64_t* tmp, int n2) {
    const int tid = threadIdx.x;
    const bool mine = tid < n2;   // whole warps
    uint64_t x[1] = {mine ? buf[tid] : 0ull};
    if (mine) {
        sort_desc<1>(x, tid & 31);
        buf[tid] = x[0];
    }
    __syncthreads();
    uint64_t* src = buf;
    uint64_t* dst = tmp;
    for (int len = 32; len < n2; len <<= 1) {
        if (mine) {
            const int pair = tid & ~(2 * len - 1);
            const uint64_t* other = src + pair + ((tid & len) ? 0 : len);
            int lo = 0, hi = len;   // the other run's keys above x[0]
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (other[mid] > x[0]) lo = mid + 1;
                else hi = mid;
            }
            dst[pair + (tid & (len - 1)) + lo] = x[0];
        }
        __syncthreads();
        if (mine) x[0] = dst[tid];
        uint64_t* t = src;
        src = dst;
        dst = t;
    }
    return src;
}

__device__ __forceinline__ uint64_t col_key(uint32_t hi, int col) {
    return (static_cast<uint64_t>(hi) << 32) | static_cast<uint64_t>(0xFFFFFFFFu - static_cast<uint32_t>(col));
}

// The lowest of the k largest of the keys that key_at(i, key) accepts for
// i in [0, n) (at least k of them, all distinct), exactly: a radix select
// over the bits below the keys' common leading bits, 8 at a time from the
// highest bit in which they differ, counting in a shared histogram, that
// stops at the first window whose boundary bin holds just the keys still
// needed. The k largest keys are those at or above it. Every thread calls it.
template <typename KeyAt>
__device__ uint64_t kth_key(KeyAt key_at, int n, int k, unsigned* hist, uint64_t* prefix_s,
                            int* need_s, unsigned* bits_s) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid < 4) bits_s[tid] = tid < 2 ? 0u : ~0u;   // OR, then AND, of the keys' halves
    __syncthreads();
    uint64_t any = 0, all = ~0ull;
    for (int i = tid; i < n; i += BAR_THREADS) {
        uint64_t key;
        if (key_at(i, key)) {
            any |= key;
            all &= key;
        }
    }
    const unsigned r[4] = {__reduce_or_sync(FULL, static_cast<unsigned>(any >> 32)),
                           __reduce_or_sync(FULL, static_cast<unsigned>(any)),
                           __reduce_and_sync(FULL, static_cast<unsigned>(all >> 32)),
                           __reduce_and_sync(FULL, static_cast<unsigned>(all))};
    if (lane == 0) {
        atomicOr(&bits_s[0], r[0]);
        atomicOr(&bits_s[1], r[1]);
        atomicAnd(&bits_s[2], r[2]);
        atomicAnd(&bits_s[3], r[3]);
    }
    __syncthreads();
    const uint64_t or_bits = (static_cast<uint64_t>(bits_s[0]) << 32) | bits_s[1];
    const uint64_t and_bits = (static_cast<uint64_t>(bits_s[2]) << 32) | bits_s[3];
    if (or_bits == and_bits) return or_bits;   // one key
    int top = 64 - __clzll(static_cast<long long>(or_bits ^ and_bits));   // bits [top, 64) common
    uint64_t mask = top == 64 ? 0ull : ~0ull << top;
    uint64_t prefix = and_bits & mask;
    int need = k;
    while (top > 0) {
        const int shift = top > 8 ? top - 8 : 0;
        const unsigned width = (1u << (top - shift)) - 1u;   // the window's digit mask
        for (int i = tid; i < 256; i += BAR_THREADS) hist[i] = 0;
        __syncthreads();
        for (int i = tid; i < n; i += BAR_THREADS) {
            uint64_t key;
            if (key_at(i, key) && (key & mask) == prefix)
                atomicAdd(&hist[static_cast<unsigned>(key >> shift) & width], 1u);
        }
        __syncthreads();
        if (warp == 0) {   // lane l takes digits 255 - 8l down to 248 - 8l
            unsigned h[8];
            int sum = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                h[j] = hist[255 - 8 * lane - j];
                sum += h[j];
            }
            int incl = sum;
#pragma unroll
            for (int dl = 1; dl < 32; dl <<= 1) {
                const int x = __shfl_up_sync(FULL, incl, dl);
                if (lane >= dl) incl += x;
            }
            int above = incl - sum;
            if (above < need && incl >= need) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    if (above + static_cast<int>(h[j]) >= need) {
                        const uint64_t digit = static_cast<uint64_t>(255 - 8 * lane - j);
                        *prefix_s = prefix | (digit << shift);
                        // the bin holds just the keys still needed: all of it is kept
                        *need_s = static_cast<int>(h[j]) == need - above ? 0 : need - above;
                        break;
                    }
                    above += h[j];
                }
            }
        }
        __syncthreads();
        prefix = *prefix_s;
        need = *need_s;
        mask |= static_cast<uint64_t>(width) << shift;
        top = shift;
        if (need == 0) break;
    }
    return prefix;
}

// Phase B of the k > 32 path, one block per row (see the header).
__global__ void __launch_bounds__(BAR_THREADS)
bar_merge_kernel(const uint64_t* __restrict__ scratch, int B, int np, int n_chunks, int J, int k,
                 float* __restrict__ out_vals, int* __restrict__ out_idx) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint64_t* keys = reinterpret_cast<uint64_t*>(smem);   // BAR_CAP, then BAR_THREADS
    __shared__ uint64_t bar_s[SEL_BLOCKS];
    __shared__ unsigned hist[256];
    __shared__ int warp_s[BAR_WARPS];
    __shared__ uint64_t thr_s, prefix_s;
    __shared__ int count_s, need_s;
    __shared__ unsigned bits_s[4];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t row = blockIdx.x;
    const int lds = score_stride(np);
    const uint32_t* srow = reinterpret_cast<const uint32_t*>(scratch + bar_words(B, n_chunks)) +
                           row * lds;
    const uint4* srow4 = reinterpret_cast<const uint4*>(srow);
    const int n4 = lds / 4;

    // the chunks' bars, then the first BAR_LOADS x BAR_THREADS x 4 scores
    // of the row, in flight while the bar is found
    const uint64_t my_bar = tid < n_chunks ? scratch[row * n_chunks + tid] : 0ull;
    uint4 v[BAR_LOADS];
    auto load = [&](int q0) {
#pragma unroll
        for (int l = 0; l < BAR_LOADS; ++l) {
            const int q = q0 + l * BAR_THREADS + tid;
            v[l] = q < n4 ? srow4[q] : make_uint4(0, 0, 0, 0);
        }
    };
    load(0);

    // the bar T: the p-th largest of the chunks' J-th keys. Threads 2c and
    // 2c + 1 count the bars above chunk c's (equal bars, only ever 0 from
    // chunks shorter than J, rank by chunk); with p past the chunks T stays
    // 0 and every key is a candidate
    const int p = (k + J - 1) / J;
    if (tid == 0) thr_s = 0;
    if (tid < n_chunks) bar_s[tid] = my_bar;
    __syncthreads();
    {
        const int c = tid >> 1;
        const bool mine = p <= n_chunks && c < n_chunks;
        const uint64_t b = mine ? bar_s[c] : 0ull;
        int rank = 0;
        if (mine) {
#pragma unroll 4
            for (int o = tid & 1; o < n_chunks; o += 2) {
                const uint64_t x = bar_s[o];
                rank += x > b || (x == b && o < c);
            }
        }
        rank += __shfl_xor_sync(FULL, rank, 1);
        if (mine && (tid & 1) == 0 && rank == p - 1) thr_s = b;
    }
    __syncthreads();
    const uint32_t t32 = static_cast<uint32_t>(thr_s >> 32);

    // candidates: every key whose score reaches the bar's, compacted in
    // thread order by a block-wide scan, batch by batch of loads (the order
    // is free: the sort makes it one)
    int n = 0;
    for (int q0 = 0; q0 < n4; q0 += BAR_LOADS * BAR_THREADS) {
        if (q0) load(q0);
        unsigned pass = 0;
#pragma unroll
        for (int l = 0; l < BAR_LOADS; ++l) {
            const int col = 4 * (q0 + l * BAR_THREADS + tid);
            const uint32_t o[4] = {v[l].x, v[l].y, v[l].z, v[l].w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (col + j < np && o[j] >= t32) pass |= 1u << (4 * l + j);
        }
        const int mine = __popc(pass);
        int incl = mine;
#pragma unroll
        for (int dl = 1; dl < 32; dl <<= 1) {
            const int x = __shfl_up_sync(FULL, incl, dl);
            if (lane >= dl) incl += x;
        }
        if (lane == 31) warp_s[warp] = incl;
        __syncthreads();
        if (warp == 0) {
            int t = lane < BAR_WARPS ? warp_s[lane] : 0;
#pragma unroll
            for (int dl = 1; dl < BAR_WARPS; dl <<= 1) {
                const int x = __shfl_up_sync(FULL, t, dl);
                if (lane >= dl) t += x;
            }
            if (lane < BAR_WARPS) warp_s[lane] = t;
        }
        __syncthreads();
        int pos = n + (warp ? warp_s[warp - 1] : 0) + incl - mine;
#pragma unroll
        for (int l = 0; l < BAR_LOADS; ++l) {
            const int col = 4 * (q0 + l * BAR_THREADS + tid);
            const uint32_t o[4] = {v[l].x, v[l].y, v[l].z, v[l].w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (pass >> (4 * l + j) & 1u) {
                    if (pos < BAR_CAP) keys[pos] = col_key(o[j], col + j);
                    ++pos;
                }
        }
        n += warp_s[BAR_WARPS - 1];
        __syncthreads();   // warp_s is read before the next batch writes it
    }

    // at most BAR_THREADS keys to sort, one a thread: when more reach the
    // bar, the k largest first, found by a radix select over the candidates
    // in shared memory or, when more reach it than shared memory holds, over
    // the row's scores in S (correct, not fast), and kept in their own buffer
    uint64_t* sorted = keys;
    if (n > BAR_THREADS) {
        const bool in_smem = n <= BAR_CAP;
        auto candidate = [&](int i, uint64_t& key) {
            if (in_smem) {
                key = keys[i];
                return true;
            }
            key = col_key(srow[i], i);
            return srow[i] >= t32;
        };
        const int m = in_smem ? n : np;
        const uint64_t kth = kth_key(candidate, m, k, hist, &prefix_s, &need_s, bits_s);
        sorted = keys + BAR_CAP;
        if (tid == 0) count_s = 0;
        __syncthreads();
        for (int i0 = 0; i0 < m; i0 += BAR_THREADS) {   // a whole warp takes each step
            const int i = i0 + tid;
            uint64_t key = 0;
            const bool keep = i < m && candidate(i, key) && key >= kth;
            const unsigned b = __ballot_sync(FULL, keep);
            int base = 0;
            if (lane == 0 && b) base = atomicAdd(&count_s, __popc(b));
            base = __shfl_sync(FULL, base, 0);
            if (keep) sorted[base + __popc(b & ((1u << lane) - 1u))] = key;
        }
        n = k;
    }
    int n2 = 64;
    while (n2 < n) n2 <<= 1;
    // pad with distinct keys below every real one (a real key is at least
    // 2^55: its score is finite), so that every key has one rank
    for (int i = n + tid; i < n2; i += BAR_THREADS) sorted[i] = static_cast<uint64_t>(n2 - i);
    __syncthreads();
    sorted = block_sort_desc(sorted, sorted == keys ? keys + BAR_CAP : keys, n2);
    for (int i = tid; i < k; i += BAR_THREADS) {
        const uint64_t key = sorted[i];
        out_vals[row * k + i] = key_value(key);
        out_idx[row * k + i] = key_index(key);
    }
}

int next_pow2(int x) {
    int p = 1;
    while (p < x) p <<= 1;
    return p;
}

// Rows per phase-A block and the item chunks. The chunks depend on B and
// np alone (not on d, which may shrink the rows a block takes), and there
// are at most SEL_BLOCKS of them, which phase B's MERGE_LISTS and
// bar_merge_kernel's bar_s hold. k <= 32 cuts them so that all row groups
// together give about SEL_BLOCKS blocks; k > 32 (bar = true) so that each
// row group does, since more chunks make a row's bar finer.
struct SelPlan {
    int rb, chunk_w, n_chunks;
};

SelPlan sel_plan(int B, int np, bool bar = false) {
    const int rb = next_pow2(B < SEL_MAX_RB ? B : SEL_MAX_RB);
    const int groups = bar ? 1 : (B + rb - 1) / rb;
    const int target = (SEL_BLOCKS + groups - 1) / groups;
    int chunk_w = (np + target - 1) / target;
    if (chunk_w < SEL_MIN_CHUNK) chunk_w = SEL_MIN_CHUNK;
    return {rb, chunk_w, (np + chunk_w - 1) / chunk_w};
}

// k > 32: the length J of phase A's lists, so that the bar is about the
// 3/4-th of the chunks' J-th keys (p = ceil(k / J) of them)
int bar_list(int k, int n_chunks) {
    const int covered = n_chunks * 3 / 4 > 1 ? n_chunks * 3 / 4 : 1;
    const int j = (k + covered - 1) / covered;
    return j < SEL_MAX_K ? j : SEL_MAX_K;
}

// V tiles, Q rows, then 32 candidate keys per row and warp
size_t sel_smem(int rb, int d) {
    return SEL_VBYTES + sizeof(float) * rb * ((d + 3) & ~3) +
           sizeof(uint64_t) * 32 * (rb > SEL_WARPS ? rb : SEL_WARPS);
}

template <int RB, bool BAR>
cudaError_t launch_select(const float* Q, int nq, const int* ids, const float* V, int np,
                          int d, int vec, int B, int rows_valid, int n_valid, int k,
                          const SelPlan& p, uint64_t* cand, cudaStream_t s) {
    const size_t smem = sel_smem(RB, d);
    // the attribute is per device: set it on every launch
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel<RB, BAR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    dim3 grid(p.n_chunks, (B + RB - 1) / RB);
    select_kernel<RB, BAR><<<grid, SEL_THREADS, smem, s>>>(
        Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p.chunk_w, p.n_chunks, cand);
    return cudaGetLastError();
}

// Phase A of either path (k: the list length, J when BAR)
template <bool BAR>
cudaError_t select_phase(const float* Q, int nq, const int* ids, const float* V, int np, int d,
                         int B, int rows_valid, int n_valid, int k, const SelPlan& p,
                         uint64_t* cand, cudaStream_t s) {
    int rb = p.rb;
    while (rb > 1 && sel_smem(rb, d) > SEL_MAX_SMEM) rb >>= 1;   // wide d: fewer rows a block
    if (sel_smem(rb, d) > SEL_MAX_SMEM || (B + rb - 1) / rb > 65535) return cudaErrorInvalidValue;
    const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0;
    switch (rb) {
        case 1: return launch_select<1, BAR>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s);
        case 2: return launch_select<2, BAR>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s);
        case 4: return launch_select<4, BAR>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s);
        case 8: return launch_select<8, BAR>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s);
        case 16: return launch_select<16, BAR>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s);
        case 32: return launch_select<32, BAR>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s);
        default: return launch_select<64, BAR>(Q, nq, ids, V, np, d, vec, B, rows_valid, n_valid, k, p, cand, s);
    }
}

int score_topk_select(const float* Q, int nq, const int* ids, const float* V, int np, int d,
                      int B, int rows_valid, int n_valid, int k, uint64_t* cand,
                      float* out_vals, int* out_idx, cudaStream_t s) {
    const SelPlan p = sel_plan(B, np);
    const cudaError_t err = select_phase<false>(Q, nq, ids, V, np, d, B, rows_valid, n_valid, k,
                                                p, cand, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    merge_select_kernel<<<B, SEL_THREADS, 0, s>>>(cand, p.n_chunks, k, out_vals, out_idx);
    return static_cast<int>(cudaGetLastError());
}

int score_topk_bar(const float* Q, int nq, const int* ids, const float* V, int np, int d,
                   int B, int rows_valid, int n_valid, int k, uint64_t* scratch,
                   float* out_vals, int* out_idx, cudaStream_t s) {
    const SelPlan p = sel_plan(B, np, true);
    const int J = bar_list(k, p.n_chunks);
    cudaError_t err = select_phase<true>(Q, nq, ids, V, np, d, B, rows_valid, n_valid, J, p,
                                         scratch, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(bar_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(BAR_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    bar_merge_kernel<<<B, BAR_THREADS, BAR_SMEM, s>>>(scratch, B, np, p.n_chunks, J, k,
                                                      out_vals, out_idx);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of 64-bit scratch words one launch needs: k <= 32, the chunks'
// lists; k > 32, the chunks' bars and the (B, score_stride(np)) scores.
long long pio_score_topk_scratch_elems(int B, int np, int k) {
    if (k <= SEL_MAX_K) return static_cast<long long>(B) * sel_plan(B, np).n_chunks * k;
    return static_cast<long long>(bar_words(B, sel_plan(B, np, true).n_chunks)) +
           (static_cast<long long>(B) * score_stride(np) + 1) / 2;
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
    if (B <= 0 || k <= 0 || k > MAX_K || k > np || d <= 0 || nq <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint64_t* cand = reinterpret_cast<uint64_t*>(scratch);
    if (k <= SEL_MAX_K)
        return score_topk_select(Q, nq, ids, V, np, d, B, rows_valid, n_valid, k, cand,
                                 out_vals, out_idx, s);
    return score_topk_bar(Q, nq, ids, V, np, d, B, rows_valid, n_valid, k, cand,
                          out_vals, out_idx, s);
}

}  // extern "C"
