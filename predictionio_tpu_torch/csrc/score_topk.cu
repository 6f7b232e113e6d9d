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
// Design. The TPU kernel walks the item tiles in order on one core and
// carries a running (B, k) best list in VMEM. Blocks on the GPU run in no
// order, so the selection is split in two passes:
//
//   Phase A, grid (row blocks x item chunks). A block gathers its RB query
//   rows (Q[ids[r]]) into shared memory, dimension-major so a thread's four
//   rows are one 16-byte load, and streams its chunk of V (256 items, or
//   KP when that is more)
//   through shared memory in VT x DK tiles; each tile's global loads are
//   issued into registers while the previous tile is being scored, so
//   their latency overlaps the FMAs. Scores are f32 FMA (no TF32, no bf16:
//   the ranking must match the f32 reference). Each score becomes a 64-bit
//   key whose unsigned order is (value descending, index ascending). The
//   chunk's best KP keys are then selected without sorting the whole
//   chunk: runs of KP are sorted (bitonic, alternating direction), and
//   rounds of "keep the larger of each pair of runs, then bitonic-merge
//   what is kept" halve the keys until one sorted run is left.
//
//   Phase B, one block per row. It stages the chunks' sorted lists through
//   shared memory in groups (all 112 of the serving path's at KP = 16) and
//   reduces each group with the same halving rounds, a tree of depth
//   log2(group) instead of a chain of one merge per list; a group's result
//   is folded into the running best KP the same way.
//
// Folding value and index into one key makes every comparison total and
// exact, so the tie order equals the reference's. The key of an empty slot
// (past the end of V) is 0, below every real key.
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

int next_pow2(int x) {
    int p = 1;
    while (p < x) p <<= 1;
    return p;
}

int chunk_width(int kp) { return kp > MIN_CHUNK ? kp : MIN_CHUNK; }

}  // namespace

extern "C" {

// Number of 64-bit scratch keys one launch needs.
long long pio_score_topk_scratch_elems(int B, int np, int k) {
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
    const int kp = next_pow2(k);
    const int chunk_w = chunk_width(kp);
    const int n_chunks = (np + chunk_w - 1) / chunk_w;
    uint64_t* cand = reinterpret_cast<uint64_t*>(scratch);

    const size_t smem_a = sizeof(uint64_t) * RB * chunk_w + sizeof(float) * RB * d +
                          sizeof(float) * VT * (DK + 1);
    // raise the kernel's shared-memory ceiling only when a wider d needs
    // more than any earlier call (a racing double set is harmless)
    static size_t smem_ceiling = 0;
    cudaError_t err;
    if (smem_a > smem_ceiling) {
        err = cudaFuncSetAttribute(
            chunk_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_a));
        if (err != cudaSuccess) return static_cast<int>(err);
        smem_ceiling = smem_a;
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
