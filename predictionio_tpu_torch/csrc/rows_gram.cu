// Weighted Gram over a pre-gathered block, designed for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/gram.py rows_gram /
// _gram_kernel: for every row r,
//
//     A[r] = F_g[r]^T diag(w_outer[r]) F_g[r]     (k x k, f32)
//     b[r] = F_g[r]^T w_b[r]                      (k,     f32)
//
// with F_g (R, W, k) f32 or bf16 (bf16 values are widened to f32 on the
// chip, as the reference's type promotion does), w_outer and w_b (R, W)
// f32, and k <= 128. Unlike gather_gram, each row's (W, k) slab is
// contiguous in device memory.
//
// Bound on an H100 SXM, from the work the function needs: per slot of
// nonzero weight (S of them), k(k+1)/2 + 2k FMAs (w*f, the lower triangle
// of A, b), k^2 + 5k FLOP at the 67 TFLOP/s f32 rate outside the tensor
// cores; against 4*S*k (those slots' F_g rows, f32) + 8*R*W (every weight)
// + 4*R*(k^2 + k) (A and b) bytes at 3.35 TB/s. At k = 64 a slot costs
// 4,416 FLOP and 256 bytes of F_g, so every shape is bytes-bound on paper:
//   - wide rows (W >= 512): F_g and the FMAs nearly even;
//   - narrow rows (W = 8, 32): the A write, 16.4 KB a row (the ML-20M
//     layout's W = 8 chunk of 105,312 rows writes 1.73 GB: 0.52 ms).
//
// Design, each part against what held the first kernel (one block of 256
// threads per row, a full k x k register tile, plain loads) back:
// 1. Stop at the last live slot. Each tile's weights are staged first; a
//    warp-shuffle max and one barrier give the tile's last slot whose
//    w_outer or w_b is nonzero, and only the slots up to it are copied and
//    multiplied; an all-zero tile costs its weights only. A skipped slot
//    would add only +-0, so for finite F_g no bit of the result changes.
//    Zero runs anywhere in a row are handled the same way: only the speed
//    rests on the pad lying at the end of the row.
// 2. One triangle. A is cut into 16 x 16 sub-tiles and only the lower
//    triangle's n(n+1)/2 of them (n = KP / 16, KP = k rounded up to 16,
//    32, 64 or 128) are given to threads, 16 threads a sub-tile, each with
//    a 4 x 4 micro-tile in registers: at k = 64, 10 of 16 sub-tiles, 37.5%
//    fewer FMAs. Per slot a thread reads its row fragment of wo * f and
//    its column fragment of f with two 16-byte shared loads and does 16
//    FMAs: the weight is applied once a slot by a scaling pass, not by
//    every thread. A is written mirrored from the lower values, so it is
//    exactly symmetric on any data. Six micro-tiles of each diagonal
//    sub-tile lie above the diagonal: four of them accumulate b instead,
//    with the same instruction stream (their row fragment is the scaled
//    tile's column KP, which holds (wb, 0, 0, 0)).
// 3. Asynchronous tiles. Tiles move through a ring of STAGES buffers with
//    one barrier a tile: while tile t multiplies, tile t+1 is scaled and
//    tile t+2's live span of F_g (contiguous: nt * k values) is copied
//    with 16-byte cp.async, and tile t+3's weights are in flight to
//    registers. The copies go through L2 only (.cg): a pre-gathered slab is
//    read once, so unlike gather_gram (.ca, where a few popular entities'
//    rows sit in most rating rows and L1 keeps them off one L2 slice) no
//    row is read twice and caching it in L1 would only evict. That route
//    is taken when k % (16 / sizeof(T)) == 0 and F_g is 16-byte aligned;
//    bf16 is then staged raw and widened by the scaling pass. Otherwise
//    the tile is read with plain coalesced loads.
// 4. Split wide rows. The first kernel ran one block per row, so a chunk
//    of 42 or 128 rows of 8,192 slots filled at most 128 of 132 SMs, each
//    walking its row in series. A row of W >= 1,024 slots may be cut into
//    `split` chunks of `chunk` slots, one block each, so that few-row
//    chunks fill the card. Each chunk's partial [A | b] goes to a scratch
//    array that the wrapper allocates, and a second kernel sums the chunks
//    in their fixed order: no atomic, so a rerun is bitwise the same. The
//    plan is made from the shape alone (ops/rows_gram.py rows_plan).
// 5. Pack narrow rows. In a many-row chunk of narrow rows (W <= 32), a
//    block walks rows_per_block (2 to 4) consecutive rows through the same
//    ring, so the next row's copy overlaps this row's products and the
//    write of its A. Rows of W <= 8 are bound by writing A, so there (at
//    KP <= 64) each row's A is first assembled in shared memory, in the
//    ring buffers its last tile has just freed (no more shared memory, so
//    as many blocks fit on an SM), and then written with coalesced,
//    streaming 16-byte stores (st.global.cs): whole 128-byte lines,
//    evicted first, instead of 64-byte pieces of four rows a warp. At
//    W = 32 the staging's two barriers a row cost more than they saved
//    (measured on the card), so those rows write A from registers.
// Summation is two-level: each tile's products go to a register partial
// that is then added to the row's (or the chunk's) total; split chunks
// add a third level in the reduction.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (predictionio_tpu_torch/ops/_build.py), bound through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 128;
constexpr int MAX_SPLIT = 16;
constexpr int REDUCE_THREADS = 256;
// packed rows of at most this many slots assemble A in shared memory
constexpr int STAGE_W = 8;

// Copy routes: plain widening loads; 16-byte cp.async of f32 values;
// 16-byte cp.async of raw bf16 values, widened in shared memory.
enum Route { PLAIN = 0, ASYNC_F32 = 1, ASYNC_BF16 = 2 };

// slots per tile
template <int KP> __host__ __device__ constexpr int tile_slots() {
    return KP >= 128 ? 16 : 32;
}
// 16 threads for each lower 16 x 16 sub-tile, rounded up to whole warps
template <int KP> __host__ __device__ constexpr int block_threads() {
    return (16 * (KP / 16) * (KP / 16 + 1) / 2 + 31) / 32 * 32;
}
// tiles in flight (the ring of F_g buffers); the weights have a ring one
// longer, so no barrier is needed after the products
constexpr int STAGES = 3;
constexpr int WSTAGES = STAGES + 1;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    // .cg: through L2 only; every value of a pre-gathered slab is read once
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N groups (the newest) are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a thread writes: nothing, a lower off-diagonal micro-tile (and its
// mirror), a diagonal micro-tile, or four entries of b.
enum Role { NONE = 0, LOWER = 1, DIAG = 2, BVEC = 3 };

// blocks an SM should hold: registers are capped so that five fit
template <int KP> __host__ __device__ constexpr int min_blocks() { return KP <= 64 ? 5 : 1; }

// STAGED: each row's A is assembled in shared memory and written in whole
// lines (packed narrow rows at KP <= 64); otherwise the threads write A
// from their registers.
template <int KP, int ROUTE, typename T, bool STAGED>
__global__ void __launch_bounds__(block_threads<KP>(), min_blocks<KP>())
rows_gram_kernel(const T* __restrict__ Fg, int k, const float* __restrict__ wo,
                 const float* __restrict__ wb, long long R, int W, int split, int chunk,
                 int rows_per_block, float* __restrict__ A, float* __restrict__ b,
                 float* __restrict__ partial) {
    constexpr int THREADS = block_threads<KP>();
    constexpr int NWARPS = THREADS / 32;
    constexpr int TILE = tile_slots<KP>();
    constexpr int SPT = (TILE + THREADS - 1) / THREADS;  // weight slots a thread
    constexpr int GSTRIDE = KP + 4;  // s_g: wo * f, then (wb, 0, 0, 0)
    constexpr bool RAW = ROUTE == ASYNC_BF16;
    // f32 tiles: the ring the copies land in; for bf16 the widened tiles,
    // double-buffered like s_g (the raw ring is s_raw)
    constexpr int NF = RAW ? 2 : STAGES;
    __shared__ __align__(16) float s_f[NF][TILE][KP];  // columns [k, KP) zero
    __shared__ __align__(16) float s_g[2][TILE][GSTRIDE];
    __shared__ __align__(16) __nv_bfloat16 s_raw[RAW ? STAGES : 1][RAW ? TILE : 1][KP];
    __shared__ float s_w[WSTAGES][2][TILE];  // [buffer][wo, wb][slot]
    __shared__ int s_live[WSTAGES][NWARPS];  // per warp: 1 + its last live slot

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // this thread's micro-tile: rows row_off.. of s_g, columns col_off.. of s_f
    int role = NONE, row_off = 0, col_off = 0;
    if (tid < 16 * (KP / 16) * (KP / 16 + 1) / 2) {
        int st = tid >> 4, P = 0;
        while (st > P) st -= ++P;  // lower sub-tile (P, Q), row-major
        const int Q = st, u = (tid >> 2) & 3, v = tid & 3;
        row_off = 16 * P + 4 * u;
        col_off = 16 * Q + 4 * v;
        if (P != Q || u > v) {
            role = LOWER;
        } else if (u == v) {
            role = DIAG;
        } else if (u == 0 || (u == 1 && v == 2)) {  // (0,1) (0,2) (0,3) (1,2): b
            role = BVEC;
            row_off = KP;
            col_off = 16 * P + 4 * (u == 0 ? v - 1 : 3);
        }
    }

    // the block's rows and slot range
    long long r0;
    int nrows, lo, hi, s = 0;
    if (split > 1) {
        r0 = blockIdx.x / split;
        s = static_cast<int>(blockIdx.x % split);
        nrows = 1;
        lo = s * chunk;
        hi = min(W, lo + chunk);
    } else {
        r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
        nrows = static_cast<int>(min(static_cast<long long>(rows_per_block), R - r0));
        lo = 0;
        hi = W;
    }
    static_assert(!STAGED || KP <= 64, "the freed ring buffers hold A only at KP <= 64");
    const int tpr = (hi - lo + TILE - 1) / TILE;  // tiles a row (>= 1: no empty chunk)
    const int ntot = nrows * tpr;                 // tiles of the block, rows in order

    // constant columns, once: s_f zero past k, s_g zero past KP
    if (k < KP) {
        for (int e = tid; e < NF * TILE * (KP - k); e += THREADS) {
            const int c = e / (KP - k);
            (&s_f[0][0][0])[c * KP + k + e % (KP - k)] = 0.f;
        }
    }
    for (int c = tid; c < 2 * TILE; c += THREADS)
        s_g[c / TILE][c % TILE][KP + 1] = s_g[c / TILE][c % TILE][KP + 2] =
            s_g[c / TILE][c % TILE][KP + 3] = 0.f;

    // tile t's first slot, as an offset into the (R, W) weights
    auto tile_base = [&](int t, int& n) {
        const long long row = r0 + t / tpr;
        const int c0 = lo + (t % tpr) * TILE;
        n = min(TILE, hi - c0);
        return row * W + c0;
    };

    // Tile t's weights go global -> registers one iteration before they
    // are needed in shared memory (streaming loads: they are read once),
    // so their latency is off the block's path.
    struct Weights {
        float o[SPT], b[SPT];
    };
    auto load_weights = [&](int t, Weights& w) {
        int n;
        const long long base = tile_base(t, n);
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            const int e = tid + j * THREADS;
            const bool in = e < n;
            w.o[j] = in ? __ldcs(wo + base + e) : 0.f;
            w.b[j] = in ? __ldcs(wb + base + e) : 0.f;
        }
    };
    auto store_weights = [&](const Weights& w, int buf) {  // and the last live slot
        int live = 0;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            const int e = tid + j * THREADS;
            if (e < TILE) {
                s_w[buf][0][e] = w.o[j];
                s_w[buf][1][e] = w.b[j];
                if (w.o[j] != 0.f || w.b[j] != 0.f) live = e + 1;
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            live = max(live, __shfl_xor_sync(0xffffffffu, live, off));
        if (lane == 0) s_live[buf][warp] = live;
    };
    auto live_of = [&](int wbuf) {
        int nt = 0;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) nt = max(nt, s_live[wbuf][w]);
        return nt;
    };
    // value e of a tile's span lies at slot e / k, column e % k (a shift
    // when k fills KP)
    auto slot_of = [&](int e) { return k == KP ? e / KP : e / k; };
    auto copy = [&](int t, int fbuf) {  // tile t's live span of F_g
        const int nt = live_of(t % WSTAGES);
        int n;
        const T* src = Fg + tile_base(t, n) * k;
        if constexpr (ROUTE == PLAIN) {
            for (int e = tid; e < nt * k; e += THREADS) {
                const int c = slot_of(e);
                s_f[fbuf][c][e - c * k] = widen(src[e]);
            }
        } else {
            constexpr int VEC = 16 / sizeof(T);  // VEC divides k: no copy straddles two slots
            for (int e = tid * VEC; e < nt * k; e += THREADS * VEC) {
                const int c = slot_of(e);
                if constexpr (RAW)
                    cp_async16(&s_raw[fbuf][c][e - c * k], src + e);
                else
                    cp_async16(&s_f[fbuf][c][e - c * k], src + e);
            }
        }
    };

    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

    // this thread's entries of A and of b; row i of A lies at A0 + i * k
    // (STAGED: for i < half, else at A1 + (i - half) * k)
    auto put = [&](float* A0, float* A1, int half, float* bd) {
        if (role == NONE || col_off >= k || (role != BVEC && row_off >= k)) return;
        if (role == BVEC) {
            if (k % 4 == 0) {
                *reinterpret_cast<float4*>(bd + col_off) =
                    make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
            } else {
#pragma unroll
                for (int n = 0; n < 4; ++n)
                    if (col_off + n < k) bd[col_off + n] = acc[0][n];
            }
            return;
        }
        auto at = [&](int i) {
            if constexpr (STAGED) return i < half ? A0 + i * k : A1 + (i - half) * k;
            return A0 + i * k;
        };
        if (k % 4 == 0) {  // the micro-tile lies wholly inside A
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                float v[4];
#pragma unroll
                for (int n = 0; n < 4; ++n)
                    v[n] = role == LOWER || m >= n ? acc[m][n] : acc[n][m];
                *reinterpret_cast<float4*>(at(row_off + m) + col_off) =
                    make_float4(v[0], v[1], v[2], v[3]);
            }
            if (role == LOWER) {
#pragma unroll
                for (int n = 0; n < 4; ++n)
                    *reinterpret_cast<float4*>(at(col_off + n) + row_off) =
                        make_float4(acc[0][n], acc[1][n], acc[2][n], acc[3][n]);
            }
        } else {
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    const int i = row_off + m, j = col_off + n;
                    if (i >= k || j >= k || (role == DIAG && n > m)) continue;
                    at(i)[j] = acc[m][n];
                    at(j)[i] = acc[m][n];
                }
        }
    };
    // the row's sums after its last tile t; called by every thread of the
    // block (the staged write has barriers)
    auto write_row = [&](long long row, int t) {
        if constexpr (!STAGED) {
            if (split > 1) {
                float* Ad = partial + (row * split + s) * (static_cast<long long>(k) * k + k);
                put(Ad, Ad, k, Ad + k * k);
            } else {
                put(A + row * k * k, A, k, b + row * k);
            }
        } else {
            // Once every thread has multiplied tile t, its buffers are free
            // until the next barrier of the main loop (the next copy into
            // s_f and the next scaling into s_g come after it): the row's A
            // is assembled there, its first `half` rows in s_f, the rest in
            // s_g (each holds 32 * KP >= half * k floats at KP <= 64), and
            // copied out in whole lines. The columns [k, KP) of s_f lose
            // their zeros; they only ever reach products outside A and b.
            float* A0 = &s_f[RAW ? t & 1 : t % STAGES][0][0];
            float* A1 = &s_g[t & 1][0][0];
            const int half = (k + 1) / 2;
            __syncthreads();
            put(A0, A1, half, b + row * k);
            __syncthreads();
            float* Ad = A + row * k * k;
            const int at1 = half * k;  // A's first value held in A1
            if (k % 4 == 0) {  // Ad is 16-byte aligned; a float4 never straddles A0 and A1
                for (int e = 4 * tid; e < k * k; e += 4 * THREADS)
                    __stcs(reinterpret_cast<float4*>(Ad + e),
                           *reinterpret_cast<const float4*>(e < at1 ? A0 + e : A1 + e - at1));
            } else {
                for (int e = tid; e < k * k; e += THREADS)
                    __stcs(Ad + e, e < at1 ? A0[e] : A1[e - at1]);
            }
        }
    };

    // s_g[gbuf] = wo * f for tile tt (the rows' fragments: no thread
    // multiplies by w), its column KP = wb (what the b threads read as
    // their row); bf16 is widened into s_f[gbuf] by the same pass
    auto scale = [&](int tt, int gbuf) {
        const int wbuf = tt % WSTAGES, nt = live_of(wbuf);
        for (int e = tid; e < nt * (KP / 4); e += THREADS) {
            const int c = e / (KP / 4), q = e % (KP / 4);
            const float w = s_w[wbuf][0][c];
            float4 f;
            if constexpr (RAW) {
                const uint2 v = *reinterpret_cast<const uint2*>(&s_raw[tt % STAGES][c][q * 4]);
                const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
                const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
                f = 4 * q < k ? make_float4(f0.x, f0.y, f1.x, f1.y)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
                *reinterpret_cast<float4*>(&s_f[gbuf][c][q * 4]) = f;
            } else {
                f = *reinterpret_cast<const float4*>(&s_f[tt % STAGES][c][q * 4]);
            }
            *reinterpret_cast<float4*>(&s_g[gbuf][c][q * 4]) =
                make_float4(f.x * w, f.y * w, f.z * w, f.w * w);
            if (q == 0) s_g[gbuf][c][KP] = s_w[wbuf][1][c];
        }
    };

    // prologue: tiles 0 .. STAGES-2 staged and their copies in flight,
    // tile STAGES-1's weights in registers, tile 0 scaled
    {
        Weights w0[STAGES - 1];
#pragma unroll
        for (int j = 0; j < STAGES - 1; ++j)
            if (j < ntot) load_weights(j, w0[j]);
#pragma unroll
        for (int j = 0; j < STAGES - 1; ++j)
            if (j < ntot) store_weights(w0[j], j);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
        if (j < ntot) copy(j, j);
        cp_async_commit();
    }
    Weights next;
    if (STAGES - 1 < ntot) load_weights(STAGES - 1, next);
    cp_async_wait<STAGES - 2>();  // tile 0 has landed
    __syncthreads();
    scale(0, 0);

    // One barrier a tile. Iteration t copies tile t+STAGES-1, scales tile
    // t+1 (landed during tile t-1's products) and multiplies tile t.
    for (int t = 0; t < ntot; ++t) {
        const int tn = t + STAGES - 1;
        if (tn < ntot) store_weights(next, tn % WSTAGES);
        if (tn + 1 < ntot) load_weights(tn + 1, next);
        cp_async_wait<STAGES - 3>();  // this thread's copies of tile t+1 have landed
        __syncthreads();  // tile t+1 and tile tn's weights visible; tile t scaled;
                          // tile t-1's products (and its row's copy-out) done
        if (tn < ntot) copy(tn, tn % STAGES);
        cp_async_commit();
        if (t + 1 < ntot) scale(t + 1, (t + 1) & 1);
        const int nt = live_of(t % WSTAGES);
        if (nt > 0) {  // uniform across the block
            const float* gt = &s_g[t & 1][0][0];
            const float* ft = &s_f[RAW ? t & 1 : t % STAGES][0][0];
            float part[4][4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n) part[m][n] = 0.f;
#pragma unroll 4
            for (int c = 0; c < nt; ++c) {
                const float4 g = *reinterpret_cast<const float4*>(gt + c * GSTRIDE + row_off);
                const float4 h = *reinterpret_cast<const float4*>(ft + c * KP + col_off);
                const float a[4] = {g.x, g.y, g.z, g.w};
                const float f[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
                for (int m = 0; m < 4; ++m)
#pragma unroll
                    for (int n = 0; n < 4; ++n) part[m][n] = fmaf(a[m], f[n], part[m][n]);
            }
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n) acc[m][n] += part[m][n];
        }
        if (t % tpr == tpr - 1) {  // the row's (or chunk's) last tile: uniform
            write_row(r0 + t / tpr, t);
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
        }
    }
}

// A[r] and b[r] as the sum of the row's `split` chunk partials, in chunk
// order (fixed: a rerun gives the same bits). Block (r, y) sums entries
// y * REDUCE_THREADS .. of row r, one a thread.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_chunks_kernel(const float* __restrict__ partial, int k, int split,
                     float* __restrict__ A, float* __restrict__ b) {
    const long long r = blockIdx.x;
    const int kk = k * k, len = kk + k;
    const int e = blockIdx.y * REDUCE_THREADS + threadIdx.x;
    if (e >= len) return;
    const float* src = partial + r * split * static_cast<long long>(len) + e;
    float sum = __ldcs(src);
    for (int s = 1; s < split; ++s) sum += __ldcs(src + static_cast<long long>(s) * len);
    if (e < kk)
        A[r * kk + e] = sum;
    else
        b[r * k + e - kk] = sum;
}

template <int KP, int ROUTE, typename T, bool STAGED>
cudaError_t launch_kernel(const T* Fg, int k, const float* wo, const float* wb, long long R,
                          int W, int split, int chunk, int rows_per_block, float* A, float* b,
                          float* partial, cudaStream_t st) {
    const long long blocks = split > 1 ? R * split : (R + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const auto kernel = rows_gram_kernel<KP, ROUTE, T, STAGED>;
    // the most shared memory per SM: more blocks of the kernel fit
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(blocks), block_threads<KP>(), 0, st>>>(
        Fg, k, wo, wb, R, W, split, chunk, rows_per_block, A, b, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess || split <= 1) return err;
    const dim3 grid(static_cast<unsigned int>(R),
                    (k * k + k + REDUCE_THREADS - 1) / REDUCE_THREADS);
    reduce_chunks_kernel<<<grid, REDUCE_THREADS, 0, st>>>(partial, k, split, A, b);
    return cudaGetLastError();
}

// Packed rows of at most STAGE_W slots are staged: there the write of A
// is most of a row's time, and at wider rows the staging's two barriers
// a row cost more than the whole lines save.
template <int KP, int ROUTE, typename T>
cudaError_t launch_kp(const T* Fg, int k, const float* wo, const float* wb, long long R,
                      int W, int split, int chunk, int rows_per_block, float* A, float* b,
                      float* partial, cudaStream_t st) {
    if constexpr (KP <= 64) {
        if (split == 1 && rows_per_block > 1 && W <= STAGE_W)
            return launch_kernel<KP, ROUTE, T, true>(Fg, k, wo, wb, R, W, split, chunk,
                                                     rows_per_block, A, b, partial, st);
    }
    return launch_kernel<KP, ROUTE, T, false>(Fg, k, wo, wb, R, W, split, chunk,
                                              rows_per_block, A, b, partial, st);
}

template <int ROUTE, typename T>
cudaError_t launch_route(const T* Fg, int k, const float* wo, const float* wb, long long R,
                         int W, int split, int chunk, int rows_per_block, float* A, float* b,
                         float* partial, cudaStream_t st) {
    if (k <= 16)
        return launch_kp<16, ROUTE>(Fg, k, wo, wb, R, W, split, chunk, rows_per_block, A, b,
                                    partial, st);
    if (k <= 32)
        return launch_kp<32, ROUTE>(Fg, k, wo, wb, R, W, split, chunk, rows_per_block, A, b,
                                    partial, st);
    if (k <= 64)
        return launch_kp<64, ROUTE>(Fg, k, wo, wb, R, W, split, chunk, rows_per_block, A, b,
                                    partial, st);
    return launch_kp<128, ROUTE>(Fg, k, wo, wb, R, W, split, chunk, rows_per_block, A, b,
                                 partial, st);
}

// 16-byte copies when k is a multiple of the values per copy and F_g is
// 16-byte aligned (every row and tile offset is then aligned too); plain
// loads otherwise
template <typename T>
cudaError_t launch(const T* Fg, int k, const float* wo, const float* wb, long long R, int W,
                   int split, int chunk, int rows_per_block, float* A, float* b,
                   float* partial, cudaStream_t st) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int ASYNC = sizeof(T) == 4 ? ASYNC_F32 : ASYNC_BF16;
    if (k % VEC == 0 && reinterpret_cast<uintptr_t>(Fg) % 16 == 0)
        return launch_route<ASYNC>(Fg, k, wo, wb, R, W, split, chunk, rows_per_block, A, b,
                                   partial, st);
    return launch_route<PLAIN>(Fg, k, wo, wb, R, W, split, chunk, rows_per_block, A, b,
                               partial, st);
}

}  // namespace

extern "C" {

// F_g: (R, W, k) f32, or bf16 when f_is_bf16; w_outer, w_b: (R, W) f32,
// row-major; outputs A (R, k, k) and b (R, k) f32, A 16-byte aligned. The
// plan (split, chunk, rows_per_block) comes from ops/rows_gram.py
// rows_plan: with split > 1 each row is cut into `split` chunks of `chunk`
// slots, none empty, `partial` holds R * split * (k*k + k) f32 and
// rows_per_block is 1; otherwise each block takes rows_per_block whole
// rows and `partial` is unused. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launches.
int pio_rows_gram(const void* Fg, int f_is_bf16, int k, const float* w_outer,
                  const float* w_b, long long R, int W, int split, int chunk,
                  int rows_per_block, float* A, float* b, float* partial, void* stream) {
    if (R <= 0 || W < 1 || k < 1 || k > MAX_K || split < 1 || split > MAX_SPLIT ||
        rows_per_block < 1 ||
        (split > 1 && (rows_per_block != 1 || partial == nullptr || chunk < 1 ||
                       static_cast<long long>(split) * chunk < W ||
                       static_cast<long long>(split - 1) * chunk >= W)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        f_is_bf16 ? launch(static_cast<const __nv_bfloat16*>(Fg), k, w_outer, w_b, R, W, split,
                           chunk, rows_per_block, A, b, partial, st)
                  : launch(static_cast<const float*>(Fg), k, w_outer, w_b, R, W, split, chunk,
                           rows_per_block, A, b, partial, st);
    return static_cast<int>(err);
}

}  // extern "C"
