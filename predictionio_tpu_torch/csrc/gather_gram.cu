// Fused gather -> weighted Gram for ALS training, designed for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/gram.py gather_gram /
// _gather_gram_kernel: for every padded rating row r of a bucket,
//
//     A[r] = sum_c wo[r,c] * F[idx[r,c]] F[idx[r,c]]^T     (k x k, f32)
//     b[r] = sum_c wb[r,c] * F[idx[r,c]]                   (k,     f32)
//
// with F (n, k) f32 or bf16 (bf16 rows are widened to f32 on the chip) and
// k <= 128. The gathered (R, C, k) block never reaches device memory: only
// the indices, the weights, the gathered factor rows and the results move.
//
// Bound on an H100 SXM, from the work the function needs: per slot of
// nonzero weight, k(k+1)/2 + 2k FMAs (w*f, the lower triangle of A, b),
// k^2 + 5k FLOP at the 67 TFLOP/s f32 rate outside the tensor cores;
// against 12 bytes of index and weights per slot, F read once and A and b
// written once, at 3.35 TB/s. At k = 64 a slot costs 4,416 FLOP and 12
// bytes. By bucket class of the ML-20M layout:
//   - wide rows (C >= 512): operations-bound, 0.03-0.08 ms a bucket;
//   - C = 128: bytes-bound (weights and A about even);
//   - narrow rows (C = 8, 32): bytes-bound by the A write, 16.6 KB a row
//     (the user C = 8 bucket writes 1.76 GB: 0.53 ms, half the iteration's
//     bound).
//
// Design, each part against what held the first kernel back:
// 1. Stop at the last live slot. Each tile's indices and weights are
//    staged first; a warp-shuffle max and one barrier give the tile's last
//    slot whose wo or wb is nonzero, and only the slots up to it are
//    gathered and multiplied; an all-zero tile costs its weights only.
//    A skipped slot would add only +-0, so for finite F (ALS factors are)
//    no bit of the result changes; a non-finite row at a skipped slot
//    does not give the reference's 0 * Inf = NaN. Zero runs anywhere in a
//    row are handled the same way: only the speed rests on the pad lying
//    at the end of the row.
// 2. One triangle. A is cut into 16 x 16 sub-tiles and only the lower
//    triangle's n(n+1)/2 of them (n = KP / 16) are given to threads, 16
//    threads a sub-tile, each with a 4 x 4 micro-tile in registers. Per
//    slot a thread reads its row fragment of wo * f and its column
//    fragment of f with two 16-byte shared loads and does 16 FMAs: the
//    weight is applied once a slot by a scaling pass, not by every
//    thread. A is written mirrored from the lower values, so it is exactly
//    symmetric on any data. Six micro-tiles of each diagonal sub-tile lie
//    above the diagonal: four of them accumulate b instead, with the same
//    instruction stream (their row fragment is the scaled tile's column
//    KP, which holds (wb, 0, 0, 0)).
// 3. Overlap the gather with compute. Tiles move through a ring of
//    STAGES buffers with one barrier a tile: while tile t multiplies,
//    tile t+1 is scaled and tile t+2's factor rows are copied with 16-byte
//    cp.async, and tile t+3's indices and weights are in flight to
//    registers. The copies go through L1 (.ca): a few popular entities are
//    in most rows, and without L1 their rows all hit one L2 slice. That
//    route is taken when k % (16 / sizeof(T)) == 0 and F is 16-byte
//    aligned; bf16 is then staged raw and widened by the scaling pass.
//    Otherwise the rows are read with plain loads (the template's rank
//    10 takes it).
// 4. Split wide rows. A row of C >= 1,024 slots may be cut into `split`
//    chunks of `chunk` slots, one block each, so that buckets of few wide
//    rows (the seg bucket's 42 and the C = 8,192 bucket's 384) fill 132
//    SMs. Each chunk's partial [A | b] goes to a scratch array that the
//    wrapper allocates, and a second kernel sums the chunks in their
//    fixed order: no atomic, so a rerun is bitwise the same. The plan is
//    made from the shape alone (ops/gram.py gram_plan).
// 5. Pack narrow rows. In a many-row bucket of narrow rows (C <= 32, one
//    tile at k <= 64), a block walks rows_per_block consecutive rows
//    through the same ring, so the next row's gather overlaps this row's
//    products and the write of its A. Registers are capped so that five
//    blocks fit on an SM (KP <= 64), which keeps the A stores of the
//    narrow buckets flowing.
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
constexpr int REDUCE_THREADS = 256;

// Gather routes: plain widening loads; 16-byte cp.async of f32 rows;
// 16-byte cp.async of raw bf16 rows, widened in shared memory.
enum Route { PLAIN = 0, ASYNC_F32 = 1, ASYNC_BF16 = 2 };

// slots per tile
template <int KP> __host__ __device__ constexpr int tile_slots() {
    return KP >= 128 ? 16 : 32;
}
// 16 threads for each lower 16 x 16 sub-tile, rounded up to whole warps
template <int KP> __host__ __device__ constexpr int block_threads() {
    return (16 * (KP / 16) * (KP / 16 + 1) / 2 + 31) / 32 * 32;
}
// gathered tiles in flight (the ring of factor-row buffers); the weights
// have a ring one longer, so no barrier is needed after the products
constexpr int STAGES = 3;
constexpr int WSTAGES = STAGES + 1;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    // .ca: the factor rows of popular entities are read by many slots and
    // stay in the SM's L1 instead of all hitting one L2 slice
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
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

template <int KP, int ROUTE, typename T>
__global__ void __launch_bounds__(block_threads<KP>(), min_blocks<KP>())
gather_gram_kernel(const T* __restrict__ F, int k, const int* __restrict__ idx,
                   const float* __restrict__ wo, const float* __restrict__ wb,
                   long long R, int C, int split, int chunk, int rows_per_block,
                   float* __restrict__ A, float* __restrict__ b,
                   float* __restrict__ partial) {
    constexpr int THREADS = block_threads<KP>();
    constexpr int NWARPS = THREADS / 32;
    constexpr int TILE = tile_slots<KP>();
    constexpr int SPT = (TILE + THREADS - 1) / THREADS;  // weight slots a thread
    constexpr int GSTRIDE = KP + 4;  // s_g: wo * f, then (wb, 0, 0, 0)
    constexpr bool RAW = ROUTE == ASYNC_BF16;
    // f32 tiles: the ring the gathers land in; for bf16 the widened tiles,
    // double-buffered like s_g (the raw ring is s_raw)
    constexpr int NF = RAW ? 2 : STAGES;
    __shared__ __align__(16) float s_f[NF][TILE][KP];  // columns [k, KP) zero
    __shared__ __align__(16) float s_g[2][TILE][GSTRIDE];
    __shared__ __align__(16) __nv_bfloat16 s_raw[RAW ? STAGES : 1][RAW ? TILE : 1][KP];
    __shared__ int s_idx[WSTAGES][TILE];
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
        lo = min(C, s * chunk);
        hi = min(C, lo + chunk);
    } else {
        r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
        nrows = static_cast<int>(min(static_cast<long long>(rows_per_block), R - r0));
        lo = 0;
        hi = C;
    }
    const int tpr = (hi - lo + TILE - 1) / TILE;  // tiles a row
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

    // Tile t's indices and weights go global -> registers one iteration
    // before they are needed in shared memory (streaming loads: they are
    // read once), so their latency is off the block's path.
    struct Weights {
        int i[SPT];
        float o[SPT], b[SPT];
    };
    auto load_weights = [&](int t, Weights& w) {
        const long long row = r0 + t / tpr;
        const int c0 = lo + (t % tpr) * TILE;
        const int n = min(TILE, hi - c0);
        const long long base = row * C + c0;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
            const int e = tid + j * THREADS;
            const bool in = e < n;
            w.i[j] = in ? __ldcs(idx + base + e) : 0;
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
                s_idx[buf][e] = w.i[j];
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
    auto gather = [&](int fbuf, int wbuf) {  // factor rows of the live slots
        const int nt = live_of(wbuf);
        if constexpr (ROUTE == PLAIN) {
            for (int c = warp; c < nt; c += NWARPS) {
                const T* src = F + static_cast<long long>(s_idx[wbuf][c]) * k;
                for (int i = lane; i < k; i += 32) s_f[fbuf][c][i] = widen(src[i]);
            }
        } else {
            constexpr int VEC = 16 / sizeof(T);
            const int kq = k / VEC;  // 16-byte pieces a row, <= 32
            const int per = kq <= 8 ? 4 : kq <= 16 ? 2 : 1;  // slots a warp pass
            const int width = 32 / per;
            const int q = lane % width;
            for (int c = warp * per + lane / width; c < nt; c += NWARPS * per) {
                if (q >= kq) continue;
                const T* src = F + static_cast<long long>(s_idx[wbuf][c]) * k + q * VEC;
                if constexpr (RAW)
                    cp_async16(&s_raw[fbuf][c][q * VEC], src);
                else
                    cp_async16(&s_f[fbuf][c][q * VEC], src);
            }
        }
    };

    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

    auto write_row = [&](long long row) {
        float* Ad;
        float* bd;
        if (split > 1) {
            Ad = partial + (row * split + s) * (static_cast<long long>(k) * k + k);
            bd = Ad + k * k;
        } else {
            Ad = A + row * k * k;
            bd = b + row * k;
        }
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
        if (k % 4 == 0) {  // the micro-tile lies wholly inside A
#pragma unroll
            for (int m = 0; m < 4; ++m) {
                float v[4];
#pragma unroll
                for (int n = 0; n < 4; ++n)
                    v[n] = role == LOWER || m >= n ? acc[m][n] : acc[n][m];
                *reinterpret_cast<float4*>(Ad + (row_off + m) * k + col_off) =
                    make_float4(v[0], v[1], v[2], v[3]);
            }
            if (role == LOWER) {
#pragma unroll
                for (int n = 0; n < 4; ++n)
                    *reinterpret_cast<float4*>(Ad + (col_off + n) * k + row_off) =
                        make_float4(acc[0][n], acc[1][n], acc[2][n], acc[3][n]);
            }
        } else {
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    const int i = row_off + m, j = col_off + n;
                    if (i >= k || j >= k || (role == DIAG && n > m)) continue;
                    Ad[i * k + j] = acc[m][n];
                    Ad[j * k + i] = acc[m][n];
                }
        }
    };

    if (ntot == 0) {  // C = 0 or an empty chunk: the sums are zero
        for (int g = 0; g < nrows; ++g) write_row(r0 + g);
        return;
    }

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

    // prologue: tiles 0 .. STAGES-2 staged and their gathers in flight,
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
        if (j < ntot) gather(j, j);
        cp_async_commit();
    }
    Weights next;
    if (STAGES - 1 < ntot) load_weights(STAGES - 1, next);
    cp_async_wait<STAGES - 2>();  // tile 0 has landed
    __syncthreads();
    scale(0, 0);

    // One barrier a tile. Iteration t gathers tile t+STAGES-1, scales tile
    // t+1 (landed during tile t-1's products) and multiplies tile t.
    for (int t = 0; t < ntot; ++t) {
        const int tn = t + STAGES - 1;
        if (tn < ntot) store_weights(next, tn % WSTAGES);
        if (tn + 1 < ntot) load_weights(tn + 1, next);
        cp_async_wait<STAGES - 3>();  // this thread's copies of tile t+1 have landed
        __syncthreads();  // tile t+1 and tile tn's weights visible; tile t scaled;
                          // tile t-1's products done
        if (tn < ntot) gather(tn % STAGES, tn % WSTAGES);
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
        if (t % tpr == tpr - 1) {  // the row's (or chunk's) last tile
            write_row(r0 + t / tpr);
#pragma unroll
            for (int m = 0; m < 4; ++m)
#pragma unroll
                for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
        }
    }
}

// A[r] and b[r] as the sum of the row's `split` chunk partials, in chunk
// order (fixed: a rerun gives the same bits).
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_chunks_kernel(const float* __restrict__ partial, int k, int split,
                     float* __restrict__ A, float* __restrict__ b) {
    const long long r = blockIdx.x;
    const int kk = k * k, len = kk + k;
    const float* src = partial + r * split * static_cast<long long>(len);
    for (int e = threadIdx.x; e < len; e += REDUCE_THREADS) {
        float sum = src[e];
        for (int s = 1; s < split; ++s) sum += src[static_cast<long long>(s) * len + e];
        if (e < kk)
            A[r * kk + e] = sum;
        else
            b[r * k + e - kk] = sum;
    }
}

template <int KP, int ROUTE, typename T>
cudaError_t launch_kp(const T* F, int k, const int* idx, const float* wo, const float* wb,
                      long long R, int C, int split, int chunk, int rows_per_block,
                      float* A, float* b, float* partial, cudaStream_t st) {
    const long long blocks = split > 1 ? R * split : (R + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    // the most shared memory per SM: more blocks of the kernel fit
    cudaError_t err = cudaFuncSetAttribute(gather_gram_kernel<KP, ROUTE, T>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    gather_gram_kernel<KP, ROUTE, T><<<static_cast<unsigned int>(blocks),
                                       block_threads<KP>(), 0, st>>>(
        F, k, idx, wo, wb, R, C, split, chunk, rows_per_block, A, b, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess || split <= 1) return err;
    reduce_chunks_kernel<<<static_cast<unsigned int>(R), REDUCE_THREADS, 0, st>>>(
        partial, k, split, A, b);
    return cudaGetLastError();
}

template <int ROUTE, typename T>
cudaError_t launch_route(const T* F, int k, const int* idx, const float* wo, const float* wb,
                         long long R, int C, int split, int chunk, int rows_per_block,
                         float* A, float* b, float* partial, cudaStream_t st) {
    if (k <= 16)
        return launch_kp<16, ROUTE>(F, k, idx, wo, wb, R, C, split, chunk, rows_per_block,
                                    A, b, partial, st);
    if (k <= 32)
        return launch_kp<32, ROUTE>(F, k, idx, wo, wb, R, C, split, chunk, rows_per_block,
                                    A, b, partial, st);
    if (k <= 64)
        return launch_kp<64, ROUTE>(F, k, idx, wo, wb, R, C, split, chunk, rows_per_block,
                                    A, b, partial, st);
    return launch_kp<128, ROUTE>(F, k, idx, wo, wb, R, C, split, chunk, rows_per_block,
                                 A, b, partial, st);
}

// 16-byte copies when k is a multiple of the values per copy and F is
// 16-byte aligned (every row is then aligned too); plain loads otherwise
template <typename T>
cudaError_t launch(const T* F, int k, const int* idx, const float* wo, const float* wb,
                   long long R, int C, int split, int chunk, int rows_per_block,
                   float* A, float* b, float* partial, cudaStream_t st) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int ASYNC = sizeof(T) == 4 ? ASYNC_F32 : ASYNC_BF16;
    if (k % VEC == 0 && reinterpret_cast<uintptr_t>(F) % 16 == 0)
        return launch_route<ASYNC>(F, k, idx, wo, wb, R, C, split, chunk, rows_per_block,
                                   A, b, partial, st);
    return launch_route<PLAIN>(F, k, idx, wo, wb, R, C, split, chunk, rows_per_block,
                               A, b, partial, st);
}

}  // namespace

extern "C" {

// F: (n, k) f32, or bf16 when f_is_bf16; idx, wo, wb: (R, C) i32 / f32 /
// f32, row-major; outputs A (R, k, k) and b (R, k) f32. The plan (split,
// chunk, rows_per_block) comes from ops/gram.py gram_plan: with split > 1
// each row is cut into `split` chunks of `chunk` slots, `partial` holds
// R * split * (k*k + k) f32 and rows_per_block is 1; otherwise each
// block takes rows_per_block whole rows and `partial` is unused. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launches.
int pio_gather_gram(const void* F, int f_is_bf16, int k, const int* idx, const float* wo,
                    const float* wb, long long R, int C, int split, int chunk,
                    int rows_per_block, float* A, float* b, float* partial, void* stream) {
    if (R <= 0 || C < 0 || k < 1 || k > MAX_K || split < 1 || split > 8 ||
        rows_per_block < 1 || (split > 1 && (rows_per_block != 1 || partial == nullptr ||
                                             chunk < 1 ||
                                             static_cast<long long>(split) * chunk < C)))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        f_is_bf16 ? launch(static_cast<const __nv_bfloat16*>(F), k, idx, wo, wb, R, C, split,
                           chunk, rows_per_block, A, b, partial, st)
                  : launch(static_cast<const float*>(F), k, idx, wo, wb, R, C, split, chunk,
                           rows_per_block, A, b, partial, st);
    return static_cast<int>(err);
}

// Slots per shared-memory tile at factor width k (the width launch_route
// picks): the slots of a tile past its last one of nonzero weight are
// neither gathered nor multiplied (chip_smoke.py models the multiplied
// slots from it).
int pio_gather_gram_tile_slots(int k) {
    return k <= 16   ? tile_slots<16>()
           : k <= 32 ? tile_slots<32>()
           : k <= 64 ? tile_slots<64>()
                     : tile_slots<128>();
}

}  // extern "C"
