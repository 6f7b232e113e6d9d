// Fused gather -> weighted Gram for ALS training, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/gram.py gather_gram /
// _gather_gram_kernel: for every padded rating row r of a bucket,
//
//     A[r] = sum_c wo[r,c] * F[idx[r,c]] F[idx[r,c]]^T     (k x k, f32)
//     b[r] = sum_c wb[r,c] * F[idx[r,c]]                   (k,     f32)
//
// with F (n, k) f32 or bf16 (bf16 rows are widened to f32 as they are
// loaded) and k <= 128. The gathered (R, C, k) block never reaches device
// memory: only the indices, the weights, the gathered factor rows and the
// results move.
//
// Bound on an H100 SXM, from the work the function needs: per slot of
// nonzero weight, k(k+1)/2 + 2k FMAs (w*f, the lower triangle of A, b),
// k^2 + 5k FLOP at the 67 TFLOP/s f32 rate outside the tensor cores;
// against 12 bytes of index and weights per slot, F read once and A and b
// written once, at 3.35 TB/s. At k = 64 a slot costs 4,416 FLOP and 12
// bytes, so the wide buckets are operations-bound; at C = 8 the k x k
// output (16 KB per row) makes the bucket bytes-bound.
//
// Design. One block of 16 x 16 threads per row. The row's C slots are walked
// in tiles of 4096 / KP slots (KP = k rounded up to 16, 32, 64 or 128, so a
// tile is 16 KB of f32): the tile's indices and weights are staged in shared
// memory, then its factor rows are gathered into a (tile x KP) shared array,
// zero past column k. Thread (ty, tx) owns the TM x TM entries
// (ty + 16m, tx + 16n) of A, TM = KP / 16, so a warp reads each tile row
// as 16 consecutive words plus two broadcast words: no bank conflicts. Each
// tile is summed into a register partial that is then added to the row's
// total (two-level summation: the rounding error grows with the tile
// length and the number of tiles, not with C). Threads of ty = 0 also
// accumulate b. A is written in full (both triangles), b once. A zero
// weight adds exactly 0, so pad slots (index 0, weight 0) are inert.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (predictionio_tpu_torch/ops/_build.py), bound through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // 16 x 16
constexpr int TILE_ELEMS = 4096; // gathered f32 values per shared tile
constexpr int MAX_K = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int KP, typename T>
__global__ void __launch_bounds__(THREADS)
gather_gram_kernel(const T* __restrict__ F, int k,
                   const int* __restrict__ idx, const float* __restrict__ wo,
                   const float* __restrict__ wb, int C,
                   float* __restrict__ A, float* __restrict__ b) {
    constexpr int TM = KP / 16;
    constexpr int TILE = TILE_ELEMS / KP;
    __shared__ float s_f[TILE][KP];
    __shared__ float s_wo[TILE];
    __shared__ float s_wb[TILE];
    __shared__ int s_idx[TILE];

    const long long r = blockIdx.x;
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int* idx_r = idx + r * C;
    const float* wo_r = wo + r * C;
    const float* wb_r = wb + r * C;

    float acc[TM][TM];
    float bacc[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
        bacc[m] = 0.f;
#pragma unroll
        for (int n = 0; n < TM; ++n) acc[m][n] = 0.f;
    }

    for (int c0 = 0; c0 < C; c0 += TILE) {
        const int nt = min(TILE, C - c0);
        __syncthreads();  // the previous tile has been consumed
        for (int c = tid; c < nt; c += THREADS) {
            s_idx[c] = idx_r[c0 + c];
            s_wo[c] = wo_r[c0 + c];
            s_wb[c] = wb_r[c0 + c];
        }
        __syncthreads();
        for (int e = tid; e < nt * KP; e += THREADS) {
            const int c = e / KP;  // KP is a power of two: shifts
            const int i = e % KP;
            s_f[c][i] = i < k ? widen(F[static_cast<long long>(s_idx[c]) * k + i]) : 0.f;
        }
        __syncthreads();

        float part[TM][TM];
        float bpart[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            bpart[m] = 0.f;
#pragma unroll
            for (int n = 0; n < TM; ++n) part[m][n] = 0.f;
        }
#pragma unroll 4
        for (int c = 0; c < nt; ++c) {
            const float w = s_wo[c];
            float a[TM];
            float f[TM];
#pragma unroll
            for (int m = 0; m < TM; ++m) a[m] = s_f[c][ty + 16 * m] * w;
#pragma unroll
            for (int n = 0; n < TM; ++n) f[n] = s_f[c][tx + 16 * n];
#pragma unroll
            for (int m = 0; m < TM; ++m)
#pragma unroll
                for (int n = 0; n < TM; ++n) part[m][n] = fmaf(a[m], f[n], part[m][n]);
            if (ty == 0) {
                const float v = s_wb[c];
#pragma unroll
                for (int n = 0; n < TM; ++n) bpart[n] = fmaf(v, f[n], bpart[n]);
            }
        }
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            bacc[m] += bpart[m];
#pragma unroll
            for (int n = 0; n < TM; ++n) acc[m][n] += part[m][n];
        }
    }

    float* A_r = A + r * k * k;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
        const int i = ty + 16 * m;
        if (i >= k) continue;
#pragma unroll
        for (int n = 0; n < TM; ++n) {
            const int j = tx + 16 * n;
            if (j < k) A_r[i * k + j] = acc[m][n];
        }
    }
    if (ty == 0) {
#pragma unroll
        for (int n = 0; n < TM; ++n) {
            const int j = tx + 16 * n;
            if (j < k) b[r * k + j] = bacc[n];
        }
    }
}

template <typename T>
cudaError_t launch(const T* F, int k, const int* idx, const float* wo, const float* wb,
                   long long R, int C, float* A, float* b, cudaStream_t s) {
    const dim3 grid(static_cast<unsigned int>(R));
    if (k <= 16)
        gather_gram_kernel<16, T><<<grid, THREADS, 0, s>>>(F, k, idx, wo, wb, C, A, b);
    else if (k <= 32)
        gather_gram_kernel<32, T><<<grid, THREADS, 0, s>>>(F, k, idx, wo, wb, C, A, b);
    else if (k <= 64)
        gather_gram_kernel<64, T><<<grid, THREADS, 0, s>>>(F, k, idx, wo, wb, C, A, b);
    else
        gather_gram_kernel<128, T><<<grid, THREADS, 0, s>>>(F, k, idx, wo, wb, C, A, b);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// F: (n, k) f32, or bf16 when f_is_bf16; idx, wo, wb: (R, C) i32 / f32 /
// f32, row-major; outputs A (R, k, k) and b (R, k) f32. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch.
int pio_gather_gram(const void* F, int f_is_bf16, int k,
                    const int* idx, const float* wo, const float* wb,
                    long long R, int C, float* A, float* b, void* stream) {
    if (R <= 0 || R > 0x7fffffffLL || C < 0 || k < 1 || k > MAX_K)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        f_is_bf16
            ? launch(static_cast<const __nv_bfloat16*>(F), k, idx, wo, wb, R, C, A, b, s)
            : launch(static_cast<const float*>(F), k, idx, wo, wb, R, C, A, b, s);
    return static_cast<int>(err);
}

}  // extern "C"
