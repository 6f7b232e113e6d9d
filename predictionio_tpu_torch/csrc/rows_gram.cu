// Weighted Gram over a pre-gathered block, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/gram.py rows_gram /
// _gram_kernel: for every row r,
//
//     A[r] = F_g[r]^T diag(w_outer[r]) F_g[r]     (k x k, f32)
//     b[r] = F_g[r]^T w_b[r]                      (k,     f32)
//
// with F_g (R, W, k) f32 or bf16 (bf16 values are widened to f32 as they
// are loaded, as the reference's type promotion does), w_outer and w_b
// (R, W) f32, and k <= 128. Unlike gather_gram, each row's (W, k) slab is
// contiguous in device memory.
//
// Bound on an H100 SXM, from the work the function needs: per slot of
// nonzero weight (S of them), k(k+1)/2 + 2k FMAs (w*f, the lower triangle
// of A, b), k^2 + 5k FLOP at the 67 TFLOP/s f32 rate outside the tensor
// cores; against 4*S*k (those slots' F_g rows, f32) + 8*R*W (every weight)
// + 4*R*(k^2 + k) (A and b) bytes at 3.35 TB/s. At R = 4096, W = 128,
// k = 64 with every weight nonzero that is 0.207 GB -> 62 us against
// 2.3 GFLOP -> 34 us: bytes bind.
//
// Design. One block of 16 x 16 threads per row. The row's W slots are
// walked in tiles of 4096 / KP slots (KP = k rounded up to 16, 32, 64 or
// 128, so a tile is 16 KB of f32). The tile's weights are staged in shared
// memory first, and the block finds the tile's last slot whose w_outer or
// w_b is nonzero: only the slots up to it are loaded and multiplied, so
// the pad at the end of a row (the layout of ALS buckets) costs its
// weights and nothing else, and an all-zero tile is skipped. Their
// contiguous span of F_g is staged with coalesced 16-byte loads when k
// allows it (VEC values per load: 4 f32 or 8 bf16), scalar coalesced loads
// otherwise, zero past column k. Thread (ty, tx) owns the TM x TM entries
// (ty + 16m, tx + 16n) of A, TM = KP / 16, in registers; threads of ty = 0
// also accumulate b. Each tile is summed into a register partial that is
// then added to the row's total (two-level summation: the rounding error
// grows with the tile length and the number of tiles, not with W). A is
// written in full (both triangles), b once. A zero weight adds exactly 0:
// a skipped slot's terms would all be +-0, so skipping it changes no bit.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (predictionio_tpu_torch/ops/_build.py), bound through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;     // 16 x 16
constexpr int TILE_ELEMS = 4096; // staged f32 values per shared tile
constexpr int MAX_K = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC consecutive values of F_g from `src` into `dst` (f32), one load;
// for VEC > 1 `dst` is 16-byte aligned and takes 16-byte stores.
template <int VEC, typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst) {
    if constexpr (VEC == 1) {
        dst[0] = widen(*src);
    } else if constexpr (sizeof(T) == 4) {  // 4 f32
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {                                // 8 bf16
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
        const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
        reinterpret_cast<float4*>(dst)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
        reinterpret_cast<float4*>(dst)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
}

template <int KP, int VEC, typename T>
__global__ void __launch_bounds__(THREADS)
rows_gram_kernel(const T* __restrict__ Fg, int k, const float* __restrict__ wo,
                 const float* __restrict__ wb, int W,
                 float* __restrict__ A, float* __restrict__ b) {
    constexpr int TM = KP / 16;
    constexpr int TILE = TILE_ELEMS / KP;
    __shared__ __align__(16) float s_f[TILE][KP];
    __shared__ float s_wo[TILE];
    __shared__ float s_wb[TILE];
    __shared__ int s_live[THREADS / 32];  // per warp: 1 + its last live slot

    const long long r = blockIdx.x;
    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const T* F_r = Fg + r * W * k;
    const float* wo_r = wo + r * W;
    const float* wb_r = wb + r * W;

    float acc[TM][TM];
    float bacc[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
        bacc[m] = 0.f;
#pragma unroll
        for (int n = 0; n < TM; ++n) acc[m][n] = 0.f;
    }

    for (int c0 = 0; c0 < W; c0 += TILE) {
        __syncthreads();  // the previous tile (and s_live) has been consumed
        int live = 0;
        for (int c = tid; c < min(TILE, W - c0); c += THREADS) {
            const float vo = wo_r[c0 + c], vb = wb_r[c0 + c];
            s_wo[c] = vo;
            s_wb[c] = vb;
            if (vo != 0.f || vb != 0.f) live = c + 1;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            live = max(live, __shfl_xor_sync(0xffffffffu, live, off));
        if ((tid & 31) == 0) s_live[tid >> 5] = live;
        __syncthreads();
        int nt = 0;  // the tile's slots up to its last of nonzero weight
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) nt = max(nt, s_live[w]);
        if (nt == 0) continue;  // uniform across the block
        // the tile's span of F_g is contiguous: nt * k values; VEC divides k,
        // so one load never straddles two slots
        const T* src = F_r + static_cast<long long>(c0) * k;
        for (int e = tid * VEC; e < nt * k; e += THREADS * VEC) {
            const int c = e / k;
            const int i = e - c * k;
            load_vec<VEC>(src + e, &s_f[c][i]);
        }
        if (k < KP) {  // zero past column k
            for (int e = tid; e < nt * (KP - k); e += THREADS) {
                const int c = e / (KP - k);
                s_f[c][k + e - c * (KP - k)] = 0.f;
            }
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

template <int VEC, typename T>
cudaError_t launch_vec(const T* Fg, int k, const float* wo, const float* wb,
                       long long R, int W, float* A, float* b, cudaStream_t s) {
    const dim3 grid(static_cast<unsigned int>(R));
    if (k <= 16)
        rows_gram_kernel<16, VEC, T><<<grid, THREADS, 0, s>>>(Fg, k, wo, wb, W, A, b);
    else if (k <= 32)
        rows_gram_kernel<32, VEC, T><<<grid, THREADS, 0, s>>>(Fg, k, wo, wb, W, A, b);
    else if (k <= 64)
        rows_gram_kernel<64, VEC, T><<<grid, THREADS, 0, s>>>(Fg, k, wo, wb, W, A, b);
    else
        rows_gram_kernel<128, VEC, T><<<grid, THREADS, 0, s>>>(Fg, k, wo, wb, W, A, b);
    return cudaGetLastError();
}

// 16-byte loads when k is a multiple of the values per load and F_g is
// 16-byte aligned (every row and tile offset is then aligned too)
template <typename T>
cudaError_t launch(const T* Fg, int k, const float* wo, const float* wb,
                   long long R, int W, float* A, float* b, cudaStream_t s) {
    constexpr int VEC = 16 / sizeof(T);
    if (k % VEC == 0 && reinterpret_cast<uintptr_t>(Fg) % 16 == 0)
        return launch_vec<VEC>(Fg, k, wo, wb, R, W, A, b, s);
    return launch_vec<1>(Fg, k, wo, wb, R, W, A, b, s);
}

}  // namespace

extern "C" {

// F_g: (R, W, k) f32, or bf16 when f_is_bf16; w_outer, w_b: (R, W) f32,
// row-major; outputs A (R, k, k) and b (R, k) f32. Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
int pio_rows_gram(const void* Fg, int f_is_bf16, int k, const float* w_outer,
                  const float* w_b, long long R, int W, float* A, float* b,
                  void* stream) {
    if (R <= 0 || R > 0x7fffffffLL || W < 1 || k < 1 || k > MAX_K)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err =
        f_is_bf16
            ? launch(static_cast<const __nv_bfloat16*>(Fg), k, w_outer, w_b, R, W, A, b, s)
            : launch(static_cast<const float*>(Fg), k, w_outer, w_b, R, W, A, b, s);
    return static_cast<int>(err);
}

}  // extern "C"
