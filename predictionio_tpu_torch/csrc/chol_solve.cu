// Batched SPD solve for the ALS normal equations, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/cholesky.py
// chol_solve_pallas / _solve_kernel: for each of N systems, x = A^-1 b with
// A (k x k) symmetric positive definite (ALS adds a lambda * n * I ridge),
// by a Cholesky factorisation A = L L^T, then L y = b and L^T x = y. Every
// diagonal pivot is floored as sqrt(max(d, 1e-30)) and each column of L is
// the column of the updated matrix divided by that pivot, as in the
// reference (cholesky.py:85, :262), so identity and pad systems give
// x = b exactly.
//
// Bound on an H100 SXM, from the work the function needs: the lower
// triangle of A, b and x, 4*N*(k(k+1)/2 + 2k) bytes at 3.35 TB/s, against
// N*(k^3/3 + 2k^2) FLOP (Cholesky, two triangular solves) at 67 TFLOP/s
// f32. At N = 138,493 and k = 64 that is 1.22 GB -> 0.37 ms against
// 1.32e10 FLOP -> 0.20 ms: bytes bind.
//
// Design. One warp per system, W systems per block. The TPU kernel's 8 x 8
// blocking, explicit diagonal inverses and lane-major (k, k, N) transpose
// exist for the TPU's vector layout and are not carried over. The warp
// reads the lower triangle of its A into shared memory (coalesced row-major
// loads) with an odd row stride, so lanes that read the same column of 32
// different rows hit 32 different banks, and b as an extra row k below it.
// The factorisation is left-looking (Crout): for column j each lane takes
// the rows i >= j it owns (i = j + lane + 32t), row k included, and
// subtracts the dot product of row i and row j of L over the first j
// columns (row j is a broadcast read) in four independent partial sums, so
// the shared-memory loads of one FMA chain overlap the others; then it
// divides by the floored pivot. Row k of the factor of [A | b] is then
// y = L^-1 b (forward substitution, folded in); back substitution walks
// the columns of L, lanes updating the remaining entries of y in parallel.
// x is written once. k <= 128 (67 KB of shared memory for one system at
// k = 128, which needs the opt-in above 48 KB).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (predictionio_tpu_torch/ops/_build.py), bound through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 128;
constexpr int MAX_W = 8;                 // systems (warps) per block
constexpr int BLOCK_SMEM_TARGET = 70000; // bytes of shared memory per block

__host__ __device__ __forceinline__ int row_stride(int k) { return k | 1; }

__host__ __device__ __forceinline__ int system_floats(int k) {
    return (k + 1) * row_stride(k);  // L (k rows), then y = L^-1 b (row k)
}

__global__ void chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                                  float* __restrict__ x, long long N, int k, int W) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long s = static_cast<long long>(blockIdx.x) * W + warp;
    if (s >= N) return;  // the whole warp leaves; the block never syncs
    const int ld = row_stride(k);
    float* L = smem + warp * system_floats(k);
    float* y = L + k * ld;
    const float* A_s = A + s * k * k;

    for (int e = lane; e < k * k; e += 32) {
        const int i = e / k;
        const int j = e - i * k;
        if (j <= i) L[i * ld + j] = A_s[e];
    }
    for (int i = lane; i < k; i += 32) y[i] = b[s * k + i];
    __syncwarp();

    // Cholesky of [A | b]: rows 0..k-1 become L, row k becomes y = L^-1 b
    for (int j = 0; j < k; ++j) {
        const float* Lj = L + j * ld;
        for (int i = j + lane; i <= k; i += 32) {
            const float* Li = L + i * ld;
            float a0 = Li[j], a1 = 0.f, a2 = 0.f, a3 = 0.f;
            int p = 0;
            for (; p + 4 <= j; p += 4) {
                a0 = fmaf(-Li[p], Lj[p], a0);
                a1 = fmaf(-Li[p + 1], Lj[p + 1], a1);
                a2 = fmaf(-Li[p + 2], Lj[p + 2], a2);
                a3 = fmaf(-Li[p + 3], Lj[p + 3], a3);
            }
            for (; p < j; ++p) a0 = fmaf(-Li[p], Lj[p], a0);
            L[i * ld + j] = (a0 + a1) + (a2 + a3);
        }
        __syncwarp();
        const float d = sqrtf(fmaxf(Lj[j], 1e-30f));
        __syncwarp();  // every lane has read the pivot before it is scaled
        for (int i = j + lane; i <= k; i += 32) L[i * ld + j] /= d;
        __syncwarp();
    }

    // L^T x = y. Row k was divided by the pivots d_j, where a separate
    // forward substitution divides by L[j][j] = s_jj / d_j: the same value
    // up to rounding for SPD systems, and exactly 1 for identity systems.
    for (int p = k - 1; p >= 0; --p) {
        const float xp = y[p] / L[p * ld + p];
        __syncwarp();
        for (int i = lane; i < p; i += 32) y[i] = fmaf(-L[p * ld + i], xp, y[i]);
        if (lane == 0) y[p] = xp;
        __syncwarp();
    }
    for (int i = lane; i < k; i += 32) x[s * k + i] = y[i];
}

}  // namespace

extern "C" {

// A: (N, k, k) f32 SPD, b: (N, k) f32 -> x: (N, k) f32, row-major. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch.
int pio_chol_solve(const float* A, const float* b, float* x, long long N, int k,
                   void* stream) {
    if (N <= 0 || k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
    const size_t per_sys = sizeof(float) * system_floats(k);
    int W = static_cast<int>(BLOCK_SMEM_TARGET / per_sys);
    W = W < 1 ? 1 : (W > MAX_W ? MAX_W : W);
    const size_t smem = per_sys * W;
    const long long blocks = (N + W - 1) / W;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    // above the 48 KB default, opt in on every call: the attribute is set
    // for the current device only, and setting it is cheap
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    chol_solve_kernel<<<static_cast<unsigned int>(blocks), 32 * W, smem, s>>>(A, b, x, N, k, W);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
