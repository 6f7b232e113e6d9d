// Batched SPD solve for the ALS normal equations, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/cholesky.py
// chol_solve_pallas / _solve_kernel: for each of N systems, x = A^-1 b with
// A (k x k) symmetric positive definite (ALS adds a lambda * n * I ridge),
// by a Cholesky factorisation A = L L^T, then L y = b and L^T x = y. Every
// diagonal pivot is floored as sqrt(max(d, 1e-30)) and each column of L is
// the column of the updated matrix divided by that pivot, as in the
// reference (cholesky.py:85, :262), so identity and pad systems give
// x = b exactly. Only the lower triangle of A is read.
//
// Bound on an H100 SXM, from the work the function needs: the lower
// triangle of A, b and x, 4*N*(k(k+1)/2 + 2k) bytes at 3.35 TB/s, against
// N*(k^3/3 + 2k^2) FLOP (Cholesky, two triangular solves) at 67 TFLOP/s
// f32. At N = 138,493 and k = 64 that is 1.22 GB -> 0.37 ms against
// 1.32e10 FLOP -> 0.20 ms: bytes bind.
//
// Design: the factor lives in registers. k is padded inside the kernel to
// KP in {8, 16, 32, 64, 128} with an identity tail (zeros, ones on the
// diagonal, b = 0), the reference's own padding, exact for the first k
// entries. T threads own one system (T = KP, but 16 at KP = 64), each
// COLS = KP / T columns: thread t holds columns t + T*m of the symmetric
// [A | b] (rows 0..KP-1 of A, b_c as row KP), KP + 4 floats a column, of
// which the registers keep only the rows the column can still use (rows
// >= T*m). At KP = 64 a warp so holds two systems and each thread four
// independent columns, which hides latency better than more warps of
// fewer columns (one and two columns a thread, tried first, were slower). The
// loads are coalesced: for a fixed row i the threads of a system read
// consecutive words A[i][c]. A block holds 128 threads; a system's threads
// meet at __syncwarp (T <= 32) or at a named barrier of T threads.
//
// The factorisation is right-looking. At step j the owner of column j
// publishes it to a per-system shared buffer with the floored pivot d;
// after one barrier the system's threads divide the rows i >= j by d
// between them (the divisions run in parallel) and zero the rows above;
// after a second barrier each later column c updates its rows i >= c and
// row KP, reading the published column as float4 broadcasts (one shared
// load per four FMAs), while the owner copies the scaled column back:
// thread j then holds column j of L and, in row KP, y_j of y = L^-1 b
// (forward substitution, folded in). The buffer alternates between two
// copies, so the next step's publication never waits for this step's
// readers. The column loop is unrolled in groups of four steps: within a
// group the first row that can change, the owner's column slot and the
// slots that still have work are compile-time constants, so every register
// index is static (nothing spills to local memory) and no branch is spent
// per row chunk. Back substitution uses the same ownership: the owner of
// column p holds L[:, p], so each published x_i costs one FMA on every
// p < i, and x_p = (y_p - sum) / L[p][p], in the order of the reference's
// loop; x_p reaches the other threads of a warp-sized system by a shuffle
// (no shared memory, no barrier). x is written with one coalesced store per system. The summation
// order is fixed: no atomics, the same inputs give the same bits.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// (predictionio_tpu_torch/ops/_build.py), bound through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 128;
constexpr int BLOCK = 128;  // threads per block

// barrier among the T threads of system `sys` of the block
template <int T>
__device__ __forceinline__ void system_sync(int sys) {
    if constexpr (T <= 32) {
        __syncwarp();
    } else {
        asm volatile("bar.sync %0, %1;" ::"r"(sys + 1), "n"(T) : "memory");
    }
}

template <int KP, int COLS>
__global__ void __launch_bounds__(BLOCK)
chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ x, long long N, int k) {
    constexpr int T = KP / COLS;     // threads per system
    constexpr int SPB = BLOCK / T;   // systems per block
    constexpr int ROWS = KP + 4;     // A's KP rows, b at row KP, float4 padding
    constexpr int Q = ROWS / 4;      // float4 chunks of a column
    static_assert(T % 4 == 0 && BLOCK % T == 0, "a group of 4 steps has one owner slot");
    __shared__ float4 s_col[SPB][2][Q];
    __shared__ float s_piv[SPB][2];
    __shared__ float s_x[SPB][KP];

    const int sys = threadIdx.x / T;
    const int t = threadIdx.x % T;
    const long long s = static_cast<long long>(blockIdx.x) * SPB + sys;
    const bool valid = s < N;
    const long long so = valid ? s : 0;
    const float* A_s = A + so * k * k;

    float col[COLS][ROWS];
#pragma unroll
    for (int m = 0; m < COLS; ++m) {
        const int c = t + T * m;
        const bool own = valid && c < k;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            float v = i == c ? 1.f : 0.f;  // identity tail; pad systems are identity
            if (i < KP) {
                if (own && i >= c && i < k) v = A_s[static_cast<long long>(i) * k + c];
            } else if (i == KP) {
                v = own ? b[so * k + c] : 0.f;
            }
            col[m][i] = v;
        }
    }
    float diag[COLS];  // L[c][c] of each owned column
#pragma unroll
    for (int m = 0; m < COLS; ++m) diag[m] = 1.f;

    // Cholesky of [A | b]: column j of A becomes column j of L, row KP
    // becomes y = L^-1 b. Steps 4g .. 4g+3 form group g.
#pragma unroll
    for (int g = 0; g < KP / 4; ++g) {
        if (4 * g >= k) break;
        const int mo = 4 * g / T;  // slot of this group's owners
#pragma unroll 1
        for (int j = 4 * g; j < 4 * g + 4 && j < k; ++j) {
            float4* buf = s_col[sys][j & 1];
            float* bf = reinterpret_cast<float*>(buf);
            if (t == j % T) {
#pragma unroll
                for (int q = g; q < Q; ++q)  // rows below 4g are never read
                    buf[q] = make_float4(col[mo][4 * q], col[mo][4 * q + 1],
                                         col[mo][4 * q + 2], col[mo][4 * q + 3]);
                s_piv[sys][j & 1] = sqrtf(fmaxf(bf[j], 1e-30f));
            }
            system_sync<T>(sys);
            const float d = s_piv[sys][j & 1];
#pragma unroll
            for (int i0 = 4 * g; i0 < ROWS; i0 += T) {
                const int i = i0 + t;
                if (i < ROWS) {
                    const float v = bf[i];
                    bf[i] = (i >= j && i <= KP) ? v / d : 0.f;
                }
            }
            system_sync<T>(sys);
#pragma unroll
            for (int m = 0; m < COLS; ++m) {
                if (T * (m + 1) - 1 <= 4 * g) continue;  // every column of slot m is done
                const int c = t + T * m;
                // rows >= c and row KP: chunks from the slot's first column on
                const int q0 = (T * m) / 4 > g ? (T * m) / 4 : g;
                if (c > j && c < k) {
                    const float lc = bf[c];  // L[c][j]
#pragma unroll
                    for (int q = q0; q < Q; ++q) {
                        const float4 v = buf[q];
                        col[m][4 * q] = fmaf(-v.x, lc, col[m][4 * q]);
                        col[m][4 * q + 1] = fmaf(-v.y, lc, col[m][4 * q + 1]);
                        col[m][4 * q + 2] = fmaf(-v.z, lc, col[m][4 * q + 2]);
                        col[m][4 * q + 3] = fmaf(-v.w, lc, col[m][4 * q + 3]);
                    }
                } else if (c == j) {
                    diag[m] = bf[j];
#pragma unroll
                    for (int q = g; q < Q; ++q) {
                        const float4 v = buf[q];
                        col[m][4 * q] = v.x;
                        col[m][4 * q + 1] = v.y;
                        col[m][4 * q + 2] = v.z;
                        col[m][4 * q + 3] = v.w;
                    }
                }
            }
        }
    }

    // L^T x = y. Row KP was divided by the pivots d_j, where a separate
    // forward substitution divides by L[j][j] = s_jj / d_j: the same value
    // up to rounding for SPD systems, and exactly 1 for identity systems.
    float yv[COLS];  // y_c, less the x_i (i > c) as they are published
    float xc[COLS];
#pragma unroll
    for (int m = 0; m < COLS; ++m) {
        yv[m] = col[m][KP];
        xc[m] = 0.f;
    }
#pragma unroll
    for (int i = KP - 1; i >= 0; --i) {
        if (i < k) {
            float xi;
            if constexpr (T <= 32) {
                // every thread divides its own slot; the owner's quotient is
                // broadcast within the system's T lanes
                xi = __shfl_sync(0xffffffffu, yv[i / T] / diag[i / T], i % T, T);
                if (t == i % T) xc[i / T] = xi;
            } else {
                if (t == i % T) {
                    xc[i / T] = yv[i / T] / diag[i / T];
                    s_x[sys][i] = xc[i / T];
                }
                system_sync<T>(sys);
                xi = s_x[sys][i];
            }
#pragma unroll
            for (int m = 0; m < COLS; ++m)
                if (T * m < i && t + T * m < i) yv[m] = fmaf(-col[m][i], xi, yv[m]);
        }
    }
#pragma unroll
    for (int m = 0; m < COLS; ++m) {
        const int c = t + T * m;
        if (valid && c < k) x[s * k + c] = xc[m];
    }
}

template <int KP, int COLS>
cudaError_t launch(const float* A, const float* b, float* x, long long N, int k,
                   cudaStream_t s) {
    constexpr int SPB = BLOCK / (KP / COLS);
    const long long blocks = (N + SPB - 1) / SPB;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    chol_solve_kernel<KP, COLS><<<static_cast<unsigned int>(blocks), BLOCK, 0, s>>>(A, b, x, N, k);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// A: (N, k, k) f32 SPD, b: (N, k) f32 -> x: (N, k) f32, row-major. Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch.
int pio_chol_solve(const float* A, const float* b, float* x, long long N, int k,
                   void* stream) {
    if (N <= 0 || k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (k <= 8)
        err = launch<8, 1>(A, b, x, N, k, s);
    else if (k <= 16)
        err = launch<16, 1>(A, b, x, N, k, s);
    else if (k <= 32)
        err = launch<32, 1>(A, b, x, N, k, s);
    else if (k <= 64)
        err = launch<64, 4>(A, b, x, N, k, s);
    else
        err = launch<128, 1>(A, b, x, N, k, s);
    return static_cast<int>(err);
}

}  // extern "C"
