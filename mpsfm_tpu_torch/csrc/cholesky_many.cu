// K1 with many right-hand sides: X = S^-1 B for one SPD S (K x K) and B (K x N).
//
// The covariance's reduced solve (mpsfm_tpu/ba/covariance.py:91-93: cho_factor
// of S + 1e-8 I, then cho_solve of the 3P columns T_p B_p^-1), which the JAX
// package leaves to XLA; it is K1's consumer with many right-hand sides (the
// TPU kernel K1 is _chol_solve_kernel, mpsfm_tpu/ba/pallas_cholesky.py:25).
// Two launches on the caller's stream:
//   1. chol_solve_kernel<false> (cholesky.cu, included below): K1's blocked
//      factorization in one block, into the workspace W, which then holds
//      U = L^T in its upper triangle (W[k K + i] = L[i][k], k <= i);
//   2. chol_subst_kernel: one block per tile of 32 columns of B (one column
//      per lane), blocked forward (L y = b) and backward (L^T x = y)
//      substitution by 32-row blocks. The 8 warps form the block's dot
//      products with the rows already solved (4 rows each, left-looking:
//      each product is accumulated in registers and the block's rows are
//      written once), then warp 0 solves the block's 32 x 32 triangle, held
//      in shared memory, for its 32 columns. L is read through L1/L2 (590 KB
//      at K = 384, shared by every tile); y and x live in X in global memory
//      (the tile's K x 32 floats, 48 KB at K = 384), never whole in shared
//      memory, so the design holds for every K up to CHOL_MAX_K.
//
// What bounds it on the H100: the substitutions are 2 K^2 N FLOP (7.2 GFLOP
// at K = 384, N = 24 576: ~0.11 ms at the float32 peak) over K^2 + 2 K N
// floats (38 MB: ~0.011 ms at 3.35 TB/s), so the operations. This design
// makes one broadcast load of L per FMA (the 4 rows of a warp share each
// load of y), and warp 0 solves every triangle alone while the other warps
// wait: the load instructions and that serial part bound it, not the FMA
// rate. The factorization is K1's single block (~0.29 ms at K = 384). On an
// H100 SXM at 700 W the whole solve takes ~1.67 ms at that shape, the
// substitution ~1.40 ms of it (chip_smoke.py).

#include "cholesky.cu"

#define SUB_THREADS 256
#define SUB_WARPS (SUB_THREADS / 32)
#define SUB_ROWS (CHOL_NB / SUB_WARPS)  // rows of a 32-row block per warp

static_assert(SUB_ROWS * SUB_WARPS == CHOL_NB, "the warps must cover a block's rows");

__global__ void __launch_bounds__(SUB_THREADS)
chol_subst_kernel(const float* __restrict__ W, const float* __restrict__ B, float* X, int K, int N) {
    __shared__ float tb[CHOL_NB][32];              // tb[j][lane]: row j of the block, the tile's columns
    __shared__ float Tr[CHOL_NB][CHOL_NB + 1];     // the block's triangle
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n = blockIdx.x * 32 + lane;
    const bool col = n < N;

    // ---- forward: L y = b, y into X ----
    for (int c0 = 0; c0 < K; c0 += CHOL_NB) {
        const int nb = min(CHOL_NB, K - c0);
        const int r0 = c0 + SUB_ROWS * warp;  // this warp's rows r0 .. r0 + SUB_ROWS - 1
        if (r0 < c0 + nb) {
            float acc[SUB_ROWS] = {};
            for (int k = 0; k < c0; ++k) {  // L[r][k] = W[k K + r]: the warp's rows share a line
                const float yk = col ? X[(size_t)k * N + n] : 0.f;
                const float* lk = W + (size_t)k * K + r0;
#pragma unroll
                for (int j = 0; j < SUB_ROWS; ++j)
                    if (r0 + j < c0 + nb) acc[j] += lk[j] * yk;
            }
#pragma unroll
            for (int j = 0; j < SUB_ROWS; ++j)
                if (r0 + j < c0 + nb) tb[r0 + j - c0][lane] = (col ? B[(size_t)(r0 + j) * N + n] : 0.f) - acc[j];
        }
        for (int e = threadIdx.x; e < CHOL_NB * CHOL_NB; e += SUB_THREADS) {  // Tr[j][k] = L[c0+j][c0+k]
            const int k = e / CHOL_NB, j = e % CHOL_NB;
            Tr[j][k] = (j < nb && k <= j) ? W[(size_t)(c0 + k) * K + c0 + j] : 0.f;
        }
        __syncthreads();
        if (warp == 0) {
            float v[CHOL_NB];
#pragma unroll
            for (int j = 0; j < CHOL_NB; ++j) {
                if (j < nb) {
                    float t = tb[j][lane];
#pragma unroll
                    for (int k = 0; k < j; ++k) t -= Tr[j][k] * v[k];
                    v[j] = t / Tr[j][j];
                    if (col) X[(size_t)(c0 + j) * N + n] = v[j];
                }
            }
        }
        __syncthreads();
    }

    // ---- backward: L^T x = y, x over y in X ----
    for (int b0 = ((K - 1) / CHOL_NB) * CHOL_NB; b0 >= 0; b0 -= CHOL_NB) {
        const int nb = min(CHOL_NB, K - b0);
        const int e0 = b0 + nb;
        const int r0 = b0 + SUB_ROWS * warp;
        if (r0 < e0) {
            float acc[SUB_ROWS] = {};
            for (int k = e0; k < K; ++k) {  // L^T[r][k] = W[r K + k]
                const float xk = col ? X[(size_t)k * N + n] : 0.f;
#pragma unroll
                for (int j = 0; j < SUB_ROWS; ++j)
                    if (r0 + j < e0) acc[j] += W[(size_t)(r0 + j) * K + k] * xk;
            }
#pragma unroll
            for (int j = 0; j < SUB_ROWS; ++j)
                if (r0 + j < e0) tb[r0 + j - b0][lane] = (col ? X[(size_t)(r0 + j) * N + n] : 0.f) - acc[j];
        }
        for (int e = threadIdx.x; e < CHOL_NB * CHOL_NB; e += SUB_THREADS) {  // Tr[j][k] = L^T[b0+j][b0+k]
            const int j = e / CHOL_NB, k = e % CHOL_NB;
            Tr[j][k] = (j < nb && k < nb && k >= j) ? W[(size_t)(b0 + j) * K + b0 + k] : 0.f;
        }
        __syncthreads();
        if (warp == 0) {
            float v[CHOL_NB];
#pragma unroll
            for (int j = CHOL_NB - 1; j >= 0; --j) {
                if (j < nb) {
                    float t = tb[j][lane];
#pragma unroll
                    for (int k = j + 1; k < CHOL_NB; ++k)
                        if (k < nb) t -= Tr[j][k] * v[k];
                    v[j] = t / Tr[j][j];
                    if (col) X[(size_t)(b0 + j) * N + n] = v[j];
                } else {
                    v[j] = 0.f;
                }
            }
        }
        __syncthreads();
    }
}

// S (K,K) row-major f32 (its lower triangle is read), B (K,N) row-major,
// work (K,K) scratch, X (K,N) out. Returns cudaGetLastError() after the
// launches.
extern "C" int chol_solve_many_f32(const float* S, const float* B, float* work, float* X, int K, int N,
                                   void* stream) {
    if (K < 1 || K > CHOL_MAX_K || N < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(chol_solve_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)((SM_FIXED + CHOL_MAX_K) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (SM_FIXED + (size_t)K) * sizeof(float);
    chol_solve_kernel<false><<<1, CHOL_THREADS, smem, (cudaStream_t)stream>>>(S, nullptr, work, nullptr, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chol_subst_kernel<<<(N + 31) / 32, SUB_THREADS, 0, (cudaStream_t)stream>>>(work, B, X, K, N);
    return (int)cudaGetLastError();
}
