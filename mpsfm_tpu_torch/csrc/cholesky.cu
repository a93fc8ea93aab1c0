// K1: reduced-camera Cholesky solve x = S^-1 rhs for one SPD matrix.
//
// Replaces the TPU kernel _chol_solve_kernel (mpsfm_tpu/ba/pallas_cholesky.py:25,
// pallas_call at :104), the solve of the dense LM-Schur BA's reduced system
// S dc = rhs with S of size K = 6C (mpsfm_tpu/ba/dense.py:256-266). Same
// function: right-looking Cholesky with d = sqrt(max(djj, 1e-20)), then the
// forward and backward substitutions, all in one launch. The Mosaic
// workarounds of the TPU kernel (iota-mask column extraction, the L^T
// scratch, the 128-padding) are not carried over.
//
// What bounds it on the H100: at K <= 1024 the work is a few tens of MFLOP
// and the matrix (<= 4 MB) sits in L2, so neither bytes nor FLOPs bound it.
// The K dependent column steps of the factorization and the 2K steps of the
// substitutions are serial, and their latency (one barrier each, plus an L2
// round trip) is the bound. The design keeps that chain as short as one
// block allows: a single block of 1024 threads works on a copy of S in
// global memory (L2-resident), holds the current column of L (and later the
// solution vector) in shared memory, and separates steps with
// __syncthreads() only. Each trailing update is spread over 32 warps, one
// row per warp and the row's columns over its lanes (coalesced). A blocked
// panel factorization with tensor cores is later work.

#include <cuda_runtime.h>

#define CHOL_THREADS 1024
#define CHOL_MAX_K 4096

__global__ void __launch_bounds__(CHOL_THREADS)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ rhs,
                  float* __restrict__ A, float* __restrict__ x, int K) {
    __shared__ float vec[CHOL_MAX_K];  // column j of L while factoring, then y / x
    __shared__ float dsh;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nt >> 5;
    const size_t KK = (size_t)K * K;

    for (size_t i = tid; i < KK; i += nt) A[i] = S[i];
    __syncthreads();

    // factor: L overwrites the lower triangle of A
    for (int j = 0; j < K; ++j) {
        if (tid == 0) {
            const float d = sqrtf(fmaxf(A[(size_t)j * K + j], 1e-20f));
            A[(size_t)j * K + j] = d;
            dsh = d;
        }
        __syncthreads();
        const float d = dsh;
        for (int i = j + 1 + tid; i < K; i += nt) {
            const float l = A[(size_t)i * K + j] / d;
            A[(size_t)i * K + j] = l;
            vec[i] = l;
        }
        __syncthreads();
        // rank-1 update of the trailing lower triangle: rows i > j, cols j < k <= i
        for (int i = j + 1 + warp; i < K; i += nwarps) {
            const float li = vec[i];
            float* row = A + (size_t)i * K;
            for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= li * vec[k];
        }
        __syncthreads();
    }

    // forward: L y = rhs
    for (int i = tid; i < K; i += nt) vec[i] = rhs[i];
    __syncthreads();
    for (int j = 0; j < K; ++j) {
        const float yj = vec[j] / A[(size_t)j * K + j];
        __syncthreads();  // every thread has read vec[j]
        if (tid == 0) vec[j] = yj;
        for (int i = j + 1 + tid; i < K; i += nt) vec[i] -= yj * A[(size_t)i * K + j];
        __syncthreads();
    }

    // backward: L^T x = y; column j of L^T is row j of L
    for (int j = K - 1; j >= 0; --j) {
        const float xj = vec[j] / A[(size_t)j * K + j];
        __syncthreads();
        if (tid == 0) vec[j] = xj;
        const float* row = A + (size_t)j * K;
        for (int i = tid; i < j; i += nt) vec[i] -= xj * row[i];
        __syncthreads();
    }

    for (int i = tid; i < K; i += nt) x[i] = vec[i];
}

// S (K,K) row-major f32, rhs (K,), work (K,K) scratch, x (K,) out.
// Returns cudaGetLastError() after the launch.
extern "C" int chol_solve_f32(const float* S, const float* rhs, float* work, float* x, int K,
                              void* stream) {
    if (K < 1 || K > CHOL_MAX_K) return (int)cudaErrorInvalidValue;
    chol_solve_kernel<<<1, CHOL_THREADS, 0, (cudaStream_t)stream>>>(S, rhs, work, x, K);
    return (int)cudaGetLastError();
}
