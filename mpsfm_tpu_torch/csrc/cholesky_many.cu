// K1 with many right-hand sides: X = S^-1 B for one SPD S (K x K) and B (K x N).
//
// The covariance's reduced solve (mpsfm_tpu/ba/covariance.py:91-93: cho_factor
// of S + 1e-8 I, then cho_solve of the 3P columns T_p B_p^-1), which the JAX
// package leaves to XLA; it is K1's consumer with many right-hand sides (the
// TPU kernel K1 is _chol_solve_kernel, mpsfm_tpu/ba/pallas_cholesky.py:25).
// Three launches on the caller's stream:
//   1. chol_solve_kernel<false> (cholesky.cu, included below): K1's blocked
//      factorization in one block, into the workspace's U = L^T
//      (U[k K + i] = L[i][k], k <= i);
//   2. chol_pack_kernel: L's 32 x 32 tiles of the lower triangle, one block
//      each, copied into the two layouts the substitution stages (F for the
//      forward, G = its transpose for the backward), zero-padded where K is
//      ragged, with each diagonal block replaced by its inverse (one warp, a
//      column a lane, by forward substitution of the identity);
//   3. chol_subst_kernel: one block of 128 threads per tile of NT = 64 columns
//      of B. Forward (L y = b) and backward (L^T x = y) by 32-row blocks: a
//      block's update B_blk - sum_k L_blk,k Y_k (backward: L^T) and then its
//      triangle, Linv_blk (B_blk - ...), are the same register-tiled product of
//      a 32 x 32 tile of L by a 32 x NT chunk of Y, both staged in shared
//      memory (cp.async, double-buffered), each thread holding a TM x 4 = 4 x 4
//      block of the result: per k one 16-byte load of L and one of Y for
//      16 FMA. All warps share every triangle. Y, then X, live in the output
//      X in global memory (written once per block, read back through L2 as
//      staged chunks), so shared memory (32 KB) does not depend on K and one
//      code path holds for every K up to CHOL_MAX_K.
// Each of a block's 32 unknowns is its row of Linv_blk times the block's
// right-hand side, where the substitution divides as it goes; the bounds of
// chip_smoke.py's K1_REL hold (tests/test_torch_cholesky.py, card cases).
//
// What bounds it on the H100: the substitutions are 2 K^2 N FLOP (7.2 GFLOP at
// K = 384, N = 24 576: ~0.11 ms at the float32 peak) over K^2 + 2 K N floats
// (38 MB: ~0.011 ms at 3.35 TB/s), so the operations. What sets the pace is
// the instruction slots the product's shared loads take beside its FMAs,
// then the two block barriers per chunk and one exposed chunk load per 32-row
// block. On an H100 SXM at 700 W (k1_many_probe.py, K = 384, N = 24 576) the substitution
// takes ~0.26 ms at TM = 4 (2 loads per 16 FMA) and ~0.35 ms at TM = 2 (2 per
// 8), whatever the warp layout WX (3 or 2 shared-memory wavefronts a warp
// per k at TM = 2 made no difference). The factorization is K1's single
// block (~0.25 ms at K = 384). chip_smoke.py times the three kernels apart.

#include <stdint.h>

#include "cholesky.cu"

#define SUB_NT 64                                  // columns of B a block
#define SUB_TM 4                                   // rows of a thread's block of results (2 or 4), 4 columns each
#define SUB_WX 8                                   // threads of a warp along the columns (8 or 16)
#define SUB_THREADS (CHOL_NB / SUB_TM * SUB_NT / 4)  // one thread a TM x 4 block of a 32 x NT block
#define SUB_TILE (CHOL_NB * CHOL_NB)               // floats of a packed 32 x 32 tile
#define SUB_CHUNK (CHOL_NB * SUB_NT)               // floats of a staged 32 x NT chunk of Y
#define PACK_THREADS 256

static_assert(SUB_TM == 2 || SUB_TM == 4, "a thread's rows are one 8- or 16-byte load of the tile");
static_assert((SUB_NT / 4) % SUB_WX == 0 && (CHOL_NB / SUB_TM) % (32 / SUB_WX) == 0, "warps must tile the block");
static_assert(SUB_TILE % (4 * SUB_THREADS) == 0 && SUB_CHUNK % (4 * SUB_THREADS) == 0, "16-byte staging");

// cp.async of kBytes (16: through L2 only; 4: through L1) from global to
// shared memory, zeros where !in (src is then not read)
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool in) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (kBytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory"); }

// Tile slot t of the lower triangle (c, k), k <= c, is t = c (c + 1) / 2 + k (tri_tile):
//   F[t][k'][i] = L[32c + i][32k + k'] for k < c,  F[t(c, c)][k'][i] = Linv_c[i][k'],
//   G[t][k'][i] = F[t][i][k'],
// so the forward's chunk k of block c is F[t(c, k)] (the product's A[i][k'] =
// L[32c+i][32k+k']) and the backward's chunk k > b of block b is G[t(k, b)]
// (A[i][k'] = L^T[32b+i][32k+k']); rows and columns at or beyond K are 0.
__global__ void __launch_bounds__(PACK_THREADS)
chol_pack_kernel(const float* __restrict__ U, float* __restrict__ F, float* __restrict__ G, int K) {
    __shared__ float T[CHOL_NB][TB_STRIDE];  // T[k'][i] = L[32c + i][32k + k']
    __shared__ float Xi[CHOL_NB][TB_STRIDE]; // diagonal tiles: Xi[k'][i] = Linv[i][k']
    int c, k;
    tri_tile(blockIdx.x, c, k);
    const int r0 = c * CHOL_NB, k0 = k * CHOL_NB, nb = min(CHOL_NB, K - r0);
    for (int e = threadIdx.x; e < SUB_TILE; e += PACK_THREADS) {  // U[(k0+k') K + r0+i]: coalesced in i
        const int kp = e / CHOL_NB, i = e % CHOL_NB;
        T[kp][i] = (r0 + i < K && k0 + kp <= r0 + i) ? U[(size_t)(k0 + kp) * K + r0 + i] : 0.f;
    }
    __syncthreads();
    const bool diag = c == k;
    if (diag && threadIdx.x < CHOL_NB) {
        // lane j: column j of Linv from L x = e_j; padded rows (i >= nb) solve
        // x_i = delta_ij and are zeroed below
        const int j = threadIdx.x;
        float x[CHOL_NB];
#pragma unroll
        for (int i = 0; i < CHOL_NB; ++i) {
            float s = i == j ? 1.f : 0.f;
#pragma unroll
            for (int q = 0; q < i; ++q) s -= T[q][i] * x[q];
            x[i] = s / (i < nb ? T[i][i] : 1.f);
        }
#pragma unroll
        for (int i = 0; i < CHOL_NB; ++i) Xi[j][i] = (i < nb && j < nb) ? x[i] : 0.f;
    }
    __syncthreads();
    const float(*A)[TB_STRIDE] = diag ? Xi : T;
    float* f = F + (size_t)blockIdx.x * SUB_TILE;
    float* g = G + (size_t)blockIdx.x * SUB_TILE;
    for (int e = threadIdx.x; e < SUB_TILE; e += PACK_THREADS) {
        const int kp = e / CHOL_NB, i = e % CHOL_NB;
        f[e] = A[kp][i];
        g[e] = A[i][kp];
    }
}

// a thread's TM rows of one column of a staged tile: one 8- or 16-byte load
__device__ __forceinline__ void load_rows(const float* p, float (&a)[2]) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x, a[1] = v.y;
}
__device__ __forceinline__ void load_rows(const float* p, float (&a)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}

// acc[r][q] += sum_k' A[k'][TM ty + r] Y[k'][4 tx + q] over a staged tile A
// ([k'][i], 32 x 32) and chunk Y ([k'][n], 32 x NT)
__device__ __forceinline__ void tile_product(const float* A, const float* Y, float (&acc)[SUB_TM][4], int tx,
                                             int ty) {
#pragma unroll
    for (int kp = 0; kp < CHOL_NB; ++kp) {
        float a[SUB_TM];
        load_rows(A + kp * CHOL_NB + SUB_TM * ty, a);
        const float4 y = *reinterpret_cast<const float4*>(Y + kp * SUB_NT + 4 * tx);
#pragma unroll
        for (int r = 0; r < SUB_TM; ++r) {
            acc[r][0] = fmaf(a[r], y.x, acc[r][0]);
            acc[r][1] = fmaf(a[r], y.y, acc[r][1]);
            acc[r][2] = fmaf(a[r], y.z, acc[r][2]);
            acc[r][3] = fmaf(a[r], y.w, acc[r][3]);
        }
    }
}

// Stage a packed tile (16-byte copies)
__device__ __forceinline__ void stage_tile(float* As, const float* tile) {
#pragma unroll
    for (int u = 0; u < SUB_TILE / 4 / SUB_THREADS; ++u) {
        const int f = 4 * (threadIdx.x + u * SUB_THREADS);
        cp_async<16>(As + f, tile + f, true);
    }
}

// Stage rows 32 kb .. 32 kb + 31 of X, columns n0 .. n0 + NT - 1, into Ys[k'][n]
// (zeros at or beyond K and N). kVec: N % 4 == 0 and X 16-byte aligned, one
// 16-byte copy per 4 columns; else one 4-byte copy per value.
template <bool kVec>
__device__ __forceinline__ void stage_chunk(float* Ys, const float* X, int kb, int n0, int K, int N) {
    if (kVec) {
#pragma unroll
        for (int u = 0; u < SUB_CHUNK / 4 / SUB_THREADS; ++u) {
            const int f = threadIdx.x + u * SUB_THREADS, kp = f / (SUB_NT / 4), n = 4 * (f % (SUB_NT / 4));
            const int row = kb * CHOL_NB + kp;
            const bool in = row < K && n0 + n < N;
            cp_async<16>(Ys + kp * SUB_NT + n, in ? X + (size_t)row * N + n0 + n : X, in);
        }
    } else {
#pragma unroll
        for (int u = 0; u < SUB_CHUNK / SUB_THREADS; ++u) {
            const int f = threadIdx.x + u * SUB_THREADS, kp = f / SUB_NT, n = f % SUB_NT;
            const int row = kb * CHOL_NB + kp;
            const bool in = row < K && n0 + n < N;
            cp_async<4>(Ys + kp * SUB_NT + n, in ? X + (size_t)row * N + n0 + n : X, in);
        }
    }
}

// Forward (L y = b, y into X) then backward (L^T x = y, x over y in X) for
// the columns n0 .. n0 + NT - 1 of B.
template <bool kVec>
__global__ void __launch_bounds__(SUB_THREADS)
chol_subst_kernel(const float* __restrict__ F, const float* __restrict__ G, const float* __restrict__ B, float* X,
                  int K, int N) {
    __shared__ __align__(16) float As[2][SUB_TILE];
    __shared__ __align__(16) float Ys[2][SUB_CHUNK];
    __shared__ __align__(16) float Ts[SUB_CHUNK];  // a block's right-hand side before its triangle
    // a warp covers (32 / WX) x WX threads' blocks: 4 TM-row loads of the tile
    // and WX 4-column loads of the chunk per k
    constexpr int kWarpsX = SUB_NT / 4 / SUB_WX;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int tx = (warp % kWarpsX) * SUB_WX + lane % SUB_WX, ty = (warp / kWarpsX) * (32 / SUB_WX) + lane / SUB_WX;
    const int n0 = blockIdx.x * SUB_NT, nblk = (K + CHOL_NB - 1) / CHOL_NB;

    // One 32-row block: chunks j = 0 .. m - 1 of its update (tile tile(j),
    // rows of X yrow(j)), then its triangle (tile tile(m)) on rhs - update;
    // rhs (src) and the result (X) at rows 32 blk.
    auto block = [&](int blk, int m, const float* src, auto tile, auto yrow) {
        float acc[SUB_TM][4] = {};
        stage_tile(As[0], tile(0));
        if (m > 0) stage_chunk<kVec>(Ys[0], X, yrow(0), n0, K, N);
        cp_async_commit();
        for (int j = 0; j < m; ++j) {  // stage chunk j + 1 (or the triangle) while chunk j is multiplied
            stage_tile(As[(j + 1) & 1], tile(j + 1));
            if (j + 1 < m) stage_chunk<kVec>(Ys[(j + 1) & 1], X, yrow(j + 1), n0, K, N);
            cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();
            tile_product(As[j & 1], Ys[j & 1], acc, tx, ty);
            __syncthreads();  // chunk j's buffers are staged again at j + 2
        }
        cp_async_wait<0>();
        const int n = n0 + 4 * tx;
#pragma unroll
        for (int r = 0; r < SUB_TM; ++r) {
            const int row = blk * CHOL_NB + SUB_TM * ty + r;
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            if (row < K) {
                const float* s = src + (size_t)row * N + n;
                if (kVec && n < N) {
                    const float4 s4 = *reinterpret_cast<const float4*>(s);
                    v[0] = s4.x, v[1] = s4.y, v[2] = s4.z, v[3] = s4.w;
                } else if (!kVec) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) v[q] = n + q < N ? s[q] : 0.f;
                }
            }
            *reinterpret_cast<float4*>(Ts + (SUB_TM * ty + r) * SUB_NT + 4 * tx) =
                make_float4(v[0] - acc[r][0], v[1] - acc[r][1], v[2] - acc[r][2], v[3] - acc[r][3]);
        }
        __syncthreads();  // the triangle's tile and the block's right-hand side are staged
        float out[SUB_TM][4] = {};
        tile_product(As[m & 1], Ts, out, tx, ty);
#pragma unroll
        for (int r = 0; r < SUB_TM; ++r) {
            const int row = blk * CHOL_NB + SUB_TM * ty + r;
            if (row >= K) continue;
            float* x = X + (size_t)row * N + n;
            if (kVec) {
                if (n < N) *reinterpret_cast<float4*>(x) = make_float4(out[r][0], out[r][1], out[r][2], out[r][3]);
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (n + q < N) x[q] = out[r][q];
            }
        }
        __syncthreads();  // As, Ts free again; the block's rows of X visible to the next blocks' staging
    };

    for (int c = 0; c < nblk; ++c) {  // chunks k = 0 .. c - 1: F[t(c, k)], consecutive slots
        const float* Fc = F + (size_t)(c * (c + 1) / 2) * SUB_TILE;
        block(c, c, B, [&](int j) { return Fc + (size_t)j * SUB_TILE; }, [&](int j) { return j; });
    }
    for (int b = nblk - 1; b >= 0; --b) {  // chunks k = b + 1 .. nblk - 1: G[t(k, b)], then G[t(b, b)]
        block(b, nblk - 1 - b, X,
              [&](int j) {
                  const int k = j < nblk - 1 - b ? b + 1 + j : b;
                  return G + (size_t)(k * (k + 1) / 2 + b) * SUB_TILE;
              },
              [&](int j) { return b + 1 + j; });
    }
}

// floats of the workspace at K: the packed tiles F and G, then U (K x K)
static size_t many_tiles(int K) {
    const size_t nblk = (K + CHOL_NB - 1) / CHOL_NB;
    return nblk * (nblk + 1) / 2 * SUB_TILE;
}

// S (K,K) row-major f32 (its lower triangle is read), B (K,N) row-major,
// work (2 T + K^2 floats, T = 1024 nblk (nblk + 1) / 2, nblk = ceil(K / 32):
// F, G, then U; 16-byte aligned), X (K,N) out. Returns cudaGetLastError()
// after the launches.
extern "C" int chol_solve_many_f32(const float* S, const float* B, float* work, float* X, int K, int N,
                                   void* stream) {
    if (K < 1 || K > CHOL_MAX_K || N < 1 || (uintptr_t)work % 16) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    float *F = work, *G = work + many_tiles(K), *U = work + 2 * many_tiles(K);
    cudaError_t err = cudaFuncSetAttribute(chol_solve_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)((SM_FIXED + CHOL_MAX_K) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (SM_FIXED + (size_t)K) * sizeof(float);
    chol_solve_kernel<false><<<1, CHOL_THREADS, smem, st>>>(S, nullptr, U, nullptr, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    chol_pack_kernel<<<(unsigned)(many_tiles(K) / SUB_TILE), PACK_THREADS, 0, st>>>(U, F, G, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const bool vec = N % 4 == 0 && (uintptr_t)B % 16 == 0 && (uintptr_t)X % 16 == 0;
    if (vec)
        chol_subst_kernel<true><<<(N + SUB_NT - 1) / SUB_NT, SUB_THREADS, 0, st>>>(F, G, B, X, K, N);
    else
        chol_subst_kernel<false><<<(N + SUB_NT - 1) / SUB_NT, SUB_THREADS, 0, st>>>(F, G, B, X, K, N);
    return (int)cudaGetLastError();
}
