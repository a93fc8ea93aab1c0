// K1: reduced-camera Cholesky solve x = S^-1 rhs for one SPD matrix.
//
// Replaces the TPU kernel _chol_solve_kernel (mpsfm_tpu/ba/pallas_cholesky.py:25,
// pallas_call at :104), the solve of the dense LM-Schur BA's reduced system
// S dc = rhs with S of size K = 6C (mpsfm_tpu/ba/dense.py:256-266). Same
// function: Cholesky of the lower triangle of S with d = sqrt(max(djj, 1e-20))
// on every diagonal entry, then the forward and backward substitutions, all
// in one launch. The Mosaic workarounds of the TPU kernel (iota-mask column
// extraction, the L^T scratch, the 128-padding) are not carried over.
//
// Design: a right-looking blocked Cholesky with 32-wide panels in one block
// of 256 threads (8 warps, so up to 255 registers a thread: under the
// 128-register cap of 512 threads the tiles' accumulators spill). Per panel
// [c0, c0 + nb), nb = min(32, K - c0):
//   1. warp 0 factors the nb x nb diagonal block in registers, column by
//      column (the column broadcast through shared memory, no block barrier
//      inside), and solves the forward substitution's 32 unknowns of the block;
//   2. each thread owns one row of the panel below (nb = 32 there: only the
//      last panel is ragged, and nothing lies below it), solves its 32
//      unknowns L21 = A21 L11^-T in registers, reading L11 from shared memory,
//      and applies the block's forward-substitution update to its row of y;
//   3. the trailing update A22 -= L21 L21^T on the lower triangle only: the
//      panel is staged in shared memory (in chunks of CHOL_CW columns) and
//      every warp takes 32 x 64 tiles on its own, 64 outputs per lane, so
//      FMAs and not shared-memory reads set the pace. Warp 0 takes the tile
//      that holds the next diagonal block, keeps that block in shared memory
//      and factors it (step 1 of the next panel) while the others finish.
// Two block barriers per panel. The backward substitution goes by 32-row
// blocks from the bottom: all warps form the dot products of the block's
// rows with the solved tail, then warp 0 solves the block's triangle.
//
// Layout: the workspace holds L transposed (U = L^T in its upper triangle,
// i.e. L column-major), filled by a tiled transpose of S's lower triangle at
// the start. Every panel access is then coalesced: a column of the panel
// below the diagonal block is a row segment of U, the trailing update's
// operands are rows of U and the backward substitution's dot products read
// rows of U. The matrix stays in global memory (590 KB at K = 384, 4 MB at
// K = 1024: L2-resident); shared memory holds the staged panel, the diagonal
// block and the solution vector, and the design holds for every K up to
// CHOL_MAX_K.
//
// What bounds it on the H100: at K <= 1024 neither bytes nor FLOPs of the
// whole card do. One SM's FP32 FMA rate in the trailing update (K^3/6 FMA,
// ~9.4 M at K = 384, ~45 us at 128 FMA per clock), the L2 round trips of
// its read-modify-write of the trailing matrix, and warp 0's serial chain
// (corner tile, then the 32 columns of the next diagonal block) set the pace.
// The tiles' products run near the FMA issue rate; with two warps per
// scheduler the write-back's L2 latency is not hidden. No tensor cores: TF32
// is off by the port's precision policy, and a 3xTF32 split is later work, as
// is a trailing update spread over several SMs.

#include <cuda_runtime.h>

#define CHOL_THREADS 256
#define CHOL_WARPS (CHOL_THREADS / 32)
#define CHOL_NB 32
#define CHOL_MAX_K 4096
#define CHOL_CW 704     // columns of the panel staged in shared memory at a time (a chunk; multiple of 64)
#define TB_STRIDE 33    // padded row of a 32 x 32 shared tile
// dynamic shared memory, in floats
#define SM_OP (CHOL_NB * CHOL_CW)  // one staged chunk: op[j][c] = U[c0+j][r0+ka+c]
#define SM_LC (CHOL_NB * CHOL_NB)  // Lc[j][k] = L11[k][j] (column j of the diagonal block)
#define SM_INV CHOL_NB             // 1 / L11[j][j]
#define SM_FIXED (2 * SM_OP + SM_LC + SM_INV)

static_assert(CHOL_WARPS * 32 * TB_STRIDE <= SM_OP, "per-warp transpose tiles must fit a chunk buffer");
static_assert(CHOL_WARPS * 32 + CHOL_NB * TB_STRIDE <= SM_OP, "backward scratch must fit a chunk buffer");
static_assert((SM_FIXED + CHOL_MAX_K) * 4 + 4 * CHOL_NB * (CHOL_NB + 4) <= 232448,
              "more shared memory than a block may have");

// A 16-byte shared-memory load the compiler may not hoist: the panel solve
// reads the same 528 values of L11 for every row, and hoisted out of the row
// loop they would not fit the registers and spill.
__device__ __forceinline__ float4 lds4(const float* p) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"((unsigned)__cvta_generic_to_shared(p))
                 : "memory");
    return v;
}

__device__ __forceinline__ float lds(const float* p) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"((unsigned)__cvta_generic_to_shared(p)) : "memory");
    return v;
}

// tile n of a lower triangle of T x T tiles, row-major: (it, kt) with kt <= it
__device__ __forceinline__ void tri_tile(int n, int& it, int& kt) {
    it = 0;
    while ((it + 1) * (it + 2) / 2 <= n) ++it;
    kt = n - it * (it + 1) / 2;
}

// op[j][c] = panel[j * K + c] for the n columns of one chunk (all threads);
// a thread's 32 loads are issued before its stores, so they wait one round
// trip together and not one each
__device__ __forceinline__ void stage_chunk(float* op, const float* panel, int K, int n, int tid) {
    for (int c = tid; c < n; c += CHOL_THREADS) {
        float v[CHOL_NB];
#pragma unroll
        for (int j = 0; j < CHOL_NB; ++j) v[j] = panel[j * K + c];
#pragma unroll
        for (int j = 0; j < CHOL_NB; ++j) op[j * CHOL_CW + c] = v[j];
    }
}

// One warp's 32 x 64 tile of the trailing update: U22[k][i] -= sum_j
// opA[j][kl] opB[j][il] for the tile's kl = k - ka, il = i - ib, written where
// i < m and k <= i. Lane owns columns il = lane and 32 + lane of all 32 rows:
// the rows' operands are the same for every lane (broadcast loads) and each
// load or store of C covers one 128-byte line. With Dnext (the tile at the
// trailing matrix's corner), its first 32 columns, the next diagonal block,
// also go to Dnext[lane][k] = U22[k][lane] for k <= lane.
__device__ __forceinline__ void syrk_tile(const float* opA, const float* opB, float* W, int K, int r0, int m,
                                          int ka, int ib, int kt, int it, int lane,
                                          float (*Dnext)[CHOL_NB + 1]) {
    const float* pa = opA + kt * 32;
    const float* pb = opB + it * 64 + lane;
    float acc[32][2] = {};
#pragma unroll 2
    for (int j = 0; j < CHOL_NB; ++j) {
        float av[32];
#pragma unroll
        for (int u4 = 0; u4 < 8; ++u4) {
            const float4 a = *reinterpret_cast<const float4*>(pa + j * CHOL_CW + 4 * u4);
            av[4 * u4] = a.x;
            av[4 * u4 + 1] = a.y;
            av[4 * u4 + 2] = a.z;
            av[4 * u4 + 3] = a.w;
        }
        const float b0 = pb[j * CHOL_CW], b1 = pb[j * CHOL_CW + 32];
#pragma unroll
        for (int u = 0; u < 32; ++u) {
            acc[u][0] += av[u] * b0;
            acc[u][1] += av[u] * b1;
        }
    }
    // write back eight rows at a time, all loads before any store: W may alias
    // itself for the compiler, and a load after a store waits a round trip
    const int i0 = ib + it * 64 + lane, i1 = i0 + 32;
    const int kb = ka + kt * 32;
#pragma unroll
    for (int u0 = 0; u0 < 32; u0 += 8) {
        float c[8][2];
#pragma unroll
        for (int uu = 0; uu < 8; ++uu) {
            const int k = kb + u0 + uu;
            const float* row = W + (r0 + k) * K + r0;
            c[uu][0] = (i0 < m && k <= i0) ? row[i0] : 0.f;
            c[uu][1] = (i1 < m && k <= i1) ? row[i1] : 0.f;
        }
#pragma unroll
        for (int uu = 0; uu < 8; ++uu) {
            const int k = kb + u0 + uu;
            float* row = W + (r0 + k) * K + r0;
            if (i0 < m && k <= i0) row[i0] = c[uu][0] - acc[u0 + uu][0];
            if (i1 < m && k <= i1) row[i1] = c[uu][1] - acc[u0 + uu][1];
            if (Dnext) Dnext[lane][u0 + uu] = (i0 < m && k <= i0) ? c[uu][0] - acc[u0 + uu][0] : 0.f;
        }
    }
}

// Warp 0: factor the nb x nb diagonal block at c0 held in D[lane][k] (row
// `lane` of the block, k <= lane), write L11 to W (U layout), Lc and inv, and
// solve the forward substitution's block: y[c0:c0+nb] = L11^-1 y[c0:c0+nb].
// Lane keeps its row in registers. The serial chain per column is kept
// short: lane j+1 computes the next pivot ahead of the other updates and
// publishes it in pv, the column goes to all lanes through col (double
// buffered: one __syncwarp per column), and d and 1/d come from one rsqrt.
// (A shuffle ends a basic block on its convergence check; with one per
// element the column updates would issue one at a time.)
__device__ __forceinline__ void factor_diag(float (*D)[CHOL_NB + 1], float (*col)[CHOL_NB], float* pv, float* Lc,
                                            float* inv, float* y, float* W, int K, int c0, int nb, int lane) {
    const unsigned FULL = 0xffffffffu;
    float r[CHOL_NB];
#pragma unroll
    for (int k = 0; k < CHOL_NB; ++k) r[k] = (k <= lane && lane < nb) ? D[lane][k] : 0.f;
    if (lane == 0) pv[0] = D[0][0];
    __syncwarp();
    float rd_own = 0.f;
#pragma unroll
    for (int j = 0; j < CHOL_NB; ++j) {
        if (j < nb) {
            const float xj = fmaxf(pv[j], 1e-20f);
            const float rd = rsqrtf(xj);
            const float l = lane > j ? r[j] * rd : 0.f;
            if (lane == j) rd_own = rd;
            r[j] = lane == j ? xj * rd : lane > j ? l : r[j];
            col[j & 1][lane] = l;
            if (j + 1 < CHOL_NB && lane == j + 1) pv[j + 1] = r[j + 1] - l * l;
            __syncwarp();
#pragma unroll
            for (int k = j + 1; k < CHOL_NB; ++k)
                if (lane >= k) r[k] -= l * col[j & 1][k];
        }
    }
#pragma unroll
    for (int k = 0; k < CHOL_NB; ++k) {
        Lc[k * CHOL_NB + lane] = r[k];
        if (k <= lane && lane < nb) W[(c0 + k) * K + c0 + lane] = r[k];
    }
    inv[lane] = rd_own;
    float v = lane < nb ? y[c0 + lane] : 0.f;
#pragma unroll
    for (int j = 0; j < CHOL_NB; ++j) {
        if (j < nb) {
            if (lane == j) v *= rd_own;
            const float yj = __shfl_sync(FULL, v, j);
            if (lane > j) v -= r[j] * yj;
        }
    }
    if (lane < nb) y[c0 + lane] = v;
    __syncwarp();  // pv and col are written again by the next call
}

__global__ void __launch_bounds__(CHOL_THREADS, 1)
chol_solve_kernel(const float* __restrict__ S, const float* __restrict__ rhs,
                  float* W, float* __restrict__ x, int K) {
    extern __shared__ __align__(16) float smem[];
    float* opA = smem;
    float* opB = smem + SM_OP;
    float* Lc = opB + SM_OP;
    float* inv = Lc + SM_LC;
    float* y = inv + SM_INV;
    __shared__ float D[CHOL_NB][CHOL_NB + 1];  // the diagonal block to factor, row `lane` per lane
    __shared__ float col[2][CHOL_NB];          // its current column, for all lanes
    __shared__ float pv[CHOL_NB];              // its pivots
    const unsigned FULL = 0xffffffffu;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // ---- W's upper triangle = S's lower triangle transposed (32 x 32 tiles, one per warp) ----
    {
        float* buf = opA + warp * 32 * TB_STRIDE;
        const int T = (K + 31) / 32;
        for (int n = warp; n < T * (T + 1) / 2; n += CHOL_WARPS) {
            int ti, tk;  // tile (ti, tk) of S's lower triangle, tk <= ti
            tri_tile(n, ti, tk);
#pragma unroll
            for (int q = 0; q < 32; ++q) {
                const int i = ti * 32 + q, k = tk * 32 + lane;
                buf[q * TB_STRIDE + lane] = (i < K && k <= i) ? S[i * K + k] : 0.f;
            }
            __syncwarp();
#pragma unroll
            for (int q = 0; q < 32; ++q) {
                const int k = tk * 32 + q, i = ti * 32 + lane;
                if (i < K && k <= i) W[k * K + i] = buf[lane * TB_STRIDE + q];
            }
            __syncwarp();
        }
    }
    for (int i = tid; i < K; i += CHOL_THREADS) y[i] = rhs[i];
    __syncthreads();

    // ---- the first diagonal block ----
    if (warp == 0) {
        const int nb = min(CHOL_NB, K);
#pragma unroll
        for (int k = 0; k < CHOL_NB; ++k) D[lane][k] = (k <= lane && lane < nb) ? W[k * K + lane] : 0.f;
        __syncwarp();
        factor_diag(D, col, pv, Lc, inv, y, W, K, 0, nb, lane);
    }
    __syncthreads();

    for (int c0 = 0;; c0 += CHOL_NB) {
        const int nb = min(CHOL_NB, K - c0);
        const int r0 = c0 + nb;
        const int m = K - r0;
        if (m == 0) break;  // the last panel (nb may be < 32 only here) is factored

        // ---- panel solve: thread owns row i of L21 (column i of U), 32 unknowns ----
        for (int i = r0 + tid; i < K; i += CHOL_THREADS) {
            float v[CHOL_NB];
#pragma unroll
            for (int j = 0; j < CHOL_NB; ++j) v[j] = W[(c0 + j) * K + i];
#pragma unroll
            for (int j = 0; j < CHOL_NB; ++j) {
                v[j] *= lds(inv + j);
#pragma unroll
                for (int k4 = (j + 1) & ~3; k4 < CHOL_NB; k4 += 4) {
                    const float4 l = lds4(Lc + j * CHOL_NB + k4);
                    if (k4 + 0 > j) v[k4 + 0] -= l.x * v[j];
                    if (k4 + 1 > j) v[k4 + 1] -= l.y * v[j];
                    if (k4 + 2 > j) v[k4 + 2] -= l.z * v[j];
                    if (k4 + 3 > j) v[k4 + 3] -= l.w * v[j];
                }
            }
            float s = 0.f;  // forward substitution: y[i] -= L21[i, :] . y[c0:c0+32]
#pragma unroll
            for (int j = 0; j < CHOL_NB; ++j) {
                W[(c0 + j) * K + i] = v[j];
                s += v[j] * lds(y + c0 + j);
            }
            y[i] -= s;
        }
        __syncthreads();

        // ---- trailing update: U22[k][i] -= sum_j U[c0+j][r0+k] U[c0+j][r0+i], k <= i ----
        // The panel's rows are staged in chunks of CHOL_CW columns; for each
        // pair of chunks (a <= b) the warps take 32 x 64 tiles on their own.
        // Tile 0 (the corner, which holds the next diagonal block) is warp 0's,
        // which then factors that block; the other warps share the other tiles.
        {
            const float* panel = W + c0 * K + r0;
            const int nch = (m + CHOL_CW - 1) / CHOL_CW;
            for (int a = 0; a < nch; ++a) {
                const int ka = a * CHOL_CW, na = min(CHOL_CW, m - ka);
                stage_chunk(opA, panel + ka, K, na, tid);
                for (int b = a; b < nch; ++b) {
                    const int ib = b * CHOL_CW, nbb = min(CHOL_CW, m - ib);
                    if (b != a) stage_chunk(opB, panel + ib, K, nbb, tid);
                    __syncthreads();
                    const float* ob = b != a ? opB : opA;
                    const int nk = (na + 31) / 32, ni = (nbb + 63) / 64;
                    // a == b: only tiles with some k <= i, i.e. kt <= 2 it + 1
                    int ntiles = nk * ni;
                    if (a == b) {
                        ntiles = 0;
                        for (int it = 0; it < ni; ++it) ntiles += min(nk, 2 * it + 2);
                    }
                    const bool corner = a == 0 && b == 0;
                    if (corner && warp == 0) {
                        syrk_tile(opA, ob, W, K, r0, m, ka, ib, 0, 0, lane, D);
                        __syncwarp();
                        factor_diag(D, col, pv, Lc, inv, y, W, K, r0, min(CHOL_NB, m), lane);
                    }
                    const int w0 = corner ? 1 : 0;  // tiles n >= w0 go to warps w0, w0 + 1, ...
                    for (int n = warp; warp >= w0 && n < ntiles; n += CHOL_WARPS - w0) {
                        int it = n / nk, kt = n % nk;
                        if (a == b) {
                            int rest = n;
                            for (it = 0; rest >= min(nk, 2 * it + 2); ++it) rest -= min(nk, 2 * it + 2);
                            kt = rest;
                        }
                        syrk_tile(opA, ob, W, K, r0, m, ka, ib, kt, it, lane, nullptr);
                    }
                    __syncthreads();
                }
            }
        }
    }

    // ---- backward: L^T x = y, i.e. U x = y with U = W's upper triangle ----
    float* part = opA;                   // part[w][r]: warp w's share of row r's dot product
    float* tri = opA + CHOL_WARPS * 32;  // tri[q][lane] = U[b0+q][b0+lane]
    for (int b0 = ((K - 1) / CHOL_NB) * CHOL_NB; b0 >= 0; b0 -= CHOL_NB) {
        const int nb = min(CHOL_NB, K - b0);
        const int e0 = b0 + nb;
        if (e0 < K) {  // dot products U[b0+r][e0:] . x[e0:] (nb = 32 here), warp w on columns e0+32w+lane, ...
            float p[CHOL_NB];
#pragma unroll
            for (int r = 0; r < CHOL_NB; ++r) p[r] = 0.f;
            for (int c = e0 + warp * 32; c < K; c += CHOL_THREADS) {
                const int k = c + lane;
                if (k < K) {
                    const float xk = y[k];
#pragma unroll
                    for (int r = 0; r < CHOL_NB; ++r) p[r] += W[(b0 + r) * K + k] * xk;
                }
            }
            // reduce-scatter over the warp: afterwards lane r holds the warp's sum for row r
#pragma unroll
            for (int o = 16; o >= 1; o >>= 1) {
#pragma unroll
                for (int r = 0; r < o; ++r) {
                    const bool hi = lane & o;
                    const float send = hi ? p[r] : p[r + o];
                    const float keep = hi ? p[r + o] : p[r];
                    p[r] = keep + __shfl_xor_sync(FULL, send, o);
                }
            }
            part[warp * 32 + lane] = p[0];
        }
        if (warp == 0) {
#pragma unroll
            for (int q = 0; q < CHOL_NB; ++q)
                tri[q * TB_STRIDE + lane] = (q < nb && lane < nb) ? W[(b0 + q) * K + b0 + lane] : 0.f;
        }
        __syncthreads();
        if (warp == 0) {
            const float dinv = lane < nb ? 1.f / tri[lane * TB_STRIDE + lane] : 0.f;
            float v = lane < nb ? y[b0 + lane] : 0.f;
            if (e0 < K) {
#pragma unroll
                for (int w = 0; w < CHOL_WARPS; ++w) v -= part[w * 32 + lane];
            }
#pragma unroll 4
            for (int j = nb - 1; j >= 0; --j) {
                if (lane == j) v *= dinv;
                const float xj = __shfl_sync(FULL, v, j);
                if (lane < j) v -= tri[lane * TB_STRIDE + j] * xj;
            }
            if (lane < nb) y[b0 + lane] = v;
            __syncwarp();
        }
        __syncthreads();
    }

    for (int i = tid; i < K; i += CHOL_THREADS) x[i] = y[i];
}

// S (K,K) row-major f32 (its lower triangle is read), rhs (K,), work (K,K)
// scratch, x (K,) out. Returns cudaGetLastError() after the launch.
extern "C" int chol_solve_f32(const float* S, const float* rhs, float* work, float* x, int K,
                              void* stream) {
    if (K < 1 || K > CHOL_MAX_K) return (int)cudaErrorInvalidValue;
    // the attribute belongs to the current device: set it on every launch
    const cudaError_t err = cudaFuncSetAttribute(chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)((SM_FIXED + CHOL_MAX_K) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (SM_FIXED + (size_t)K) * sizeof(float);
    chol_solve_kernel<<<1, CHOL_THREADS, smem, (cudaStream_t)stream>>>(S, rhs, work, x, K);
    return (int)cudaGetLastError();
}
