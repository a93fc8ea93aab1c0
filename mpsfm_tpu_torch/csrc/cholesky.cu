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
// Two routes, chosen by K in the wrapper (ba/cholesky.py, GRID_MIN_K): one block
// below the crossover, the whole card from it on. Both run the same blocked
// algorithm with the same arithmetic; the grid route sums the backward
// substitution's products in another order.
//
// The one-block route (chol_solve_kernel): a right-looking blocked Cholesky
// with 32-wide panels in one block
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
// The grid route (chol_grid_kernel, below): the same panels in one cooperative
// launch of min(SMs, the first trailing update's 64 x 64 tiles) CTAs of 256
// threads, one a SM, with a barrier of the grid's CTAs through a counter in L2
// (K2's, csrc/bini.cu) after each panel's two steps: the panel solve split by
// rows over the CTAs, then the trailing update in 64 x 64 tiles dealt to the
// CTAs in a fixed order (cp.async-staged operands, 4 x 4 outputs a thread),
// the corner tile's CTA factoring the next diagonal block from shared memory
// while the others finish. The backward substitution is spread too: block q
// of x is CTA q mod G's, which takes each later block's update as soon as
// that block is published (each value with its block's tag in one 64-bit
// word), then solves its triangle. Every element's updates run in a fixed order on a fixed CTA, so x
// is the same from run to run.
//
// Layout: the workspace holds L transposed (U = L^T in its upper triangle,
// i.e. L column-major), filled by a tiled transpose of S's lower triangle at
// the start. Every panel access is then coalesced: a column of the panel
// below the diagonal block is a row segment of U, the trailing update's
// operands are rows of U and the backward substitution's dot products read
// rows of U. The matrix stays in global memory (590 KB at K = 384, 4 MB at
// K = 1024: L2-resident); shared memory holds the staged panel, the diagonal
// block and the solution vector, and the design holds for every K up to
// CHOL_MAX_K. The grid route's rows are grid_ld(K) floats apart (K rounded up
// to 4), so its 16-byte copies are aligned at every K.
//
// What bounds it on the H100: at every K up to 4096 neither the card's bytes
// (K^2 floats once: 2.5 us at K = 1024) nor its FLOPs (K^3/3: 5.4 us at the
// float32 peak) do; latency chains do. On one block, one SM's FP32 FMA rate in
// the trailing update (K^3/6 FMA, ~9.4 M at K = 384, ~45 us at 128 FMA per
// clock), the L2 round trips of its read-modify-write and warp 0's serial
// chain set the pace: 0.29 ms at K = 384 and 2.9 ms at K = 1024. On the grid
// each panel costs a fixed chain: the panel solve (~2.2 us: L11 and the rows
// from L2, then a 32-step chain a row), a barrier (~0.9 us), the corner tile
// (~2.1 us) and the diagonal block (~3.7 us, one warp), a barrier; so ~9.5 us
// a panel while the other CTAs' tiles take less (K <= 2048), and from K ~ 2048
// the tiles themselves, ~1.2 us each at 8-9 tiles a CTA a panel early on,
// where each panel re-reads and re-writes the whole trailing matrix through
// L2; then the backward substitution's hand-off per 32-row block (~2.3 us).
// chip_smoke.py times both routes and k1_probe.py splits the grid route's
// time. No tensor cores: TF32 is off by the port's precision policy, and a
// 3xTF32 split is later work, as are wider panels (half the trailing update's
// L2 traffic) and panels solved ahead of their barrier.

#include <cuda_runtime.h>
#include <stdint.h>

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

// SOLVE = false (csrc/cholesky_many.cu) factors only: rhs and x are not
// read or written, the forward substitution runs on a zero vector, and W
// holds U = L^T in its upper triangle when the kernel returns.
template <bool SOLVE>
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
    for (int i = tid; i < K; i += CHOL_THREADS) y[i] = SOLVE ? rhs[i] : 0.f;
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

    if constexpr (!SOLVE) return;

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
    const cudaError_t err = cudaFuncSetAttribute(chol_solve_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)((SM_FIXED + CHOL_MAX_K) * sizeof(float)));
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (SM_FIXED + (size_t)K) * sizeof(float);
    chol_solve_kernel<true><<<1, CHOL_THREADS, smem, (cudaStream_t)stream>>>(S, rhs, work, x, K);
    return (int)cudaGetLastError();
}

// ---- the grid route: one persistent cooperative launch over the whole card ----
//
// The one-block kernel above is left as it is; the grid route repeats its
// panel solve, transpose and backward substitution with rows ld floats
// apart and with every read of W and y from L2 (other CTAs wrote them).

#define GRID_THREADS 256                           // threads a CTA
#define GRID_WARPS (GRID_THREADS / 32)
#define GRID_TILE 64                               // the trailing update's tiles: GRID_TILE x GRID_TILE outputs
#define GRID_OP (CHOL_NB * GRID_TILE)              // a staged operand: op[j][c] = U[c0 + j][r0 + off + c]
#define GRID_UNION (GRID_WARPS * 32 * TB_STRIDE)   // two (A, B) buffers, or the transpose's tiles
#define GRID_D (CHOL_NB * (CHOL_NB + 1))
// dynamic shared memory, in floats: the union, Lc, inv, D, yb
#define GRID_FIXED (GRID_UNION + SM_LC + SM_INV + GRID_D + CHOL_NB)
#define GRID_TIMEOUT_CYCLES (20LL * 1000 * 1000 * 1000)  // ~10 s of SM clock: an open barrier traps

static_assert(4 * GRID_OP <= GRID_UNION, "two staged (A, B) pairs must fit the union");
static_assert(2 * GRID_OP % (4 * GRID_THREADS) == 0, "16-byte staging of a tile's (A, B)");
static_assert((GRID_TILE / 4) * (GRID_TILE / 4) == GRID_THREADS, "a thread owns 4 x 4 outputs of a tile");

// rows of the grid route's W are ld = K rounded up to a multiple of 4 floats, so every
// 16-byte chunk the trailing update stages or writes back is aligned
__host__ __device__ __forceinline__ int grid_ld(int K) { return (K + 3) & ~3; }

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

// One warp: tile n (tri_tile) of S's lower triangle of 32 x 32 tiles, transposed
// into W's upper triangle, through buf (32 x TB_STRIDE floats of shared memory)
__device__ __forceinline__ void grid_transpose_tile(const float* __restrict__ S, float* W, int K, int ld, int n,
                                                    float* buf, int lane) {
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
        if (i < K && k <= i) W[k * ld + i] = buf[lane * TB_STRIDE + q];
    }
    __syncwarp();
}

// Row i of the panel below the diagonal block at c0 (column i of U, rows c0 ..
// c0 + 31): its 32 entries of A21, from L2
__device__ __forceinline__ void grid_panel_load(const float* W, int ld, int c0, int i, float (&v)[CHOL_NB]) {
#pragma unroll
    for (int j = 0; j < CHOL_NB; ++j) v[j] = __ldcg(W + (c0 + j) * ld + i);
}

// ... solved as the one-block kernel's panel solve does: L21[i, :] = A21[i, :]
// L11^-T in registers, written back over A21. Returns L21[i, :] . yb (yb: the
// block's 32 entries of y), the forward substitution's update of y[i].
__device__ __forceinline__ float grid_panel_solve(float* W, int ld, int c0, int i, float (&v)[CHOL_NB],
                                                  const float* Lc, const float* inv, const float* yb) {
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
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CHOL_NB; ++j) {
        W[(c0 + j) * ld + i] = v[j];
        s += v[j] * lds(yb + j);
    }
    return s;
}

struct GridArgs {
    const float* S;     // (K, K) row-major, its lower triangle read
    const float* rhs;   // (K,) (SOLVE)
    float* W;           // (K, ld): U = L^T in its upper triangle
    float* y;           // (K,) the forward substitution (SOLVE)
    float* rinv;        // (K,) 1 / L[j][j] as factor_diag computes it
    float* x;           // (K,) out (SOLVE)
    unsigned* bar;      // the grid barrier's counter, 0 at launch
    unsigned long long* xtag;  // (32 ceil(K / 32),): the backward substitution's hand-off, 0 at launch (SOLVE)
    int K, ld;
};

__device__ __forceinline__ unsigned load_acquire_gpu(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Barrier of the grid's CTAs (K2's lane barrier, csrc/bini.cu): the
// __syncthreads orders the CTA's writes before thread 0's release arrival;
// thread 0 polls the counter with acquire loads until `target` CTAs have
// arrived, so what they wrote before arriving is visible to this CTA after the
// closing __syncthreads. Data written by other CTAs is read from L2 (__ldcg,
// cp.async.cg), never through L1. The cooperative launch makes every CTA
// resident (or is refused), which the barrier needs.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count), "r"(1u) : "memory");
        const long long t0 = clock64();
        while (load_acquire_gpu(count) < target)
            if (clock64() - t0 > GRID_TIMEOUT_CYCLES) __trap();
    }
    __syncthreads();
}

// Stage tile n's operands of the trailing update below the panel at c0 (rows
// c0 .. c0 + 31 of U, the trailing matrix from column r0): A = the tile's 64
// rows k, B = its 64 columns i, each op[j][c] = U[c0 + j][r0 + 64 t + c], zeros
// at or beyond K (ld's padding columns are staged as they are: they reach only
// outputs beyond K, which are not written)
__device__ __forceinline__ void grid_stage(float* buf, const float* W, int ld, int c0, int r0, int n, int K) {
    int it, kt;
    tri_tile(n, it, kt);
#pragma unroll
    for (int u = 0; u < 2 * GRID_OP / 4 / GRID_THREADS; ++u) {
        const int f = threadIdx.x + u * GRID_THREADS;  // float4 f of A, then of B
        const int op = f / (GRID_OP / 4), g = f % (GRID_OP / 4);
        const int j = g / (GRID_TILE / 4), c = 4 * (g % (GRID_TILE / 4));
        const int colm = r0 + (op ? it : kt) * GRID_TILE + c;
        const bool in = colm < K;
        cp_async<16>(buf + op * GRID_OP + j * GRID_TILE + c, in ? W + (c0 + j) * ld + colm : W, in);
    }
}

// Tile n (tri_tile: tile row it, column kt <= it) of the trailing update, all
// threads: U22[k][i] -= sum_j A[j][kl] B[j][il] for the tile's k = 64 kt + kl,
// i = 64 it + il, written where i < m and k <= i. Thread (ty, tx) owns the
// 4 x 4 outputs kl = 4 ty + r, il = 4 tx + q: per j one 16-byte load of A and
// one of B for 16 FMA. Each output's sum runs over j in order and is then
// subtracted, as syrk_tile does. c: the outputs' old values (grid_c_load). With Dn (the corner tile), the next diagonal
// block also goes to Dn[i][k] (k <= i < m, 0 elsewhere).
// The old values of tile n's outputs that thread (ty, tx) owns (rows k with
// some k <= i < m), from L2
__device__ __forceinline__ void grid_c_load(const float* W, int ld, int r0, int m, int n, float4 (&c)[4]) {
    int it, kt;
    tri_tile(n, it, kt);
    const int ty = threadIdx.x / (GRID_TILE / 4), tx = threadIdx.x % (GRID_TILE / 4);
    const int k0 = kt * GRID_TILE + 4 * ty, i0 = it * GRID_TILE + 4 * tx;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int k = k0 + r;
        c[r] = (k < m && i0 < m && k <= i0 + 3)
                   ? __ldcg(reinterpret_cast<const float4*>(W + (r0 + k) * ld + r0 + i0))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

__device__ __forceinline__ void grid_tile(const float* buf, float* W, int ld, int r0, int m, int n,
                                          const float4 (&c)[4], float (*Dn)[CHOL_NB + 1]) {
    int it, kt;
    tri_tile(n, it, kt);
    const float* A = buf;
    const float* B = buf + GRID_OP;
    const int ty = threadIdx.x / (GRID_TILE / 4), tx = threadIdx.x % (GRID_TILE / 4);
    const int k0 = kt * GRID_TILE + 4 * ty, i0 = it * GRID_TILE + 4 * tx;
    float acc[4][4] = {};
#pragma unroll
    for (int j = 0; j < CHOL_NB; ++j) {
        const float4 a4 = *reinterpret_cast<const float4*>(A + j * GRID_TILE + 4 * ty);
        const float4 b4 = *reinterpret_cast<const float4*>(B + j * GRID_TILE + 4 * tx);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] += av[r] * bv[q];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int k = k0 + r;
        const float v[4] = {c[r].x - acc[r][0], c[r].y - acc[r][1], c[r].z - acc[r][2], c[r].w - acc[r][3]};
        if (Dn && k < CHOL_NB && i0 < CHOL_NB) {
#pragma unroll
            for (int q = 0; q < 4; ++q) Dn[i0 + q][k] = k < m && i0 + q < m && k <= i0 + q ? v[q] : 0.f;
        }
        if (k >= m || i0 >= m || k > i0 + 3) continue;
        float* dst = W + (r0 + k) * ld + r0 + i0;
        if (i0 + 3 < m && k <= i0) {
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (i0 + q < m && k <= i0 + q) dst[q] = v[q];
        }
    }
}

// Warp 0 of the diagonal block's owner: the nb x nb block at c0 (D[lane][k],
// k <= lane < nb, 0 elsewhere) factored with factor_diag's arithmetic in its
// order (the pivot clamped to 1e-20, d and 1/d from one rsqrt, each entry's
// updates as FMAs over the columns in turn), then the forward substitution's
// block y[c0:c0+nb] = L11^-1 y[c0:c0+nb] (v: lane's entry of the block,
// SOLVE). L11 goes to W, 1 / L[j][j] to rinv and the block's y to y, for every
// CTA to read after the next barrier. One warp runs it once a panel on the
// critical path, so it differs from factor_diag where that saves latency: its
// own register allocation (noinline); the column broadcast through a shared
// buffer read as 16-byte loads; no lane >= k predicate on the updates (they
// change only entries above the row's diagonal, which nothing reads, and each
// predicate was one more dependent instruction: k1_probe.py); kFull (nb = 32)
// without the nb tests.
template <bool SOLVE, bool kFull>
__device__ __noinline__ void grid_factor(float* W, int ld, float* rinv, float* y, int c0, int nb, float v,
                                         const float (*D)[CHOL_NB + 1]) {
    __shared__ __align__(16) float col[2][CHOL_NB];
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    float r[CHOL_NB];
#pragma unroll
    for (int k = 0; k < CHOL_NB; ++k) r[k] = D[lane][k];
    float rd_own = 0.f;
#pragma unroll
    for (int j = 0; j < CHOL_NB; ++j) {
        if (kFull || j < nb) {
            const float xj = fmaxf(__shfl_sync(FULL, r[j], j), 1e-20f);
            const float rd = rsqrtf(xj);
            const float l = lane > j ? r[j] * rd : 0.f;
            if (lane == j) rd_own = rd;
            r[j] = lane == j ? xj * rd : lane > j ? l : r[j];
            col[j & 1][lane] = l;
            __syncwarp();
#pragma unroll
            for (int k = j + 1; k < CHOL_NB; ++k) r[k] -= l * col[j & 1][k];
        }
    }
    float* Wd = W + c0 * ld + c0;
#pragma unroll
    for (int k = 0; k < CHOL_NB; ++k)
        if (k <= lane && (kFull || lane < nb)) Wd[k * ld + lane] = r[k];
#pragma unroll
    for (int j = 0; j < CHOL_NB; ++j) {
        if (kFull || j < nb) {
            if (lane == j) v *= rd_own;
            const float yj = __shfl_sync(FULL, v, j);
            if (lane > j) v -= r[j] * yj;
        }
    }
    if (kFull || lane < nb) {
        rinv[c0 + lane] = rd_own;
        if (SOLVE) y[c0 + lane] = v;
    }
    __syncwarp();  // col is written again by the next call
}

template <bool SOLVE>
__device__ __forceinline__ void grid_factor_block(const GridArgs& a, int c0, int nb, float v,
                                                  const float (*D)[CHOL_NB + 1]) {
    if (nb == CHOL_NB)
        grid_factor<SOLVE, true>(a.W, a.ld, a.rinv, a.y, c0, nb, v, D);
    else
        grid_factor<SOLVE, false>(a.W, a.ld, a.rinv, a.y, c0, nb, v, D);
}

// Warp 0 of block q's owner (CTA q mod G): the backward substitution's block
// q of x, rows b0 = 32q .. b0 + nb - 1. Its rows' sums start at y and take
// each later block's update U[rows][32b ..] x_b as soon as block b is
// published (the 32 x 32 tile of U loaded while it waits; b from the last
// down, each row's FMAs over the tile's columns in order); then the block's
// triangle is solved as the one-block kernel solves it (one division by the
// pivot, a shuffle a column) and the block published: lane c writes x[32q + c]
// and b + 1 together in one 64-bit word, a.xtag[32q + c], so a reader's poll
// returns the value itself (no flag, then a second round trip for the data).
// Blocks are solved one after another from the last, each on the critical
// path for one update, one triangle and one hand-off through L2.
__device__ __forceinline__ void grid_backward_block(const GridArgs& a, int q, int nblk, int lane) {
    const unsigned FULL = 0xffffffffu;
    const int K = a.K, ld = a.ld, b0 = q * CHOL_NB, nb = min(CHOL_NB, K - b0);
    // the lane's row of the block's triangle and of each tile: 8 16-byte loads, zeros at or beyond K
    auto load_row = [&](int col0, float (&u)[CHOL_NB]) {
        const float* row = a.W + (b0 + lane) * ld + col0;
#pragma unroll
        for (int c4 = 0; c4 < CHOL_NB; c4 += 4) {
            const bool in = lane < nb && col0 + c4 < K;
            const float4 v = in ? __ldcg(reinterpret_cast<const float4*>(row + c4)) : make_float4(0.f, 0.f, 0.f, 0.f);
            u[c4 + 0] = col0 + c4 + 0 < K ? v.x : 0.f;
            u[c4 + 1] = col0 + c4 + 1 < K ? v.y : 0.f;
            u[c4 + 2] = col0 + c4 + 2 < K ? v.z : 0.f;
            u[c4 + 3] = col0 + c4 + 3 < K ? v.w : 0.f;
        }
    };
    float tri[CHOL_NB];
    load_row(b0, tri);
    float v = lane < nb ? __ldcg(a.y + b0 + lane) : 0.f;
    const float dinv = lane < nb ? 1.f / __ldcg(a.W + (b0 + lane) * ld + b0 + lane) : 0.f;
    for (int b = nblk - 1; b > q; --b) {
        float t[CHOL_NB];
        load_row(b * CHOL_NB, t);
        const unsigned long long* word = a.xtag + b * CHOL_NB + lane;
        unsigned long long w;
        const long long t0 = clock64();
        for (;;) {
            asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(word) : "memory");
            if ((unsigned)(w >> 32) == (unsigned)(b + 1)) break;
            if (clock64() - t0 > GRID_TIMEOUT_CYCLES) __trap();
        }
        __syncwarp();
        const float xb = __uint_as_float((unsigned)w);
#pragma unroll
        for (int c = 0; c < CHOL_NB; ++c) v -= t[c] * __shfl_sync(FULL, xb, c);
    }
#pragma unroll
    for (int j = CHOL_NB - 1; j >= 0; --j) {
        if (j < nb) {
            if (lane == j) v *= dinv;
            const float xj = __shfl_sync(FULL, v, j);
            if (lane < j) v -= tri[j] * xj;
        }
    }
    if (lane < nb) a.x[b0 + lane] = v;
    const unsigned long long w = (unsigned long long)(q + 1) << 32 | __float_as_uint(v);  // v = 0 at lanes >= nb
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(a.xtag + b0 + lane), "l"(w) : "memory");
}

// The grid route: K1's blocked algorithm (32-wide panels, the same arithmetic
// as chol_solve_kernel) in one cooperative launch of G CTAs, one a SM. Per
// panel [c0, c0 + 32), with | a grid barrier:
//   panel solve: the rows of L21 split in G contiguous ranges, a thread a row
//     (grid_panel_solve), each CTA with L11 from W                          |
//   trailing update: tile 0 (the corner, which holds the next diagonal block)
//     is CTA 0's, which leaves that block in shared memory and factors it
//     (warp 0: grid_factor); tiles 1, 2, ... go to CTAs 1 .. G - 1 in turn,
//     each CTA's next tile staged (cp.async) while the current one is
//     multiplied                                                             |
// Before the loop every warp of the grid transposes S into W (tile 0, CTA 0's
// warp 0, is then factored as the first diagonal block) |. After it the
// backward substitution runs block by block over the CTAs (grid_backward_block)
// with no grid barrier. SOLVE = false factors only (K1 many).
template <bool SOLVE>
__global__ void __launch_bounds__(GRID_THREADS, 1) chol_grid_kernel(GridArgs a) {
    extern __shared__ __align__(16) float smem[];
    float* un = smem;
    float* Lc = un + GRID_UNION;
    float* inv = Lc + SM_LC;
    float(*D)[CHOL_NB + 1] = reinterpret_cast<float(*)[CHOL_NB + 1]>(inv + SM_INV);
    float* yb = inv + SM_INV + GRID_D;
    const int K = a.K, ld = a.ld, G = gridDim.x, cta = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* W = a.W;
    unsigned target = 0;

    // ---- W = S's lower triangle transposed, 32 x 32 tiles over every warp of the grid ----
    {
        const int T = (K + 31) / 32;
        for (int n = cta * GRID_WARPS + warp; n < T * (T + 1) / 2; n += G * GRID_WARPS)
            grid_transpose_tile(a.S, W, K, ld, n, un + warp * 32 * TB_STRIDE, lane);
    }
    if (SOLVE)  // y = rhs beyond the first block, which CTA 0 solves from rhs
        for (int i = CHOL_NB + cta * GRID_THREADS + tid; i < K; i += G * GRID_THREADS) a.y[i] = a.rhs[i];
    if (cta == 0) {  // the first diagonal block: its tile was this CTA's warp 0's
        __syncthreads();
        if (warp == 0) {
            const int nb = min(CHOL_NB, K);
#pragma unroll 4
            for (int k = 0; k < CHOL_NB; ++k) D[lane][k] = (k <= lane && lane < nb) ? __ldcg(W + k * ld + lane) : 0.f;
            __syncwarp();
            grid_factor_block<SOLVE>(a, 0, nb, (SOLVE && lane < nb) ? a.rhs[lane] : 0.f, D);
        }
    }
    grid_barrier(a.bar, target += G);

    for (int c0 = 0;; c0 += CHOL_NB) {
        const int nb = min(CHOL_NB, K - c0);
        const int r0 = c0 + nb;
        const int m = K - r0;
        if (m == 0) break;  // the last panel (nb may be < 32 only here) is factored

        // ---- panel solve: rows [lo, hi) of L21, a thread a row ----
        const int R = (m + G - 1) / G, lo = r0 + cta * R, hi = min(K, lo + R);
        if (lo < hi) {
            float v[CHOL_NB];  // the first row's loads go out before L11's
            if (lo + tid < hi) grid_panel_load(W, ld, c0, lo + tid, v);
            for (int e = tid; e < SM_LC; e += GRID_THREADS) {  // Lc[j][k] = L11[k][j] = U[c0 + j][c0 + k]
                const int j = e / CHOL_NB, k = e % CHOL_NB;
                Lc[e] = k >= j ? __ldcg(W + (c0 + j) * ld + c0 + k) : 0.f;
            }
            if (tid < CHOL_NB) {
                inv[tid] = __ldcg(a.rinv + c0 + tid);
                yb[tid] = SOLVE ? __ldcg(a.y + c0 + tid) : 0.f;
            }
            __syncthreads();
            for (int i = lo + tid; i < hi; i += GRID_THREADS) {
                if (i != lo + tid) grid_panel_load(W, ld, c0, i, v);
                const float s = grid_panel_solve(W, ld, c0, i, v, Lc, inv, yb);
                if (SOLVE) a.y[i] = __ldcg(a.y + i) - s;
            }
        }
        grid_barrier(a.bar, target += G);

        // ---- trailing update: U22[k][i] -= sum_j U[c0+j][r0+k] U[c0+j][r0+i], k <= i ----
        {
            const int nt = (m + GRID_TILE - 1) / GRID_TILE, ntiles = nt * (nt + 1) / 2, nb1 = min(CHOL_NB, m);
            // the next diagonal block's y, final since the barrier, loaded ahead of the corner tile
            const float yv1 = (SOLVE && cta == 0 && warp == 0 && lane < nb1) ? __ldcg(a.y + r0 + lane) : 0.f;
            auto next = [&](int n) { return n < 0 ? cta : G == 1 ? n + 1 : cta == 0 ? ntiles : n + G - 1; };
            int n = next(-1), t = 0;
            if (n < ntiles) grid_stage(un, W, ld, c0, r0, n, K);
            cp_async_commit();
            while (n < ntiles) {
                const int nn = next(n);
                if (nn < ntiles) grid_stage(un + ((t + 1) & 1) * 2 * GRID_OP, W, ld, c0, r0, nn, K);
                cp_async_commit();
                cp_async_wait<1>();
                __syncthreads();
                float4 c[4];  // the old values, loaded before the products so that their round trip overlaps
                grid_c_load(W, ld, r0, m, n, c);
                grid_tile(un + (t & 1) * 2 * GRID_OP, W, ld, r0, m, n, c, n == 0 ? D : nullptr);
                if (n == 0) {  // the corner: factor the next diagonal block, which it left in D
                    __syncthreads();
                    if (warp == 0) grid_factor_block<SOLVE>(a, r0, nb1, yv1, D);
                }
                __syncthreads();  // the buffer just read is staged again two tiles on
                n = nn;
                ++t;
            }
        }
        grid_barrier(a.bar, target += G);
    }

    if (!SOLVE || warp != 0) return;
    const int nblk = (K + CHOL_NB - 1) / CHOL_NB;
    for (int q = nblk - 1 - (nblk - 1 - cta) % G; q >= 0 && cta < nblk; q -= G) grid_backward_block(a, q, nblk, lane);
}

// The grid route's launch: G = min(the card's SMs, the first trailing
// update's tiles) CTAs, one a SM, all resident or the launch is refused
// (cudaErrorCooperativeLaunchTooLarge): it is never retried on another route.
// The card's SM count and the kernel's shared-memory attribute and occupancy
// are looked up once a device (they are fixed), not on every launch.
template <bool SOLVE>
static cudaError_t launch_grid(GridArgs a, cudaStream_t st) {
    constexpr int kMaxDevices = 64;
    static int sms_of[kMaxDevices];  // 0: not looked up yet
    const size_t smem = GRID_FIXED * sizeof(float);
    const int nt = a.K > CHOL_NB ? (a.K - CHOL_NB + GRID_TILE - 1) / GRID_TILE : 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev < 0 || dev >= kMaxDevices)) e = cudaErrorInvalidDevice;
    if (e == cudaSuccess && sms_of[dev] == 0) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(chol_grid_kernel<SOLVE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chol_grid_kernel<SOLVE>, GRID_THREADS, smem);
        if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
        if (e == cudaSuccess) sms_of[dev] = sms;
    }
    if (e == cudaSuccess) {
        const int tiles = nt * (nt + 1) / 2, G = tiles < 1 ? 1 : tiles < sms_of[dev] ? tiles : sms_of[dev];
        void* params[] = {&a};
        e = cudaLaunchCooperativeKernel((const void*)chol_grid_kernel<SOLVE>, dim3(G), dim3(GRID_THREADS), params,
                                        smem, st);
    }
    const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
    return e != cudaSuccess ? e : last;
}

// The grid route's solve: S (K,K) row-major f32 (its lower triangle is
// read), rhs (K,), work (K ld + 2 ld floats, ld = grid_ld(K), 16-byte
// aligned: W, y, rinv), bar (2 + 64 ceil(K / 32) zeroed 32-bit words: the
// grid barrier's counter, one unused, then the backward substitution's
// 64-bit hand-off words), x (K,) out. Returns the launch's error.
extern "C" int chol_solve_grid_f32(const float* S, const float* rhs, float* work, unsigned* bar, float* x, int K,
                                   void* stream) {
    if (K < 1 || K > CHOL_MAX_K || (uintptr_t)work % 16) return (int)cudaErrorInvalidValue;
    const int ld = grid_ld(K);
    const GridArgs a{S, rhs, work, work + K * ld, work + K * ld + ld, x, bar,
                     reinterpret_cast<unsigned long long*>(bar + 2), K, ld};
    return (int)launch_grid<true>(a, (cudaStream_t)stream);
}
