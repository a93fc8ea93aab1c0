// K3: diag(H^-1) of the BiNI operator at query pixels by deflated Jacobi-PCG
// indicator solves, a fixed number of iterations per right-hand side.
//
// A kernel of the port with no TPU counterpart: the JAX package runs this
// solve as XLA ops (_diag_inverse_at_impl, mpsfm_tpu/integration/bini.py:592-664,
// a scan over chunks of 128 queries, each a scan of cg_max_iter iterations
// over (128, H, W) arrays). It computes, for each lane b and query q, the same
// algorithm (integration/bini_diag.py states it): the coarse start
// x = Z E^-1 Z^T e_q, r = e_q - H x, z = P(M^-1 r), p = z, then `iters`
// iterations of alpha, x, r, z = P(M^-1 r), beta, p, with
// P(V) = V - Z E^-1 (HZ)^T V, and returns x[q]. The set-up shared by a lane's
// queries (the edge weights ex, ey and pa of H, M^-1, HZ, E^-1, the axes of Z)
// comes from torch.
//
// Design: one block of 1024 threads per right-hand side, one launch for all
// B x Kq of them. The right-hand sides are independent, so every barrier is a
// __syncthreads and no block waits for another. The block keeps p (read at
// the neighbours by the stencil) and r of its right-hand side in shared memory
// (2 floats a pixel: 224 KB at 145 x 193, so one block per SM); thread t owns
// pixels t, t + 1024, ... The lane's maps are read from global memory (L2: the
// 8 lanes' maps of the main path are ~7 MB) by all of its blocks. Z is
// analytic (1, lin_x[col], lin_y[row]), x is kept only at q (x[q] += alpha
// p[q] is rounded as the full-array update is there), and H p is applied
// twice per iteration (for p.Hp, then for r -= alpha Hp) rather than held,
// since a third array does not fit. Per iteration three block reductions:
// p.Hp; the 3 sums (HZ)^T M^-1 r; r.z. Each reduction is a warp butterfly,
// then every thread sums the 32 warps' partials in the same order, so every
// thread holds the same value and the result is the same from run to run.
// Each product and sum of a pixel is rounded as the plain version rounds it
// (__fmul_rn, __fadd_rn, never contracted into an fma).
//
// What bounds it on the H100: per pixel-iteration the algorithm does 33 FLOP
// (this design ~46, applying H p twice) and reads ~14 map values of 4 bytes
// from L2 (shared by all of a lane's right-hand sides, so nothing of it
// needs device memory after the first read). At the main path's 8 x 2048
// right-hand sides of 145 x 193 pixels, 16 iterations, that is ~0.26 TFLOP
// (3.8 ms at the float32 peak) and ~0.4 TB of L2 reads: the L2 bandwidth and
// the load instructions bound this design, not the arithmetic. On an H100
// SXM at 700 W it takes ~64.5 ms there (chip_smoke.py).

#include <cuda_runtime.h>

#define DG_THREADS 1024
#define DG_WARPS (DG_THREADS / 32)
#define DG_RED (2 * DG_WARPS * 4)  // two reduction buffers of up to 4 sums a warp
#define DG_SMEM_BYTES 232448

__device__ __forceinline__ float guard(float v) { return fabsf(v) < 1e-30f ? 1e-30f : v; }

// f(i, row, col) for every pixel i = row W + col that thread threadIdx.x owns
template <class F>
__device__ __forceinline__ void each_pixel(int N, int W, F f) {
    const int dr = DG_THREADS / W, dc = DG_THREADS % W;
    int row = threadIdx.x / W, col = threadIdx.x % W;
    for (int i = threadIdx.x; i < N; i += DG_THREADS) {
        f(i, row, col);
        col += dc;
        row += dr;
        if (col >= W) {
            col -= W;
            ++row;
        }
    }
}

// (H v)(i) in the edge form of bini_fused.matvec, rounded as it is:
// pa v + fx(x-1) - fx + fy(y-1) - fy with fx = ex (v(x+1) - v), fy = ey (v(y+1) - v)
template <class V>
__device__ __forceinline__ float apply_h(const float* __restrict__ ex, const float* __restrict__ ey,
                                         const float* __restrict__ pa, V v, int i, int row, int col,
                                         int H, int W) {
    const float vi = v(i, row, col);
    const float fxr = __fmul_rn(ex[i], __fsub_rn(col + 1 < W ? v(i + 1, row, col + 1) : 0.f, vi));
    const float fxl = col > 0 ? __fmul_rn(ex[i - 1], __fsub_rn(vi, v(i - 1, row, col - 1))) : 0.f;
    const float fyd = __fmul_rn(ey[i], __fsub_rn(row + 1 < H ? v(i + W, row + 1, col) : 0.f, vi));
    const float fyu = row > 0 ? __fmul_rn(ey[i - W], __fsub_rn(vi, v(i - W, row - 1, col))) : 0.f;
    return __fsub_rn(__fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(pa[i], vi), fxl), fxr), fyu), fyd);
}

// Sums of v[0..M) over the block, the same value in every thread; the two
// buffers alternate (par), so one barrier per reduction is enough: between
// two uses of a buffer lies the other reduction's barrier.
template <int M>
__device__ __forceinline__ void block_sum(float (&v)[M], float* red, int& par) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) v[m] += __shfl_xor_sync(FULL, v[m], o);
    float* buf = red + par * DG_WARPS * 4;
    if (lane == 0) {
#pragma unroll
        for (int m = 0; m < M; ++m) buf[warp * 4 + m] = v[m];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) {
        float s = 0.f;
#pragma unroll 8
        for (int w = 0; w < DG_WARPS; ++w) s += buf[w * 4 + m];
        v[m] = s;
    }
    par ^= 1;
}

__global__ void __launch_bounds__(DG_THREADS, 1)
bini_diag_kernel(const float* __restrict__ ex_all, const float* __restrict__ ey_all,
                 const float* __restrict__ pa_all, const float* __restrict__ minv_all,
                 const float* __restrict__ hz_all, const float* __restrict__ einv_all,
                 const float* __restrict__ lin_x, const float* __restrict__ lin_y,
                 const int* __restrict__ rows, const int* __restrict__ cols, float* __restrict__ out,
                 int iters, int H, int W, int Kq) {
    extern __shared__ __align__(16) float smem[];
    const int N = H * W;
    float* p = smem;
    float* r = smem + N;
    float* red = smem + 2 * N;
    const int b = blockIdx.x / Kq;
    const size_t off = (size_t)b * N;
    const float *ex = ex_all + off, *ey = ey_all + off, *pa = pa_all + off, *minv = minv_all + off;
    const float *hz0 = hz_all + 3 * off, *hz1 = hz0 + N, *hz2 = hz1 + N;
    float E[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) E[k] = einv_all[b * 9 + k];
    const int qr = rows[blockIdx.x], qc = cols[blockIdx.x];
    const int q = qr * W + qc;
    int par = 0;

    // coarse start: coef = (Z^T e_q) E^-1, x0 = coef . Z, r = e_q - H x0
    const float zq[3] = {1.f, lin_x[qc], lin_y[qr]};
    float coef[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
        coef[m] = __fadd_rn(__fadd_rn(__fmul_rn(zq[0], E[m]), __fmul_rn(zq[1], E[3 + m])), __fmul_rn(zq[2], E[6 + m]));
    auto zdot = [&](const float (&c)[3], int row, int col) {  // c . Z at (row, col)
        return __fadd_rn(__fadd_rn(c[0], __fmul_rn(c[1], lin_x[col])), __fmul_rn(c[2], lin_y[row]));
    };
    auto x0 = [&](int, int row, int col) { return zdot(coef, row, col); };
    float xq = zdot(coef, qr, qc);
    float g[3] = {0.f, 0.f, 0.f};
    each_pixel(N, W, [&](int i, int row, int col) {
        const float ri = __fsub_rn(i == q ? 1.f : 0.f, apply_h(ex, ey, pa, x0, i, row, col, H, W));
        r[i] = ri;
        const float v = __fmul_rn(minv[i], ri);
        g[0] = __fadd_rn(g[0], __fmul_rn(hz0[i], v));
        g[1] = __fadd_rn(g[1], __fmul_rn(hz1[i], v));
        g[2] = __fadd_rn(g[2], __fmul_rn(hz2[i], v));
    });
    block_sum(g, red, par);

    // z = P(M^-1 r) with c = g E^-1; rz = r.z; p = z
    float c[3];
    auto proj_coef = [&]() {
#pragma unroll
        for (int m = 0; m < 3; ++m)
            c[m] = __fadd_rn(__fadd_rn(__fmul_rn(g[0], E[m]), __fmul_rn(g[1], E[3 + m])), __fmul_rn(g[2], E[6 + m]));
    };
    auto zval = [&](int i, int row, int col) { return __fsub_rn(__fmul_rn(minv[i], r[i]), zdot(c, row, col)); };
    proj_coef();
    float s[1] = {0.f};
    each_pixel(N, W, [&](int i, int row, int col) {
        const float zi = zval(i, row, col);
        p[i] = zi;
        s[0] = __fadd_rn(s[0], __fmul_rn(r[i], zi));
    });
    block_sum(s, red, par);  // its barrier also publishes p
    float rz = s[0];

    auto pv = [&](int i, int, int) { return p[i]; };
    for (int it = 0; it < iters; ++it) {
        // alpha = rz / p.Hp; x[q] += alpha p[q]
        s[0] = 0.f;
        each_pixel(N, W, [&](int i, int row, int col) {
            s[0] = __fadd_rn(s[0], __fmul_rn(p[i], apply_h(ex, ey, pa, pv, i, row, col, H, W)));
        });
        block_sum(s, red, par);
        const float alpha = rz / guard(s[0]);
        xq = __fadd_rn(xq, __fmul_rn(alpha, p[q]));

        // r -= alpha Hp; g = (HZ)^T M^-1 r
        g[0] = g[1] = g[2] = 0.f;
        each_pixel(N, W, [&](int i, int row, int col) {
            const float ri = __fsub_rn(r[i], __fmul_rn(alpha, apply_h(ex, ey, pa, pv, i, row, col, H, W)));
            r[i] = ri;
            const float v = __fmul_rn(minv[i], ri);
            g[0] = __fadd_rn(g[0], __fmul_rn(hz0[i], v));
            g[1] = __fadd_rn(g[1], __fmul_rn(hz1[i], v));
            g[2] = __fadd_rn(g[2], __fmul_rn(hz2[i], v));
        });
        block_sum(g, red, par);
        proj_coef();

        // rz_new = r.z; beta; p = z + beta p
        s[0] = 0.f;
        each_pixel(N, W, [&](int i, int row, int col) { s[0] = __fadd_rn(s[0], __fmul_rn(r[i], zval(i, row, col))); });
        block_sum(s, red, par);
        const float beta = s[0] / guard(rz);
        rz = s[0];
        each_pixel(N, W, [&](int i, int row, int col) {
            p[i] = __fadd_rn(zval(i, row, col), __fmul_rn(beta, p[i]));
        });
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = xq;
}

// ex, ey, pa, minv (B,H,W); hz (B,3,H,W); einv (B,3,3); lin_x (W,); lin_y (H,);
// rows, cols (B,Kq) int32 query pixels; out (B,Kq). One launch of B Kq blocks.
// Returns cudaGetLastError() after the launch.
extern "C" int bini_diag_pcg(const float* ex, const float* ey, const float* pa, const float* minv,
                             const float* hz, const float* einv, const float* lin_x, const float* lin_y,
                             const int* rows, const int* cols, float* out, int iters, int B, int H, int W,
                             int Kq, void* stream) {
    const size_t smem = (2 * (size_t)H * W + DG_RED) * sizeof(float);
    if (B < 1 || Kq < 1 || H < 1 || W < 1 || iters < 0 || smem > DG_SMEM_BYTES) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(bini_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DG_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    bini_diag_kernel<<<B * Kq, DG_THREADS, smem, (cudaStream_t)stream>>>(ex, ey, pa, minv, hz, einv, lin_x, lin_y,
                                                                          rows, cols, out, iters, H, W, Kq);
    return (int)cudaGetLastError();
}
