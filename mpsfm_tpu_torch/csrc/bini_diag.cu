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
// Design: one thread-block cluster of C CTAs (C = 1, 2, 4 or 8, set at launch)
// per lane and group of R right-hand sides (R = 1..8, a template parameter),
// one launch for all of them. The grid's rows are cut into C bands of
// bh = ceil(H / C) rows; CTA c keeps p and r of its band for all R right-hand
// sides in its shared memory (2 R bh W floats), and the stencil reads the row
// above or below its band from the neighbouring CTA's p through distributed
// shared memory (no halo copy, so nothing can go stale). Each pass reads a
// pixel's map values (ex, ey, pa, M^-1, HZ and ex/ey at the left/up
// neighbours) once from global memory and applies them to the R right-hand
// sides from registers. Z is analytic (1, lin_x[col], lin_y[row]); x is kept
// only at q, by thread 0 of the CTA whose band holds q (x[q] += alpha p[q] is
// rounded as the full-array update is); H p is applied twice per iteration
// (for p.Hp, then for r -= alpha Hp) rather than held in a third array. Per
// iteration three R-wide reductions (p.Hp; the 3 sums (HZ)^T M^-1 r; r.z):
// warp butterflies, the warps' partials summed in one order, then, after a
// cluster barrier, the C CTAs' partials read over distributed shared memory in
// rank order 0..C-1 by every CTA, so every thread of the cluster holds the
// same value and runs are bit-identical. The end of an iteration is a cluster
// barrier too, since neighbours read p. Each product and sum of a pixel is
// rounded as the plain version rounds it (__fmul_rn, __fadd_rn, never
// contracted into an fma). integration/bini_diag.plan picks C and R from
// (H, W).
//
// Global mode (template switch kGmem), for a grid whose band does not fit a
// CTA's shared memory at C = 8, R = 1 (ceil(H/8) W > 29 002 pixels): p and r
// of a band live in a global workspace the wrapper allocates, CTA slice
// ws + blockIdx.x 2 R bh W, and the halo rows are read from the neighbouring
// CTAs' slices through plain global pointers. Every pass, sum and rounding is
// the shared-memory mode's, so at the same (C, R) the two modes give
// bit-identical variances. The halo reads rely on the cluster barriers alone:
// cluster.sync() is barrier.cluster.arrive (.release by default) and
// barrier.cluster.wait (.acquire by default), a release-acquire pattern at
// cluster scope that orders the CTAs' global stores as it orders their
// shared ones (PTX ISA, barrier.cluster), so no fence is added. The launch
// holds at most as many clusters as the card runs at once, each looping over
// groups (cid += clusters); the end-of-group cluster barrier keeps a group's
// first writes of a slice after every neighbour's last read of it. The
// workspace is then clusters C 2 R bh W floats (~15 MB a cluster at 400 x 600,
// R = 8). The shared-memory mode launches one cluster a group.
//
// What bounds it on the H100: per pixel-iteration the algorithm does 33 FLOP
// (this design ~46, applying H p twice). At the main path's 8 x 2048
// right-hand sides of 145 x 193 pixels, 16 iterations, that is ~0.26 TFLOP
// (3.8 ms at the float32 peak, the bound chip_smoke.py reports). A pass reads
// 12 distinct map values a pixel-iteration (48 B) from L2 once per group of
// R right-hand sides: 53.5 GB over the call at the main path's C = 8, R = 7,
// where one block per right-hand side (the design before the clusters) read
// ~0.37 TB. On an H100 SXM at 700 W it takes ~59 ms there (chip_smoke.py),
// ~52 ms with the map reads replaced by constants: what bounds it is
// instruction issue and latency inside the SM. One CTA of 16 warps fills an
// SM's shared memory (208 KB), a thread holds the group's sums in 128
// registers, a pixel-iteration costs ~830 instructions at R = 7 (~370 of
// them float32 arithmetic, ~100 shared loads and stores), and an iteration
// adds four cluster barriers and ~175 shuffles a thread. All loads of a
// pixel's p and r are issued before its stores: the compiler cannot tell
// p[k] from r[k + 1], and would otherwise chain the R right-hand sides.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define DG_THREADS 512
#define DG_WARPS (DG_THREADS / 32)
#define DG_RMAX 8
#define DG_CMAX 8
#define DG_SMEM_BYTES 232448
// floats of the reduction buffers at R right-hand sides: two parities of
// (DG_WARPS warp partials, the CTA's partial, the cluster's sum), 3 R sums each
#define DG_RED_FLOATS(R) (2 * (DG_WARPS + 2) * 3 * (R))

__device__ __forceinline__ float guard(float v) { return fabsf(v) < 1e-30f ? 1e-30f : v; }

// c . Z at (row, col), rounded as the plain version's projection is
__device__ __forceinline__ float zdot(const float* c, float lx, float ly) {
    return __fadd_rn(__fadd_rn(c[0], __fmul_rn(c[1], lx)), __fmul_rn(c[2], ly));
}

// (H v)(i) in the edge form of bini_fused.matvec, rounded as it is:
// pa v + fx(x-1) - fx + fy(y-1) - fy with fx = ex (v(x+1) - v), fy = ey (v(y+1) - v).
// vr, vd are 0 beyond the border; has_l / has_u say whether the left / upper
// edge exists.
__device__ __forceinline__ float stencil(float pa, float exr, float exl, float eyd, float eyu, float vi, float vr,
                                         float vl, float vd, float vu, bool has_l, bool has_u) {
    const float fxr = __fmul_rn(exr, __fsub_rn(vr, vi));
    const float fxl = has_l ? __fmul_rn(exl, __fsub_rn(vi, vl)) : 0.f;
    const float fyd = __fmul_rn(eyd, __fsub_rn(vd, vi));
    const float fyu = has_u ? __fmul_rn(eyu, __fsub_rn(vi, vu)) : 0.f;
    return __fsub_rn(__fadd_rn(__fsub_rn(__fadd_rn(__fmul_rn(pa, vi), fxl), fxr), fyu), fyd);
}

// f(j, lr, col) for every pixel j = lr W + col of the band (lr: row in the
// band) that thread threadIdx.x owns
template <class F>
__device__ __forceinline__ void each_pixel(int nb, int W, F f) {
    const int dr = DG_THREADS / W, dc = DG_THREADS % W;
    int lr = threadIdx.x / W, col = threadIdx.x % W;
    for (int j = threadIdx.x; j < nb; j += DG_THREADS) {
        f(j, lr, col);
        col += dc;
        lr += dr;
        if (col >= W) {
            col -= W;
            ++lr;
        }
    }
}

// Sums of v[0..M) over the cluster, the same value in every thread of it.
// red holds two parities of [DG_WARPS + 2][S] floats: the warps' partials, the
// CTA's partial (read by the other CTAs) and the cluster's sum. A buffer is
// used again only two reductions later, after the other parity's barriers.
template <int S, int M>
__device__ __forceinline__ void cluster_sum(float (&v)[M], float* red, int& par, cg::cluster_group& cluster,
                                            int C) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) v[m] += __shfl_xor_sync(FULL, v[m], o);
    float* buf = red + par * (DG_WARPS + 2) * S;
    if (lane == 0) {
#pragma unroll
        for (int m = 0; m < M; ++m) buf[warp * S + m] = v[m];
    }
    __syncthreads();
    if (threadIdx.x < M) {
        float s = 0.f;
#pragma unroll 8
        for (int w = 0; w < DG_WARPS; ++w) s += buf[w * S + threadIdx.x];
        buf[DG_WARPS * S + threadIdx.x] = s;
    }
    cluster.sync();  // the CTAs' partials are published
    if (threadIdx.x < M) {
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += cluster.map_shared_rank(buf, c)[DG_WARPS * S + threadIdx.x];
        buf[(DG_WARPS + 1) * S + threadIdx.x] = s;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = buf[(DG_WARPS + 1) * S + m];
    par ^= 1;
}

// c[k] = g[k] E^-1 for each right-hand side k
template <int R>
__device__ __forceinline__ void proj_coef(const float (&g)[3 * R], const float (&E)[9], float (&c)[3 * R]) {
#pragma unroll
    for (int k = 0; k < R; ++k)
#pragma unroll
        for (int m = 0; m < 3; ++m)
            c[3 * k + m] = __fadd_rn(__fadd_rn(__fmul_rn(g[3 * k], E[m]), __fmul_rn(g[3 * k + 1], E[3 + m])),
                                     __fmul_rn(g[3 * k + 2], E[6 + m]));
}

// One group of R right-hand sides (cluster id cid: lane b, group of R queries)
// on this CTA's band: p and r [R][bh W] each, p_up / p_dn the first pixel of
// the neighbouring bands' halo rows (their last / first row of p).
template <int R>
__device__ __forceinline__ void solve_group(const float* __restrict__ ex_all, const float* __restrict__ ey_all,
                                            const float* __restrict__ pa_all, const float* __restrict__ minv_all,
                                            const float* __restrict__ hz_all, const float* __restrict__ einv_all,
                                            const float* __restrict__ lin_x, const float* __restrict__ lin_y,
                                            const int* __restrict__ rows, const int* __restrict__ cols,
                                            float* __restrict__ out, int iters, int H, int W, int Kq, int bh,
                                            cg::cluster_group& cluster, int C, int rank, int cid, float* p, float* r,
                                            const float* p_up, const float* p_dn, float* red) {
    const int groups = Kq / R;
    const int b = cid / groups;
    const int q0 = b * Kq + (cid - b * groups) * R;
    const int N = H * W, NB = bh * W;
    const int r0 = min(rank * bh, H), nr = min(bh, H - r0), nb = nr * W;

    const size_t off = (size_t)b * N;
    const int base = r0 * W;  // global index of the band's first pixel
    const float *ex = ex_all + off + base, *ey = ey_all + off + base, *pa = pa_all + off + base;
    const float *minv = minv_all + off + base, *hz0 = hz_all + 3 * off + base, *hz1 = hz0 + N, *hz2 = hz1 + N;
    float E[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) E[k] = einv_all[b * 9 + k];
    int par = 0;

    // coarse start: coef = (Z^T e_q) E^-1, x0 = coef . Z, r = e_q - H x0
    float coef[3 * R], xq[R];
    int qloc[R], qband[R];  // q's index in this band (-1: another band's), q's index in the band's frame
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const int qr = rows[q0 + k], qc = cols[q0 + k];
        const float zq[3] = {1.f, lin_x[qc], lin_y[qr]};
#pragma unroll
        for (int m = 0; m < 3; ++m)
            coef[3 * k + m] =
                __fadd_rn(__fadd_rn(__fmul_rn(zq[0], E[m]), __fmul_rn(zq[1], E[3 + m])), __fmul_rn(zq[2], E[6 + m]));
        xq[k] = zdot(&coef[3 * k], lin_x[qc], lin_y[qr]);
        qband[k] = (qr - r0) * W + qc;
        qloc[k] = qr >= r0 && qr < r0 + nr ? qband[k] : -1;
    }
    float g[3 * R];
#pragma unroll
    for (int m = 0; m < 3 * R; ++m) g[m] = 0.f;
    each_pixel(nb, W, [&](int j, int lr, int col) {
        const int row = r0 + lr;
        const bool has_l = col > 0, has_u = row > 0, has_r = col + 1 < W, has_d = row + 1 < H;
        const float exr = ex[j], exl = has_l ? ex[j - 1] : 0.f, eyd = ey[j], eyu = has_u ? ey[j - W] : 0.f;
        const float pai = pa[j], mi = minv[j], h0 = hz0[j], h1 = hz1[j], h2 = hz2[j];
        const float lx = lin_x[col], ly = lin_y[row];
        const float lxr = has_r ? lin_x[col + 1] : 0.f, lxl = has_l ? lin_x[col - 1] : 0.f;
        const float lyd = has_d ? lin_y[row + 1] : 0.f, lyu = has_u ? lin_y[row - 1] : 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const float* ck = &coef[3 * k];
            const float vi = zdot(ck, lx, ly);
            const float hx = stencil(pai, exr, exl, eyd, eyu, vi, has_r ? zdot(ck, lxr, ly) : 0.f,
                                     zdot(ck, lxl, ly), has_d ? zdot(ck, lx, lyd) : 0.f, zdot(ck, lx, lyu), has_l,
                                     has_u);
            const float ri = __fsub_rn(j == qband[k] ? 1.f : 0.f, hx);
            r[k * NB + j] = ri;
            const float v = __fmul_rn(mi, ri);
            g[3 * k] = __fadd_rn(g[3 * k], __fmul_rn(h0, v));
            g[3 * k + 1] = __fadd_rn(g[3 * k + 1], __fmul_rn(h1, v));
            g[3 * k + 2] = __fadd_rn(g[3 * k + 2], __fmul_rn(h2, v));
        }
    });
    cluster_sum<3 * R>(g, red, par, cluster, C);

    // z = P(M^-1 r) with c = g E^-1; rz = r.z; p = z
    float c[3 * R], s[R], rz[R];
    proj_coef<R>(g, E, c);
#pragma unroll
    for (int k = 0; k < R; ++k) s[k] = 0.f;
    each_pixel(nb, W, [&](int j, int lr, int col) {
        const float mi = minv[j], lx = lin_x[col], ly = lin_y[r0 + lr];
        float rv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) rv[k] = r[k * NB + j];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const float zi = __fsub_rn(__fmul_rn(mi, rv[k]), zdot(&c[3 * k], lx, ly));
            p[k * NB + j] = zi;
            s[k] = __fadd_rn(s[k], __fmul_rn(rv[k], zi));
        }
    });
    cluster_sum<3 * R>(s, red, par, cluster, C);  // its cluster barrier also publishes p
#pragma unroll
    for (int k = 0; k < R; ++k) rz[k] = s[k];

    // (H p)_k at band pixel j for the R right-hand sides, from one read of the maps
    auto hp_all = [&](int j, int lr, int col, float (&hp)[R], float (&pv)[R]) {
        const int row = r0 + lr;
        const bool has_l = col > 0, has_u = row > 0, has_r = col + 1 < W, has_d = row + 1 < H;
        const float exr = ex[j], exl = has_l ? ex[j - 1] : 0.f, eyd = ey[j], eyu = has_u ? ey[j - W] : 0.f;
        const float pai = pa[j];
        const float* up = lr > 0 ? p + j - W : p_up + col;      // read only where has_u
        const float* dn = lr + 1 < nr ? p + j + W : p_dn + col;  // read only where has_d
#pragma unroll
        for (int k = 0; k < R; ++k) {
            const float* pk = p + k * NB + j;
            const float vi = pk[0];
            pv[k] = vi;
            hp[k] = stencil(pai, exr, exl, eyd, eyu, vi, has_r ? pk[1] : 0.f, has_l ? pk[-1] : 0.f,
                            has_d ? dn[k * NB] : 0.f, has_u ? up[k * NB] : 0.f, has_l, has_u);
        }
    };

    for (int it = 0; it < iters; ++it) {
        // alpha = rz / p.Hp; x[q] += alpha p[q]
#pragma unroll
        for (int k = 0; k < R; ++k) s[k] = 0.f;
        each_pixel(nb, W, [&](int j, int lr, int col) {
            float hp[R], pv[R];
            hp_all(j, lr, col, hp, pv);
#pragma unroll
            for (int k = 0; k < R; ++k) s[k] = __fadd_rn(s[k], __fmul_rn(pv[k], hp[k]));
        });
        cluster_sum<3 * R>(s, red, par, cluster, C);
        float alpha[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            alpha[k] = rz[k] / guard(s[k]);
            if (threadIdx.x == 0 && qloc[k] >= 0) xq[k] = __fadd_rn(xq[k], __fmul_rn(alpha[k], p[k * NB + qloc[k]]));
        }

        // r -= alpha Hp; g = (HZ)^T M^-1 r
#pragma unroll
        for (int m = 0; m < 3 * R; ++m) g[m] = 0.f;
        each_pixel(nb, W, [&](int j, int lr, int col) {
            float hp[R], pv[R];
            hp_all(j, lr, col, hp, pv);
            const float mi = minv[j], h0 = hz0[j], h1 = hz1[j], h2 = hz2[j];
            float rv[R];
#pragma unroll
            for (int k = 0; k < R; ++k) rv[k] = r[k * NB + j];
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const float ri = __fsub_rn(rv[k], __fmul_rn(alpha[k], hp[k]));
                r[k * NB + j] = ri;
                const float v = __fmul_rn(mi, ri);
                g[3 * k] = __fadd_rn(g[3 * k], __fmul_rn(h0, v));
                g[3 * k + 1] = __fadd_rn(g[3 * k + 1], __fmul_rn(h1, v));
                g[3 * k + 2] = __fadd_rn(g[3 * k + 2], __fmul_rn(h2, v));
            }
        });
        cluster_sum<3 * R>(g, red, par, cluster, C);
        proj_coef<R>(g, E, c);

        // rz_new = r.z; beta; p = z + beta p
#pragma unroll
        for (int k = 0; k < R; ++k) s[k] = 0.f;
        each_pixel(nb, W, [&](int j, int lr, int col) {
            const float mi = minv[j], lx = lin_x[col], ly = lin_y[r0 + lr];
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const float ri = r[k * NB + j];
                s[k] = __fadd_rn(s[k], __fmul_rn(ri, __fsub_rn(__fmul_rn(mi, ri), zdot(&c[3 * k], lx, ly))));
            }
        });
        cluster_sum<3 * R>(s, red, par, cluster, C);
        float beta[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            beta[k] = s[k] / guard(rz[k]);
            rz[k] = s[k];
        }
        each_pixel(nb, W, [&](int j, int lr, int col) {
            const float mi = minv[j], lx = lin_x[col], ly = lin_y[r0 + lr];
            float rv[R], pv[R];
#pragma unroll
            for (int k = 0; k < R; ++k) {
                rv[k] = r[k * NB + j];
                pv[k] = p[k * NB + j];
            }
#pragma unroll
            for (int k = 0; k < R; ++k)
                p[k * NB + j] = __fadd_rn(__fsub_rn(__fmul_rn(mi, rv[k]), zdot(&c[3 * k], lx, ly)), __fmul_rn(beta[k], pv[k]));
        });
        cluster.sync();  // p is read across the band edges
    }
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < R; ++k)
            if (qloc[k] >= 0) out[q0 + k] = xq[k];
    }
    cluster.sync();  // no CTA leaves, or starts its next group, while another may still read its p
}

// groups = B Kq / R clusters' worth of work. Shared-memory mode: one cluster a
// group, p and r in the CTA's shared memory, halos over DSMEM. Global mode:
// gridDim.x / C clusters, each looping over groups, p and r in the CTA's
// slice of ws.
template <int R, bool kGmem>
__global__ void __launch_bounds__(DG_THREADS, 1)
bini_diag_kernel(const float* __restrict__ ex_all, const float* __restrict__ ey_all,
                 const float* __restrict__ pa_all, const float* __restrict__ minv_all,
                 const float* __restrict__ hz_all, const float* __restrict__ einv_all,
                 const float* __restrict__ lin_x, const float* __restrict__ lin_y,
                 const int* __restrict__ rows, const int* __restrict__ cols, float* __restrict__ out, float* ws,
                 int iters, int H, int W, int Kq, int bh, int groups) {
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int NB = bh * W;
    extern __shared__ __align__(16) float smem[];
    if constexpr (kGmem) {
        const size_t slice = 2 * (size_t)R * NB;
        float* p = ws + blockIdx.x * slice;  // [R][NB]: the slice of CTA rank of cluster blockIdx.x / C
        const float* p_up = rank > 0 ? p - slice + (bh - 1) * W : nullptr;  // its last row
        const float* p_dn = rank + 1 < C ? p + slice : nullptr;             // its first row
        for (int cid = blockIdx.x / C; cid < groups; cid += gridDim.x / C)
            solve_group<R>(ex_all, ey_all, pa_all, minv_all, hz_all, einv_all, lin_x, lin_y, rows, cols, out, iters, H,
                           W, Kq, bh, cluster, C, rank, cid, p, p + R * NB, p_up, p_dn, smem);
    } else {
        float* p = smem;  // [R][NB], then r [R][NB], then the reduction buffers
        const float* p_up = rank > 0 ? cluster.map_shared_rank(p, rank - 1) + (bh - 1) * W : nullptr;
        const float* p_dn = rank + 1 < C ? cluster.map_shared_rank(p, rank + 1) : nullptr;
        solve_group<R>(ex_all, ey_all, pa_all, minv_all, hz_all, einv_all, lin_x, lin_y, rows, cols, out, iters, H, W,
                       Kq, bh, cluster, C, rank, blockIdx.x / C, p, p + R * NB, p_up, p_dn, p + 2 * R * NB);
    }
}

static size_t smem_bytes(int H, int W, int C, int R, bool gmem) {
    const size_t bh = (H + C - 1) / C;
    return ((gmem ? 0 : 2 * (size_t)R * bh * W) + DG_RED_FLOATS(R)) * sizeof(float);
}

// slots: the clusters launched (global mode; the shared-memory mode launches
// one a group)
template <int R, bool kGmem>
static cudaError_t launch(const float* ex, const float* ey, const float* pa, const float* minv, const float* hz,
                          const float* einv, const float* lin_x, const float* lin_y, const int* rows, const int* cols,
                          float* out, float* ws, int iters, int B, int H, int W, int Kq, int C, int slots,
                          cudaStream_t stream, int* active) {
    const size_t smem = smem_bytes(H, W, C, R, kGmem);
    const int bh = (H + C - 1) / C, groups = B * (Kq / R);
    auto kernel = bini_diag_kernel<R, kGmem>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((kGmem ? slots : groups) * C));
    cfg.blockDim = dim3(DG_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (out == nullptr) return cudaSuccess;  // the occupancy query alone
    if (*active < 1) return cudaErrorLaunchOutOfResources;
    if (kGmem && (ws == nullptr || slots < 1 || slots > groups)) return cudaErrorInvalidValue;
    err = cudaLaunchKernelEx(&cfg, kernel, ex, ey, pa, minv, hz, einv, lin_x, lin_y, rows, cols, out, ws, iters, H, W,
                             Kq, bh, groups);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

static cudaError_t dispatch(const float* ex, const float* ey, const float* pa, const float* minv, const float* hz,
                            const float* einv, const float* lin_x, const float* lin_y, const int* rows,
                            const int* cols, float* out, float* ws, int iters, int B, int H, int W, int Kq, int C,
                            int R, int gmem, int slots, cudaStream_t stream, int* active) {
    if (B < 1 || H < 1 || W < 1 || iters < 0 || R < 1 || R > DG_RMAX || C < 1 || C > DG_CMAX || (C & (C - 1)) ||
        Kq < R || Kq % R || smem_bytes(H, W, C, R, gmem) > DG_SMEM_BYTES)
        return cudaErrorInvalidValue;
#define DG_CASE(RR)                                                                                                \
    case RR:                                                                                                       \
        return gmem ? launch<RR, true>(ex, ey, pa, minv, hz, einv, lin_x, lin_y, rows, cols, out, ws, iters, B, H, W, \
                                       Kq, C, slots, stream, active)                                                \
                    : launch<RR, false>(ex, ey, pa, minv, hz, einv, lin_x, lin_y, rows, cols, out, ws, iters, B, H, \
                                        W, Kq, C, slots, stream, active);
    switch (R) {
        DG_CASE(1)
        DG_CASE(2)
        DG_CASE(3)
        DG_CASE(4)
        DG_CASE(5)
        DG_CASE(6)
        DG_CASE(7)
        DG_CASE(8)
    }
#undef DG_CASE
    return cudaErrorInvalidValue;
}

// ex, ey, pa, minv (B,H,W); hz (B,3,H,W); einv (B,3,3); lin_x (W,); lin_y (H,);
// rows, cols (B,Kq) int32 query pixels, Kq a multiple of R; out (B,Kq). gmem 0:
// one launch of B Kq / R clusters of C CTAs, ws unused. gmem 1: one launch of
// `slots` clusters (1 <= slots <= B Kq / R), ws holding slots C 2 R bh W
// floats. Returns cudaGetLastError() after the launch, or
// cudaErrorLaunchOutOfResources where not one cluster fits the card.
extern "C" int bini_diag_pcg(const float* ex, const float* ey, const float* pa, const float* minv,
                             const float* hz, const float* einv, const float* lin_x, const float* lin_y,
                             const int* rows, const int* cols, float* out, float* ws, int iters, int B, int H, int W,
                             int Kq, int C, int R, int gmem, int slots, void* stream) {
    int active = 0;
    if (out == nullptr) return (int)cudaErrorInvalidValue;
    return (int)dispatch(ex, ey, pa, minv, hz, einv, lin_x, lin_y, rows, cols, out, ws, iters, B, H, W, Kq, C, R,
                         gmem, slots, (cudaStream_t)stream, &active);
}

// How many clusters of C CTAs at R right-hand sides, in the mode gmem, the
// current card holds at once for an H x W grid
// (cudaOccupancyMaxActiveClusters), in *active.
extern "C" int bini_diag_active_clusters(int H, int W, int C, int R, int gmem, int* active) {
    return (int)dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         nullptr, nullptr, 0, 1, H, W, R, C, R, gmem, 1, nullptr, active);
}
