// K2: BiNI log-depth solve — IRLS stencil setup and the Jacobi-PCG core,
// batched over a bundle's B images.
//
// Replaces the TPU kernel _bini_kernel (mpsfm_tpu/integration/bini_pallas.py:83,
// pallas_call at :217). That kernel keeps every map of one image in VMEM and
// runs the whole IRLS + PCG of that image inside one launch.
//
// Entry points (plain C, bound with ctypes):
//   bini_setup         one IRLS round's operator from z: bilateral weights
//                      sigma(k (D-z^2 - D+z^2)), the edge weights ex/ey of the
//                      4-direction stencil, the rhs b and the Jacobi diagonal;
//   bini_pcg_capacity  how many CTAs of the PCG kernel a card holds at once,
//                      and the kernel's layout constants;
//   bini_pcg           one whole Jacobi-PCG solve of a group of lanes in ONE
//                      cooperative launch (pcg_kernel).
// The fixed-budget solve (bini_solve_pallas semantics) chains setup + pcg per
// IRLS round with tol < 0; the main path's IRLS (_bini_solve_impl) builds its
// operator in torch and runs only the PCG, with a relative tolerance
// ||r|| > tol (||b|| + 1e-30) tested before each iteration and a per-lane
// active flag. A lane that stops keeps its x, as a vmapped while_loop freezes
// a finished lane's carry; an inactive lane is returned untouched.
//
// The stencil is written in edge form: the masked one-sided differences of
// the reference, D+^T(a+ D+ v) + D-^T(a- D- v), collapse to one weight per
// edge (y,x)-(y,x+1): ex = a+(y,x) + a-(y,x+1), so that
// (A v)(i) = pa v(i) + sum over the 4 edges of i of e (v(i) - v(j)).
// ex is 0 on the last column and ey on the last row, so the same formula
// holds on the border with no test.
//
// The persistent PCG. Each lane (image) gets cpl CTAs of PCG_THREADS threads,
// and CTA j of a lane owns the pixels [j chunk, (j+1) chunk), chunk =
// PCG_THREADS * ppt: thread t owns pixels j chunk + k PCG_THREADS + t, k < ppt
// (ppt <= PPT_CAP). For the whole solve a thread keeps r, p and Ap of its
// pixels in registers, and the CTA keeps ex, ey (with their halo), pa, M^-1
// and x of its pixels in shared memory (x there, not in registers: at the
// 128-register cap of 512 threads a fourth register array spilled). Per
// iteration, with `|` a barrier of the lane's CTAs:
//   phase M: beta and the stop test from the lane's rz, rr partials;
//            p = z + beta p_old on the CTA's pixels (registers) and on its
//            halo of W pixels each side (z and p_old read back from L2, so a
//            neighbour's p is recomputed, not waited for); Ap; partial p.Ap  |
//   phase U: alpha from the p.Ap partials; x += alpha p, r -= alpha Ap,
//            z = M^-1 r; partials of r.z and r.r                            |
// Only the first and last W pixels of a CTA are ever read by another CTA, so
// only they are written to global memory (z in phase U, p in phase M; p into
// the buffer of parity it & 1, so that a neighbour's read of p_old never races
// its owner's write of p_new). z is recomputed as M^-1 r and p by p_next
// everywhere, so a neighbour's copy is bit-identical to the owner's. Every
// product and sum of a pixel is rounded as the plain version rounds it
// (__fmul_rn, __fadd_rn: never contracted into an fma), so the kernel differs
// from it only in the order of the dot products' sums.
// Reductions are atomic-free and fixed-order: each CTA writes its partial, and
// after the barrier every warp of every CTA of the lane sums that lane's
// partials in the same order, so they all take the same stop decision and x
// is the same from run to run. Lanes are independent: the barrier is per lane
// (a counter per lane in global memory), and a lane that stops leaves the
// kernel while the others go on. The cooperative launch guarantees that every
// CTA is resident (or refuses the launch), which the barrier needs;
// grid.sync() is not used. Lanes that do not fit the card's co-resident CTAs
// at PPT_CAP pixels per thread are launched as several groups by the wrapper
// (bini_fused.py).
//
// What bounds it on the H100: the work is 26 FLOP per pixel-iteration (0.9 M
// pixels at B = 8 x 290x387: 23 MFLOP per iteration, ~0.35 us at the float32
// peak), and the whole solve moves its inputs once and its output once, so the
// bound is the operations. What bounds this design is latency: per iteration
// two lane barriers (a release, the arrival and a poll through L2 each) and two
// L2 reads of the partials, one overlapped with the halo's (2 W pixels of z
// and p_old per CTA, ~0.8 MB read per iteration at the main shape, where two
// launches per iteration streamed ~15 maps of 3.6 MB); then the pixels'
// instructions, ~47 a pixel-iteration issued from shared memory and registers.

#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256      // setup kernels
#define PCG_THREADS 512  // persistent PCG: threads per CTA (one CTA per SM)
#define PCG_WARPS (PCG_THREADS / 32)
#define PPT_CAP 14       // pixels a PCG thread owns at most: 3 x 14 registers of state

// partials of one lane: part[slot][cta]
enum { PART_PAP = 0, PART_RZ = 1, PART_RR = 2, PART_BB = 3, NPART = 4 };

__device__ __forceinline__ float guard30(float v) { return fabsf(v) < 1e-30f ? 1e-30f : v; }

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

// ---- IRLS setup ----

__global__ void edges_kernel(const float* __restrict__ z, const float* __restrict__ cx,
                             const float* __restrict__ cy, const float* __restrict__ nx,
                             const float* __restrict__ ny, const float* __restrict__ px,
                             const float* __restrict__ py, float k, float* __restrict__ ex,
                             float* __restrict__ ey, float* __restrict__ hx,
                             float* __restrict__ hy, int H, int W, int nbl) {
    const int N = H * W;
    const size_t base = (size_t)blockIdx.y * N;
    z += base; cx += base; cy += base; nx += base; ny += base; px += base; py += base;
    ex += base; ey += base; hx += base; hy += base;
    // weights toward the smoother side: wx = sigmoid(k (D-z^2 - D+z^2)), zero-padded differences
    auto wx = [&](int i, int x) {
        const float dm = x > 0 ? z[i] - z[i - 1] : 0.f;
        const float dp = x < W - 1 ? z[i + 1] - z[i] : 0.f;
        return sigm(k * (dm * dm - dp * dp));
    };
    auto wy = [&](int i, int y) {
        const float dm = y > 0 ? z[i] - z[i - W] : 0.f;
        const float dp = y < H - 1 ? z[i + W] - z[i] : 0.f;
        return sigm(k * (dm * dm - dp * dp));
    };
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N; i += nbl * blockDim.x) {
        const int y = i / W, x = i - y * W;
        if (x < W - 1) {
            const float ap = wx(i, x) * px[i] * cx[i];                    // a+ at (y,x)
            const float am = (1.f - wx(i + 1, x + 1)) * px[i + 1] * cx[i + 1];  // a- at (y,x+1)
            ex[i] = ap * cx[i] + am * cx[i + 1];
            hx[i] = -(ap * nx[i] + am * nx[i + 1]);
        } else {
            ex[i] = 0.f;
            hx[i] = 0.f;
        }
        if (y < H - 1) {
            const float ap = wy(i, y) * py[i] * cy[i];
            const float am = (1.f - wy(i + W, y + 1)) * py[i + W] * cy[i + W];
            ey[i] = ap * cy[i] + am * cy[i + W];
            hy[i] = -(ap * ny[i] + am * ny[i + W]);
        } else {
            ey[i] = 0.f;
            hy[i] = 0.f;
        }
    }
}

__global__ void rhs_diag_kernel(const float* __restrict__ ex, const float* __restrict__ ey,
                                const float* __restrict__ hx, const float* __restrict__ hy,
                                const float* __restrict__ pa, const float* __restrict__ pb,
                                float* __restrict__ b, float* __restrict__ diag, int H, int W,
                                int nbl) {
    const int N = H * W;
    const size_t base = (size_t)blockIdx.y * N;
    ex += base; ey += base; hx += base; hy += base; pa += base; pb += base; b += base; diag += base;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N; i += nbl * blockDim.x) {
        const int y = i / W, x = i - y * W;
        const float hxm = x > 0 ? hx[i - 1] : 0.f, exm = x > 0 ? ex[i - 1] : 0.f;
        const float hym = y > 0 ? hy[i - W] : 0.f, eym = y > 0 ? ey[i - W] : 0.f;
        b[i] = hxm - hx[i] + hym - hy[i] + pb[i];
        diag[i] = pa[i] + exm + ex[i] + eym + ey[i];
    }
}

// ---- persistent PCG ----

struct PcgArgs {
    const float* ex;     // (B,H,W) edge weights, 0 on the last column
    const float* ey;     // (B,H,W) edge weights, 0 on the last row
    const float* pa;     // (B,H,W)
    const float* b;      // (B,H,W)
    const float* diag;   // (B,H,W)
    float* x;            // (B,H,W) x0 in, x out
    float* zg;           // (B,H,W) z of the CTAs' first and last W pixels
    float* p0;           // (B,H,W) p of those pixels, even iterations
    float* p1;           // (B,H,W) p of those pixels, odd iterations
    float* part;         // (B,NPART,cpl) per-CTA partial sums
    unsigned* bar;       // (B,) lane barrier counters, 0 at launch
    const int* active;   // (B,)
    int* iters;          // (B,) iterations run
    int max_iter;
    float tol;           // < 0: no tolerance test
    int H, W, cpl, ppt;
};

static size_t pcg_smem_bytes(int ppt, int W) {
    const size_t chunk = (size_t)PCG_THREADS * ppt;
    return (6 * chunk + 3 * (size_t)W + 1) * sizeof(float);
}

// Barrier of the lane's cpl CTAs: `count` is the lane's counter, `target` the
// number of arrivals that completes this barrier. It follows a block_sum,
// whose __syncthreads orders the CTA's writes before thread 0's release
// arrival; thread 0 then polls the counter with acquire loads, so that what the
// lane's CTAs wrote before they arrived is visible to this CTA after the
// closing __syncthreads. Data written by other CTAs is read with __ldcg (from
// L2). A barrier still open after ~10 s of SM clock traps, so a fault surfaces
// as a launch error instead of a hung card.
#define BARRIER_TIMEOUT_CYCLES (20LL * 1000 * 1000 * 1000)

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void lane_barrier(unsigned* count, unsigned target) {
    if (threadIdx.x == 0) {
        asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count), "r"(1u) : "memory");
        const long long t0 = clock64();
        while (load_acquire(count) < target)
            if (clock64() - t0 > BARRIER_TIMEOUT_CYCLES) __trap();
    }
    __syncthreads();
}

// Sums over the CTA of NV values; valid in thread 0. sh: NV * 32 floats.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* sh) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < NV; ++q)
        for (int o = 16; o > 0; o >>= 1) v[q] += __shfl_down_sync(0xffffffffu, v[q], o);
    if (lane == 0)
#pragma unroll
        for (int q = 0; q < NV; ++q) sh[q * 32 + wid] = v[q];
    __syncthreads();
    if (wid == 0) {
#pragma unroll
        for (int q = 0; q < NV; ++q) {
            float t = lane < PCG_WARPS ? sh[q * 32 + lane] : 0.f;
            for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
            v[q] = t;
        }
    }
}

// The lane's totals of the partial slots `slots`, summed by each warp in the
// same fixed order (so every warp of every CTA of the lane gets the same
// bits). All NV slots are loaded before any is summed.
template <int NV>
__device__ __forceinline__ void lane_totals(const float* part, const int (&slots)[NV], int cpl,
                                            float (&tot)[NV]) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < NV; ++q) tot[q] = 0.f;
    for (int m = lane; m < cpl; m += 32) {
        float w[NV];
#pragma unroll
        for (int q = 0; q < NV; ++q) w[q] = __ldcg(part + slots[q] * cpl + m);
#pragma unroll
        for (int q = 0; q < NV; ++q) tot[q] += w[q];
    }
#pragma unroll
    for (int q = 0; q < NV; ++q) {
        for (int o = 16; o > 0; o >>= 1) tot[q] += __shfl_down_sync(0xffffffffu, tot[q], o);
        tot[q] = __shfl_sync(0xffffffffu, tot[q], 0);
    }
}

// (A v) at the CTA's pixel li, where v(li) = vi: sv holds v on
// [s - W, s + chunk + W), sex ex on [s - 1, s + chunk), sey ey on
// [s - W, s + chunk), spa pa on [s, s + chunk).
__device__ __forceinline__ float stencil(const float* sv, const float* sex, const float* sey,
                                         const float* spa, int li, int W, float vi) {
    const float* v = sv + W + li;
    float out = __fmul_rn(spa[li], vi);
    out = __fadd_rn(out, __fmul_rn(sex[li], __fsub_rn(vi, v[-1])));
    out = __fsub_rn(out, __fmul_rn(sex[li + 1], __fsub_rn(v[1], vi)));
    out = __fadd_rn(out, __fmul_rn(sey[li], __fsub_rn(vi, v[-W])));
    out = __fsub_rn(out, __fmul_rn(sey[li + W], __fsub_rn(v[W], vi)));
    return out;
}

// p = z + beta p_old, rounded as the plain version rounds it (never contracted
// into an fma), and the same everywhere: a neighbour's copy of p is
// bit-identical to its owner's.
__device__ __forceinline__ float p_next(float beta, float p_old, float z) {
    return __fadd_rn(z, __fmul_rn(beta, p_old));
}

#define HALO_SLOTS 2  // halo pixels a thread loads ahead of the lane's totals

__global__ void __launch_bounds__(PCG_THREADS, 1) pcg_kernel(const PcgArgs a) {
    extern __shared__ float smem[];
    __shared__ float sh_red[3 * 32];
    const int lane = blockIdx.x / a.cpl, j = blockIdx.x - lane * a.cpl;
    if (!a.active[lane]) return;
    const int H = a.H, W = a.W, N = H * W, tid = threadIdx.x;
    const int chunk = PCG_THREADS * a.ppt;
    const int s = j * chunk, n_own = min(chunk, N - s);
    const size_t base = (size_t)lane * N;
    const float *ex = a.ex + base, *ey = a.ey + base, *pa = a.pa + base, *b = a.b + base,
                *diag = a.diag + base;
    float *x = a.x + base, *zg = a.zg + base;
    float* part = a.part + (size_t)lane * NPART * a.cpl;
    unsigned* count = a.bar + lane;
    unsigned target = 0;
    float* sv = smem;                 // p (x0 in the prologue) on [s - W, s + chunk + W)
    float* sex = sv + chunk + 2 * W;  // ex on [s - 1, s + chunk)
    float* sey = sex + chunk + 1;     // ey on [s - W, s + chunk)
    float* spa = sey + chunk + W;     // pa on [s, s + chunk)
    float* smi = spa + chunk;         // M^-1 on [s, s + chunk)
    float* sx = smi + chunk;          // x on [s, s + chunk)
    auto in_lane = [&](int g) { return g >= 0 && g < N; };
    // owned pixels k < npx of this thread (li = k PCG_THREADS + tid < n_own)
    const int npx = min(a.ppt, (n_own - tid + PCG_THREADS - 1) / PCG_THREADS);
    // pixels another CTA reads: the first and last W of this CTA's
    auto shared_px = [&](int li) { return li < W || n_own - li <= W; };
    // the halo's h-th pixel, h < 2 W: its index m in sv (its pixel is s - W + m)
    auto halo_m = [&](int h) { return h < W ? h : chunk + h; };

    // ---- prologue: maps into shared memory; r = b - A x0, z = M^-1 r ----
    // ex is 0 on the last column and ey on the last row (enforced here), so
    // the stencil needs no test of the image's border
    for (int m = tid; m < chunk + 1; m += PCG_THREADS) {
        const int g = s - 1 + m;
        sex[m] = in_lane(g) && g % W != W - 1 ? ex[g] : 0.f;
    }
    for (int m = tid; m < chunk + W; m += PCG_THREADS) {
        const int g = s - W + m;
        sey[m] = in_lane(g) && g < N - W ? ey[g] : 0.f;
    }
    for (int m = tid; m < chunk; m += PCG_THREADS) {
        const bool in = m < n_own;
        spa[m] = in ? pa[s + m] : 0.f;
        smi[m] = in ? 1.f / fmaxf(diag[s + m], 1e-5f) : 0.f;
    }
    for (int m = tid; m < chunk + 2 * W; m += PCG_THREADS) sv[m] = in_lane(s - W + m) ? x[s - W + m] : 0.f;
    __syncthreads();

    float rr[PPT_CAP], pr[PPT_CAP], apr[PPT_CAP];
    float red[3] = {0.f, 0.f, 0.f};  // r.z, r.r, b.b
#pragma unroll
    for (int k = 0; k < PPT_CAP; ++k) {
        const int li = k * PCG_THREADS + tid;
        rr[k] = pr[k] = apr[k] = 0.f;
        if (k < npx) {
            const int g = s + li;
            const float bi = b[g];
            const float xi = sv[W + li];
            sx[li] = xi;
            const float ri = __fsub_rn(bi, stencil(sv, sex, sey, spa, li, W, xi));
            const float zi = __fmul_rn(smi[li], ri);
            rr[k] = ri;
            red[0] = __fadd_rn(red[0], __fmul_rn(ri, zi));
            red[1] = __fadd_rn(red[1], __fmul_rn(ri, ri));
            red[2] = __fadd_rn(red[2], __fmul_rn(bi, bi));
            if (shared_px(li)) zg[g] = zi;
        }
    }
    block_sum(red, sh_red);
    if (tid == 0) {
        part[PART_RZ * a.cpl + j] = red[0];
        part[PART_RR * a.cpl + j] = red[1];
        part[PART_BB * a.cpl + j] = red[2];
    }
    lane_barrier(count, target += a.cpl);

    // ---- iterations ----
    float rz = 0.f, rz_prev = 0.f, bnorm = 0.f;
    int it = 0;
    for (; it < a.max_iter; ++it) {
        // phase M. The halo's z and p_old first, so that their L2 round trip
        // overlaps the read of the partials.
        float* pnew = ((it & 1) ? a.p1 : a.p0) + base;
        const float* pold = ((it & 1) ? a.p0 : a.p1) + base;
        float hz[HALO_SLOTS], hp[HALO_SLOTS];
#pragma unroll
        for (int u = 0; u < HALO_SLOTS; ++u) {
            const int h = u * PCG_THREADS + tid, g = s - W + halo_m(h);
            const bool ok = h < 2 * W && in_lane(g);
            hz[u] = ok ? __ldcg(zg + g) : 0.f;
            hp[u] = ok && it > 0 ? __ldcg(pold + g) : 0.f;
        }
        float rr_tot;
        if (it == 0) {
            const int slots[3] = {PART_RZ, PART_RR, PART_BB};
            float tot[3];
            lane_totals(part, slots, a.cpl, tot);
            rz = tot[0];
            rr_tot = tot[1];
            bnorm = sqrtf(tot[2]) + 1e-30f;
        } else {
            const int slots[2] = {PART_RZ, PART_RR};
            float tot[2];
            lane_totals(part, slots, a.cpl, tot);
            rz = tot[0];
            rr_tot = tot[1];
        }
        if (!(a.tol < 0.f || sqrtf(rr_tot) > a.tol * bnorm)) break;
        const float beta = it > 0 ? rz / guard30(rz_prev) : 0.f;
#pragma unroll
        for (int k = 0; k < PPT_CAP; ++k) {
            if (k >= npx) break;
            const int li = k * PCG_THREADS + tid;
            const float zi = __fmul_rn(smi[li], rr[k]);
            const float pi = it > 0 ? p_next(beta, pr[k], zi) : zi;
            pr[k] = pi;
            sv[W + li] = pi;
            if (shared_px(li)) pnew[s + li] = pi;
        }
#pragma unroll
        for (int u = 0; u < HALO_SLOTS; ++u) {
            const int h = u * PCG_THREADS + tid, m = halo_m(h);
            if (h < 2 * W && in_lane(s - W + m)) sv[m] = it > 0 ? p_next(beta, hp[u], hz[u]) : hz[u];
        }
        for (int h = HALO_SLOTS * PCG_THREADS + tid; h < 2 * W; h += PCG_THREADS) {  // wider images
            const int m = halo_m(h), g = s - W + m;
            if (in_lane(g)) {
                const float zi = __ldcg(zg + g);
                sv[m] = it > 0 ? p_next(beta, __ldcg(pold + g), zi) : zi;
            }
        }
        __syncthreads();
        float pap[1] = {0.f};
#pragma unroll
        for (int k = 0; k < PPT_CAP; ++k) {
            if (k >= npx) break;
            apr[k] = stencil(sv, sex, sey, spa, k * PCG_THREADS + tid, W, pr[k]);
            pap[0] = __fadd_rn(pap[0], __fmul_rn(pr[k], apr[k]));
        }
        block_sum(pap, sh_red);
        if (tid == 0) part[PART_PAP * a.cpl + j] = pap[0];
        lane_barrier(count, target += a.cpl);

        // phase U
        const int slots[1] = {PART_PAP};
        float pap_tot[1];
        lane_totals(part, slots, a.cpl, pap_tot);
        const float alpha = rz / guard30(pap_tot[0]);
        float rzr[2] = {0.f, 0.f};  // r.z, r.r
#pragma unroll
        for (int k = 0; k < PPT_CAP; ++k) {
            if (k >= npx) break;
            const int li = k * PCG_THREADS + tid;
            sx[li] = __fadd_rn(sx[li], __fmul_rn(alpha, pr[k]));
            const float ri = __fsub_rn(rr[k], __fmul_rn(alpha, apr[k]));
            const float zi = __fmul_rn(smi[li], ri);
            rr[k] = ri;
            rzr[0] = __fadd_rn(rzr[0], __fmul_rn(ri, zi));
            rzr[1] = __fadd_rn(rzr[1], __fmul_rn(ri, ri));
            if (shared_px(li)) zg[s + li] = zi;
        }
        block_sum(rzr, sh_red);
        if (tid == 0) {
            part[PART_RZ * a.cpl + j] = rzr[0];
            part[PART_RR * a.cpl + j] = rzr[1];
        }
        rz_prev = rz;
        lane_barrier(count, target += a.cpl);
    }

#pragma unroll
    for (int k = 0; k < PPT_CAP; ++k) {
        if (k >= npx) break;
        x[s + k * PCG_THREADS + tid] = sx[k * PCG_THREADS + tid];
    }
    if (j == 0 && tid == 0) a.iters[lane] = it;
}

// ---- C interface: every map is (B,H,W) contiguous f32; each returns a CUDA error code ----

extern "C" int bini_setup(const float* z, const float* cx, const float* cy, const float* nx,
                          const float* ny, const float* px, const float* py, const float* pa,
                          const float* pb, float k, float* ex, float* ey, float* hx, float* hy,
                          float* b, float* diag, int B, int H, int W, int nbl, void* stream) {
    const dim3 grid(nbl, B);
    cudaStream_t s = (cudaStream_t)stream;
    edges_kernel<<<grid, THREADS, 0, s>>>(z, cx, cy, nx, ny, px, py, k, ex, ey, hx, hy, H, W, nbl);
    rhs_diag_kernel<<<grid, THREADS, 0, s>>>(ex, ey, hx, hy, pa, pb, b, diag, H, W, nbl);
    return (int)cudaGetLastError();
}

// Makes card `dev` the calling thread's current device while it lives (the
// function attributes and the cooperative launch act on the current device).
struct DeviceScope {
    int prev = -1;
    cudaError_t err;
    explicit DeviceScope(int dev) {
        err = cudaGetDevice(&prev);
        if (err == cudaSuccess && prev != dev) err = cudaSetDevice(dev);
        else prev = -1;
    }
    ~DeviceScope() {
        if (prev >= 0) cudaSetDevice(prev);
    }
};

// out[0]: CTAs of pcg_kernel that card `dev` holds at once at PPT_CAP pixels
// per thread and width W (0 when its shared memory does not fit a CTA);
// out[1..3]: PCG_THREADS, PPT_CAP and NPART, which the wrapper's planner and
// partials buffer must match.
extern "C" int bini_pcg_capacity(int dev, int W, int* out) {
    out[0] = 0;
    out[1] = PCG_THREADS;
    out[2] = PPT_CAP;
    out[3] = NPART;
    const size_t smem = pcg_smem_bytes(PPT_CAP, W);
    const DeviceScope scope(dev);
    int sms = 0, optin = 0, per_sm = 0;
    cudaError_t e = scope.err;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess && smem > (size_t)optin) return 0;
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pcg_kernel, PCG_THREADS, smem);
    cudaGetLastError();  // a failure here is returned, not left for the next launch to report
    out[0] = per_sm * sms;
    return (int)e;
}

// One PCG solve of B lanes, cpl CTAs per lane, ppt pixels per thread, on card
// `dev` (the maps' card; stream is one of its streams). The launch is refused
// (cudaErrorCooperativeLaunchTooLarge) unless all B cpl CTAs are resident at
// once.
extern "C" int bini_pcg(const float* ex, const float* ey, const float* pa, const float* b,
                        const float* diag, float* x, float* zg, float* p0, float* p1, float* part,
                        unsigned* bar, const int* active, int* iters, int max_iter, float tol, int B,
                        int H, int W, int cpl, int ppt, int dev, void* stream) {
    const long long N = (long long)H * W, chunk = (long long)PCG_THREADS * ppt;
    if (B < 1 || ppt < 1 || ppt > PPT_CAP || cpl < 1 || (cpl - 1) * chunk >= N || cpl * chunk < N)
        return (int)cudaErrorInvalidValue;
    PcgArgs args{ex, ey, pa, b, diag, x, zg, p0, p1, part, bar, active, iters, max_iter, tol, H, W, cpl, ppt};
    const size_t smem = pcg_smem_bytes(ppt, W);
    const DeviceScope scope(dev);
    cudaError_t e = scope.err;
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) {
        void* params[] = {&args};
        e = cudaLaunchCooperativeKernel((const void*)pcg_kernel, dim3(B * cpl), dim3(PCG_THREADS), params,
                                        smem, (cudaStream_t)stream);
    }
    const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
    return (int)(e != cudaSuccess ? e : last);
}
