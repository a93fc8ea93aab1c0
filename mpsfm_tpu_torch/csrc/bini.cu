// K2: BiNI log-depth solve — IRLS stencil setup and the Jacobi-PCG core,
// batched over a bundle's B images.
//
// Replaces the TPU kernel _bini_kernel (mpsfm_tpu/integration/bini_pallas.py:83,
// pallas_call at :217). That kernel keeps every map of one image in VMEM and
// runs the whole fixed-budget IRLS + PCG inside one launch. On the H100 a
// 290x387 image with a dozen f32 maps is ~5 MB and a bundle of 8 is ~40 MB:
// no shared memory holds it, so the maps stream through L2 (50 MB) and HBM.
//
// Entry points (plain C, bound with ctypes):
//   bini_setup      one IRLS round's operator from z: bilateral weights
//                   sigma(k (D-z^2 - D+z^2)), the edge weights ex/ey of the
//                   4-direction stencil, the rhs b and the Jacobi diagonal;
//   bini_pcg_init   r = b - A x0, M^-1 = 1/max(diag, 1e-5), z = M^-1 r;
//   bini_pcg_iters  n PCG iterations, two launches each.
// The fixed-budget solve (bini_solve_pallas semantics) chains setup + init +
// iters per IRLS round; the main path's IRLS (_bini_solve_impl) builds its
// operator in torch and runs only the PCG core, with a relative tolerance
// ||r|| > tol ||b|| checked before each iteration and a per-lane active flag.
//
// The stencil is written in edge form: the masked one-sided differences of
// the reference, D+^T(a+ D+ v) + D-^T(a- D- v), collapse to one weight per
// edge (y,x)-(y,x+1): ex = a+(y,x) + a-(y,x+1), so that
// (A v)(i) = pa v(i) + sum over the 4 edges of i of e (v(i) - v(j)).
//
// Reductions: grid (nbl, B), so each block belongs to one lane. Every dot
// product is summed per block in a fixed order and written to a partials
// array; the next kernel's blocks each sum their lane's nbl partials in the
// same fixed order. No atomics, so z is the same from run to run. Scalars
// (alpha, beta, the tolerance test) are recomputed from the partials on
// the device: no host read per iteration. rz and ||r||^2 partials are
// double-buffered by iteration parity; a lane that stops (tolerance met or
// inactive) copies its partials forward and keeps its x frozen, as a
// vmapped while_loop freezes a finished lane's carry.
//
// What bounds it on the H100: one PCG iteration reads ~10 and writes ~5
// f32 maps, about 2.4 FLOP per byte moved, so each iteration is bound by
// bytes (L2 when the bundle fits in it, else HBM); the whole solve moves its
// inputs once and its output once, so against that floor it is bound by its
// ~35 FLOP per pixel per iteration. Two launches per iteration keep every
// intermediate out of host memory; fusing the two (a cooperative persistent
// kernel) is later work.

#include <cuda_runtime.h>
#include <math.h>

#define THREADS 256

// partials layout: part[slot][lane][nbl]
enum { PAP = 0, RZ0 = 1, RR0 = 3, BB = 5 };  // RZ0/RZ0+1 and RR0/RR0+1 by parity

__device__ __forceinline__ float guard30(float v) { return fabsf(v) < 1e-30f ? 1e-30f : v; }

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

// Sum over the block; the result is valid in thread 0. sh: 32 floats of shared memory.
__device__ float block_sum(float v, float* sh) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    if (lane == 0) sh[wid] = v;
    __syncthreads();
    v = 0.f;
    if (wid == 0) {
        v = lane < (int)(blockDim.x >> 5) ? sh[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    }
    __syncthreads();
    return v;
}

// Sum of one lane's nbl block partials, in a fixed order, broadcast to every thread.
__device__ float lane_total(const float* part, int nbl, float* sh1) {
    if (threadIdx.x < 32) {
        float v = 0.f;
        for (int i = threadIdx.x; i < nbl; i += 32) v += part[i];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
        if (threadIdx.x == 0) *sh1 = v;
    }
    __syncthreads();
    const float t = *sh1;
    __syncthreads();
    return t;
}

__device__ __forceinline__ float* part_of(float* part, int slot, int B, int b, int nbl) {
    return part + ((size_t)slot * B + b) * nbl;
}

// pa v(i) + sum of e (v(i) - v(j)) over the edges of i; V(j) gives v at flat index j.
template <class V>
__device__ __forceinline__ float apply_A(const V& v, const float* ex, const float* ey,
                                         const float* pa, int i, int x, int y, int H, int W) {
    const float vi = v(i);
    float out = pa[i] * vi;
    if (x > 0) out += ex[i - 1] * (vi - v(i - 1));
    if (x < W - 1) out -= ex[i] * (v(i + 1) - vi);
    if (y > 0) out += ey[i - W] * (vi - v(i - W));
    if (y < H - 1) out -= ey[i] * (v(i + W) - vi);
    return out;
}

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

// ---- PCG core ----

__global__ void cg_init_kernel(const float* __restrict__ ex, const float* __restrict__ ey,
                               const float* __restrict__ pa, const float* __restrict__ b,
                               const float* __restrict__ diag, const float* __restrict__ x,
                               float* __restrict__ r, float* __restrict__ zv,
                               float* __restrict__ minv, float* __restrict__ part,
                               const int* __restrict__ active, int B, int H, int W, int nbl) {
    __shared__ float sh[32];
    const int lane_id = blockIdx.y;
    if (!active[lane_id]) return;
    const int N = H * W;
    const size_t base = (size_t)lane_id * N;
    ex += base; ey += base; pa += base; b += base; diag += base; x += base;
    r += base; zv += base; minv += base;
    auto v = [&](int j) { return x[j]; };
    float arz = 0.f, arr = 0.f, abb = 0.f;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N; i += nbl * blockDim.x) {
        const int y = i / W, xx = i - y * W;
        const float mi = 1.f / fmaxf(diag[i], 1e-5f);
        const float ri = b[i] - apply_A(v, ex, ey, pa, i, xx, y, H, W);
        const float zi = mi * ri;
        minv[i] = mi;
        r[i] = ri;
        zv[i] = zi;
        arz += ri * zi;
        arr += ri * ri;
        abb += b[i] * b[i];
    }
    arz = block_sum(arz, sh);
    arr = block_sum(arr, sh);
    abb = block_sum(abb, sh);
    if (threadIdx.x == 0) {
        part_of(part, RZ0, B, lane_id, nbl)[blockIdx.x] = arz;
        part_of(part, RR0, B, lane_id, nbl)[blockIdx.x] = arr;
        part_of(part, BB, B, lane_id, nbl)[blockIdx.x] = abb;
    }
}

// Does lane `b` run iteration `it`? (active, and ||r|| > tol ||b|| unless tol < 0)
__device__ bool lane_runs(float* part, const int* active, int B, int b, int nbl, int cur,
                          float tol, float* sh1) {
    if (!active[b]) return false;
    if (tol < 0.f) return true;
    const float rr = lane_total(part_of(part, RR0 + cur, B, b, nbl), nbl, sh1);
    const float bb = lane_total(part_of(part, BB, B, b, nbl), nbl, sh1);
    return sqrtf(rr) > tol * (sqrtf(bb) + 1e-30f);
}

// p = z + beta p_old (p = z at it 0), Ap, and the partials of p.Ap.
__global__ void cg_matvec_kernel(const float* __restrict__ ex, const float* __restrict__ ey,
                                 const float* __restrict__ pa, const float* __restrict__ zv,
                                 const float* __restrict__ pold, float* __restrict__ pnew,
                                 float* __restrict__ ap, float* __restrict__ part,
                                 const int* __restrict__ active, int* __restrict__ live, int it,
                                 float tol, int B, int H, int W, int nbl) {
    __shared__ float sh[32];
    __shared__ float sh1;
    const int lane_id = blockIdx.y;
    const int cur = it & 1;
    const bool go = lane_runs(part, active, B, lane_id, nbl, cur, tol, &sh1);
    if (blockIdx.x == 0 && threadIdx.x == 0) live[lane_id] = go ? 1 : 0;
    if (!go) return;
    float beta = 0.f;
    if (it > 0) {
        const float rz_new = lane_total(part_of(part, RZ0 + cur, B, lane_id, nbl), nbl, &sh1);
        const float rz_old = lane_total(part_of(part, RZ0 + 1 - cur, B, lane_id, nbl), nbl, &sh1);
        beta = rz_new / guard30(rz_old);
    }
    const int N = H * W;
    const size_t base = (size_t)lane_id * N;
    ex += base; ey += base; pa += base; zv += base; pold += base; pnew += base; ap += base;
    const bool first = it == 0;
    auto v = [&](int j) { return first ? zv[j] : fmaf(beta, pold[j], zv[j]); };
    float acc = 0.f;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N; i += nbl * blockDim.x) {
        const int y = i / W, x = i - y * W;
        const float pi = v(i);
        const float api = apply_A(v, ex, ey, pa, i, x, y, H, W);
        pnew[i] = pi;
        ap[i] = api;
        acc += pi * api;
    }
    acc = block_sum(acc, sh);
    if (threadIdx.x == 0) part_of(part, PAP, B, lane_id, nbl)[blockIdx.x] = acc;
}

// x += alpha p, r -= alpha Ap, z = M^-1 r, and the partials of r.z and r.r.
__global__ void cg_update_kernel(const float* __restrict__ pnew, const float* __restrict__ ap,
                                 const float* __restrict__ minv, float* __restrict__ x,
                                 float* __restrict__ r, float* __restrict__ zv,
                                 float* __restrict__ part, const int* __restrict__ active,
                                 int* __restrict__ iters, int it, float tol, int B, int H, int W,
                                 int nbl) {
    __shared__ float sh[32];
    __shared__ float sh1;
    const int lane_id = blockIdx.y;
    const int cur = it & 1;
    if (!lane_runs(part, active, B, lane_id, nbl, cur, tol, &sh1)) {
        if (threadIdx.x == 0) {  // a stopped lane carries its partials to the next parity
            part_of(part, RZ0 + 1 - cur, B, lane_id, nbl)[blockIdx.x] =
                part_of(part, RZ0 + cur, B, lane_id, nbl)[blockIdx.x];
            part_of(part, RR0 + 1 - cur, B, lane_id, nbl)[blockIdx.x] =
                part_of(part, RR0 + cur, B, lane_id, nbl)[blockIdx.x];
        }
        return;
    }
    const float rz = lane_total(part_of(part, RZ0 + cur, B, lane_id, nbl), nbl, &sh1);
    const float pap = lane_total(part_of(part, PAP, B, lane_id, nbl), nbl, &sh1);
    const float alpha = rz / guard30(pap);
    const int N = H * W;
    const size_t base = (size_t)lane_id * N;
    pnew += base; ap += base; minv += base; x += base; r += base; zv += base;
    float arz = 0.f, arr = 0.f;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < N; i += nbl * blockDim.x) {
        x[i] = x[i] + alpha * pnew[i];
        const float ri = r[i] - alpha * ap[i];
        const float zi = minv[i] * ri;
        r[i] = ri;
        zv[i] = zi;
        arz += ri * zi;
        arr += ri * ri;
    }
    arz = block_sum(arz, sh);
    arr = block_sum(arr, sh);
    if (threadIdx.x == 0) {
        part_of(part, RZ0 + 1 - cur, B, lane_id, nbl)[blockIdx.x] = arz;
        part_of(part, RR0 + 1 - cur, B, lane_id, nbl)[blockIdx.x] = arr;
        if (blockIdx.x == 0) iters[lane_id] += 1;
    }
}

// ---- C interface: every map is (B,H,W) contiguous f32; each returns cudaGetLastError() ----

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

extern "C" int bini_pcg_init(const float* ex, const float* ey, const float* pa, const float* b,
                             const float* diag, const float* x, float* r, float* zv, float* minv,
                             float* part, const int* active, int B, int H, int W, int nbl,
                             void* stream) {
    const dim3 grid(nbl, B);
    cg_init_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(ex, ey, pa, b, diag, x, r, zv, minv,
                                                               part, active, B, H, W, nbl);
    return (int)cudaGetLastError();
}

// Iterations it0 .. it0+n-1. p0/p1 alternate as the new/old direction by parity.
extern "C" int bini_pcg_iters(const float* ex, const float* ey, const float* pa, const float* minv,
                              float* x, float* r, float* zv, float* p0, float* p1, float* ap,
                              float* part, const int* active, int* live, int* iters, int it0,
                              int n, float tol, int B, int H, int W, int nbl, void* stream) {
    const dim3 grid(nbl, B);
    cudaStream_t s = (cudaStream_t)stream;
    for (int it = it0; it < it0 + n; ++it) {
        float* pnew = (it & 1) ? p1 : p0;
        const float* pold = (it & 1) ? p0 : p1;
        cg_matvec_kernel<<<grid, THREADS, 0, s>>>(ex, ey, pa, zv, pold, pnew, ap, part, active, live,
                                                  it, tol, B, H, W, nbl);
        cg_update_kernel<<<grid, THREADS, 0, s>>>(pnew, ap, minv, x, r, zv, part, active, iters, it,
                                                  tol, B, H, W, nbl);
        const cudaError_t e = cudaPeekAtLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}
