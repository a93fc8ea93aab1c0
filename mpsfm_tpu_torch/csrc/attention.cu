// K4: masked multi-head attention out = softmax(q k^T * scale) v, float32.
//
// Replaces the TPU kernel behind LightGlue._attention
// (mpsfm_tpu/extraction/matchers/lightglue.py:322; MPSFM_LG_ATTN=pallas calls
// JAX's TPU flash_attention, whose pallas_call is the kernel, :364-388). The
// function is the JAX package's einsum path (:389-391): logits = q.k * scale,
// a masked key's logit replaced by -1e9, softmax over the keys, the product
// with v. q is (B, N, H, HD), k and v (B, M, H, HD), the key mask (B, M) one
// byte a key (nonzero = a real key), out (B, N, H, HD), all contiguous.
// LightGlue calls it with HD = 64 (the official 256 = 4 x 64) in its self
// blocks (N = M) and cross blocks (N != M in general), MASt3R, the two-view
// and warp nets, DepthAnythingV2, DepthPro and RoMa's DINOv2 with HD = 64 and
// every key real; HD = 16 is the tests' LightGlue (64 = 4 x 16); HD = 48 the
// framework's trained prior (nets/mono.py at train_mono's default net, 96 =
// 2 x 48, 81 tokens of a 160 x 128 frame), forward and training step alike.
//
// Both kernels run the flash algorithm in float32 on the CUDA cores (no TF32):
// the keys go by tiles of 64, a running max m and sum l a query row, the
// accumulator rescaled by exp(m_old - m_new). A tile without a real key is
// skipped whenever the batch element has one (a masked key's weight
// exp(-1e9 - m) is then exactly 0, so the result is the same; LightGlue pads
// its keypoints at the end, so the skipped tiles are the padding past the last
// real key). A masked key's logit is -1e9 as in the plain version, so a row
// whose first tile is all masked (only when every key of the batch element
// is) keeps a finite running max; a key past M gets weight 0 (every tile holds
// a key below M, so the max stays finite). Padded query rows are computed like
// any other (they attend the real keys) and finite; rows past N are not
// written.
//
// HD = 64, attention_tile_kernel: one CTA of 256 threads per (64 query rows,
// head, batch element). Each 64 x 64 logit tile S = Q K^T is register-blocked:
// thread (ty, tx) = (tid / 16, tid % 16) owns the 4 x 4 sub-tile of rows 4 ty
// .. 4 ty + 3 and keys tx + 16 j, and the 4 x 4 sub-tile of O (64 rows x 64)
// of the same rows and columns 4 tx .. 4 tx + 3. Per step of 4 along HD it
// reads 4 float4 of Q and 4 of K for 64 FMA (two float4 reads a 16 FMA), and
// a warp's reads are 2 float4 of Q (broadcast) and 16 of K: 7 FMA a float of
// shared memory it reads. Q is staged once, K
// and V go through a 2-stage ring of 16-byte cp.async.cg copies, so the next
// tile's loads overlap this tile's products; the next tile with a real key is
// found before its copies are issued (a ballot over 256 mask bytes at a time).
// Q, K and P are kept with rows 68 floats apart, so that the float4 reads of a
// warp (16 keys of a tile, 8 rows of P) fall in distinct banks. The 16 threads
// of a row sit in one warp: the row max is 4 __shfl_xor_sync, and l is summed
// over them once at the end. The softmax runs in the log2 domain (logits times
// scale * log2 e, exp2f), one rescale of (l, acc) a tile. P goes key-major
// through shared memory for O += P V (a float4 of P's 4 rows and a float4 of
// V's 4 columns a key). Shared memory: Q 17 KB, P 17 KB and per stage K 17 KB
// + V 16 KB, 100 KB in all, so two CTAs share an SM (16 warps).
//
// HD = 16 and 48, attention_row_kernel (the first float32 kernel's body, kept
// for the tests' LightGlue and taken for the trained prior): one CTA of 64
// threads per 64-query tile, one query row a thread, its q and accumulator in
// registers; each tile's K and V rows staged in shared memory and read as
// float4 broadcasts, 8 keys between two rescales. At HD = 48 the trained
// prior's calls (8 x 81 tokens x 2 heads) are a few microseconds of work, so
// launches bound them: on an H100 (k4_f32_probe.py --hd48) this kernel took
// 0.038 ms there against 0.105-0.117 ms for q, k and v zero-padded to 64 on
// the tile kernel (three pads and a slice around it) and 0.067 ms for SDPA;
// from a few hundred tokens the tile kernel's reuse wins (769 tokens: 0.090
// padded against 0.274 here).
//
// What bounds it on the H100: 4 B H N M' HD FLOP (two products of N x M' x HD
// FMA, M' the real keys) against 67 TFLOP/s of float32 outside the tensor
// cores, while the bytes (q, k, v and out once) take microseconds. At MASt3R's
// encoder call (B = 2 views, N = M = 1200 tokens, 16 heads, HD 64) that is
// 11.80 GFLOP, 0.1761 ms; the bytes (39 MB) 0.012 ms. Operations bound it. Its
// grid is 19 x 16 x 2 = 608 CTAs, 2.3 waves of 264 (2 an SM on 132 SMs).
// TILE_Q sets the CTA's height (TILE_Q / 4 row groups of 16 threads). On an
// H100 (k4_f32_probe.py, builds in turns) 64 was the fastest at every shape
// measured: at this call 0.397-0.400 ms, against 0.481-0.483 with 32 query
// rows (a K/V tile feeds half the rows; 2 CTAs of 4 warps an SM) and
// 0.495-0.497 with 128 (1 CTA of 16 warps an SM by shared memory, 10 x 32 =
// 320 CTAs in 2.4 waves).

#include <cuda_runtime.h>

// ---------------------------------------------------------------- HD = 16, 48

#define ATT_BQ 64  // query rows of a CTA, one a thread
#define ATT_BK 64  // keys of a staged tile
#define ATT_CH 8   // keys between two rescales of the accumulator

template <int HD>
__global__ void __launch_bounds__(ATT_BQ) attention_row_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                                               const float* __restrict__ v,
                                                               const unsigned char* __restrict__ mask,
                                                               float* __restrict__ out, int N, int M, int H,
                                                               float scale) {
    static_assert(HD % 4 == 0 && ATT_BK % ATT_CH == 0, "tile shapes");
    __shared__ float4 ks[ATT_BK * HD / 4];
    __shared__ float4 vs[ATT_BK * HD / 4];
    __shared__ float kcode[ATT_BK];  // 0: a real key, 1: a masked key, 2: past M
    const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
    const int n = blockIdx.x * ATT_BQ + tid;
    const bool active = n < N;

    float qr[HD], acc[HD];
    const float* qp = q + (((size_t)b * N + (active ? n : 0)) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
        qr[d] = active ? qp[d] : 0.f;
        acc[d] = 0.f;
    }
    float m = -1e30f, l = 0.f;
    // a batch element with no real key: every key is masked and each weighs the same, so no tile is skipped
    int any_real = 0;
    for (int j = tid; j < M; j += ATT_BQ) any_real |= mask[(size_t)b * M + j] != 0;
    const bool skip_masked = __syncthreads_or(any_real);
    float* ksf = reinterpret_cast<float*>(ks);
    float* vsf = reinterpret_cast<float*>(vs);

    for (int k0 = 0; k0 < M; k0 += ATT_BK) {
        __syncthreads();  // the previous tile is read by every thread
        int tile_real = 0;
        for (int j = tid; j < ATT_BK; j += ATT_BQ) {
            const int key = k0 + j;
            const bool real = key < M && mask[(size_t)b * M + key];
            kcode[j] = real ? 0.f : (key < M ? 1.f : 2.f);
            tile_real |= real;
        }
        if (!__syncthreads_or(tile_real) && skip_masked) continue;  // all its weights are 0
        for (int i = tid; i < ATT_BK * HD; i += ATT_BQ) {
            const int key = k0 + i / HD;
            float kv = 0.f, vv = 0.f;
            if (key < M) {
                const size_t off = (((size_t)b * M + key) * H + h) * HD + i % HD;
                kv = k[off];
                vv = v[off];
            }
            ksf[i] = kv;
            vsf[i] = vv;
        }
        __syncthreads();
        const int nk = min(ATT_BK, M - k0);
        for (int c = 0; c < nk; c += ATT_CH) {
            float s[ATT_CH];
            float cmax = -INFINITY;
#pragma unroll
            for (int u = 0; u < ATT_CH; ++u) {
                const int j = c + u;
                float dot = 0.f;
#pragma unroll
                for (int d4 = 0; d4 < HD / 4; ++d4) {
                    const float4 kk = ks[j * (HD / 4) + d4];
                    dot = fmaf(qr[4 * d4], kk.x, dot);
                    dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
                    dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
                    dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
                }
                const float code = kcode[j];
                s[u] = code == 0.f ? dot * scale : (code == 1.f ? -1e9f : -INFINITY);
                cmax = fmaxf(cmax, s[u]);
            }
            const float mn = fmaxf(m, cmax);
            const float corr = expf(m - mn);
            l *= corr;
#pragma unroll
            for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
            for (int u = 0; u < ATT_CH; ++u) {
                const float p = expf(s[u] - mn);
                l += p;
#pragma unroll
                for (int d4 = 0; d4 < HD / 4; ++d4) {
                    const float4 vv = vs[(c + u) * (HD / 4) + d4];
                    acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
                    acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
                    acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
                    acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
                }
            }
            m = mn;
        }
    }
    if (active) {
        float* op = out + (((size_t)b * N + n) * H + h) * HD;
        const float inv = 1.f / l;
#pragma unroll
        for (int d = 0; d < HD; ++d) op[d] = acc[d] * inv;
    }
}

// ---------------------------------------------------------------- HD = 64

#define TILE_HD 64      // the head width of the tiled kernel
#define TILE_Q 64       // query rows of a CTA
#define TILE_K 64       // keys of a staged tile
#define TILE_T (4 * TILE_Q)  // threads: TILE_Q / 4 row groups x 16 column groups, a 4 x 4 sub-tile each
#define TILE_LD 68      // floats between two rows of Q and K in shared memory
#define TILE_LDP (TILE_Q + 4)  // floats between two keys' rows of P
#define TILE_STAGE (TILE_K * TILE_LD + TILE_K * TILE_HD)  // floats of one stage of the ring: K, then V
#define TILE_SMEM ((TILE_Q * TILE_LD + TILE_K * TILE_LDP + 2 * TILE_STAGE) * 4)  // bytes: Q, P, the ring's 2 stages
#define LOG2E 1.4426950408889634f

// a 16-byte copy to shared memory that bypasses L1, zero-filled where `in` is false
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// wait until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory"); }

// rows r0 .. r0 + NR - 1 of one head of x (rows of a batch element, H heads of 64 floats) into dst, rows ld
// floats apart: NR rows x 16 chunks of 16 bytes, consecutive threads on consecutive chunks of a row
template <int NR>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* x, int b, int rows, int h, int H, int r0,
                                           int tid) {
    static_assert(NR * TILE_HD / 4 % TILE_T == 0, "whole chunks a thread");
#pragma unroll
    for (int i = 0; i < NR * TILE_HD / 4 / TILE_T; ++i) {
        const int c = tid + i * TILE_T, row = c >> 4, col = (c & 15) * 4;
        const bool in = r0 + row < rows;
        cp_async16(dst + row * ld + col, x + (((size_t)b * rows + (in ? r0 + row : 0)) * H + h) * TILE_HD + col, in);
    }
}

// The first key tile from t0 on that holds a real key, -1 if none: TILE_T mask bytes at a time, a ballot a
// warp (a tile two warps). Every thread gets the same answer; ends on a __syncthreads after flag was written.
__device__ __forceinline__ int next_real_tile(const unsigned char* mrow, int M, int t0, int tid, int* flag) {
    for (int base = t0 * TILE_K;; base += TILE_T) {
        const int key = base + tid;
        const unsigned ballot = __ballot_sync(0xffffffffu, key < M && mrow[key] != 0);
        if ((tid & 31) == 0) flag[tid >> 5] = ballot != 0;
        __syncthreads();
        for (int w = 0; w < TILE_T / TILE_K; ++w)
            if (flag[2 * w] | flag[2 * w + 1]) return base / TILE_K + w;
        if (base + TILE_T >= M) return -1;
        __syncthreads();  // every thread has read flag
    }
}

__global__ void __launch_bounds__(TILE_T, 512 / TILE_T) attention_tile_kernel(const float* __restrict__ q,
                                                                   const float* __restrict__ k,
                                                                   const float* __restrict__ v,
                                                                   const unsigned char* __restrict__ mask,
                                                                   float* __restrict__ out, int N, int M, int H,
                                                                   float scale_log2) {
    extern __shared__ float4 tile_smem[];
    __shared__ int flag[TILE_T / 32];
    float* qs = reinterpret_cast<float*>(tile_smem);  // [TILE_Q][TILE_LD], row-major
    float* ps = qs + TILE_Q * TILE_LD;                // [TILE_K][TILE_LDP], P key-major
    float* ring = ps + TILE_K * TILE_LDP;             // 2 stages of K [TILE_K][TILE_LD] then V [TILE_K][TILE_HD]
    const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
    const int n0 = blockIdx.x * TILE_Q;
    const int ty = tid >> 4, tx = tid & 15;
    const unsigned char* mrow = mask + (size_t)b * M;
    const int ntiles = (M + TILE_K - 1) / TILE_K;
    const float masked = -1e9f * LOG2E;

    stage_rows<TILE_Q>(qs, TILE_LD, q, b, N, h, H, n0, tid);
    // a batch element with no real key: every key is masked and each weighs the same, so no tile is skipped
    int cur = next_real_tile(mrow, M, 0, tid, flag);
    const bool skip = cur >= 0;
    if (!skip) cur = 0;
    stage_rows<TILE_K>(ring, TILE_LD, k, b, M, h, H, cur * TILE_K, tid);
    stage_rows<TILE_K>(ring + TILE_K * TILE_LD, TILE_HD, v, b, M, h, H, cur * TILE_K, tid);
    cp_async_commit();
    __syncthreads();  // flag is read before the loop's search writes it again

    float acc[4][4], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -1e30f;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int st = 0;; st ^= 1) {
        // the next tile's copies into the other stage, which every thread finished reading before the search's
        // __syncthreads
        int nxt;
        if (skip) {
            nxt = next_real_tile(mrow, M, cur + 1, tid, flag);
        } else {
            __syncthreads();
            nxt = cur + 1 < ntiles ? cur + 1 : -1;
        }
        if (nxt >= 0) {
            float* kn = ring + (st ^ 1) * TILE_STAGE;
            stage_rows<TILE_K>(kn, TILE_LD, k, b, M, h, H, nxt * TILE_K, tid);
            stage_rows<TILE_K>(kn + TILE_K * TILE_LD, TILE_HD, v, b, M, h, H, nxt * TILE_K, tid);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this tile's (and Q's) copies have landed
        __syncthreads();
        const float* ks = ring + st * TILE_STAGE;
        const float* vs = ks + TILE_K * TILE_LD;
        const int k0 = cur * TILE_K;

        // S = Q K^T on rows 4 ty + i, keys tx + 16 j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
        for (int d = 0; d < TILE_HD; d += 4) {
            float4 a[4], c[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (4 * ty + i) * TILE_LD + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) c[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * TILE_LD + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
                    s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
                    s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
                    s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
                }
        }
        // logits in the log2 domain by the tile's mask codes: a real key, a masked key (-1e9), past M (weight 0)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int key = k0 + tx + 16 * j;
            const bool in = key < M;
            const bool real = in && mrow[key] != 0;
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][j] = real ? s[i][j] * scale_log2 : (in ? masked : -INFINITY);
        }
        // one rescale a tile: the row max over the row's 16 threads (one half of a warp)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
            for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float mn = fmaxf(m[i], mx);
            const float corr = exp2f(m[i] - mn);
            m[i] = mn;
            l[i] *= corr;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                acc[i][j] *= corr;
                s[i][j] = exp2f(s[i][j] - mn);
                l[i] += s[i][j];
            }
        }
        // P key-major: key tx + 16 j, rows 4 ty .. 4 ty + 3 as one float4
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(ps + (tx + 16 * j) * TILE_LDP + 4 * ty) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncthreads();
        // O += P V on rows 4 ty + i, columns 4 tx .. 4 tx + 3
#pragma unroll 16
        for (int c = 0; c < TILE_K; ++c) {
            const float4 p = *reinterpret_cast<const float4*>(ps + c * TILE_LDP + 4 * ty);
            const float4 w = *reinterpret_cast<const float4*>(vs + c * TILE_HD + 4 * tx);
            const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[i][0] = fmaf(pr[i], w.x, acc[i][0]);
                acc[i][1] = fmaf(pr[i], w.y, acc[i][1]);
                acc[i][2] = fmaf(pr[i], w.z, acc[i][2]);
                acc[i][3] = fmaf(pr[i], w.w, acc[i][3]);
            }
        }
        if (nxt < 0) break;
        cur = nxt;
    }
    // l over the row's 16 threads, then the rows below N
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float li = l[i];
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) li += __shfl_xor_sync(0xffffffffu, li, o);
        const int n = n0 + 4 * ty + i;
        if (n < N) {
            const float inv = 1.f / li;
            *reinterpret_cast<float4*>(out + (((size_t)b * N + n) * H + h) * TILE_HD + 4 * tx) =
                make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
        }
    }
}

extern "C" int attention_f32(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int N,
                             int M, int H, int hd, float scale, void* stream) {
    if (B < 1 || N < 1 || M < 1 || H < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const float* qq = (const float*)q;
    const float* kk = (const float*)k;
    const float* vv = (const float*)v;
    const unsigned char* mm = (const unsigned char*)mask;
    float* oo = (float*)out;
    if (hd == 64) {
        const cudaError_t e =
            cudaFuncSetAttribute(attention_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
        if (e != cudaSuccess) return (int)e;
        const dim3 grid((N + TILE_Q - 1) / TILE_Q, H, B);
        attention_tile_kernel<<<grid, TILE_T, TILE_SMEM, s>>>(qq, kk, vv, mm, oo, N, M, H, scale * LOG2E);
    } else if (hd == 16) {
        const dim3 grid((N + ATT_BQ - 1) / ATT_BQ, H, B);
        attention_row_kernel<16><<<grid, ATT_BQ, 0, s>>>(qq, kk, vv, mm, oo, N, M, H, scale);
    } else if (hd == 48) {
        const dim3 grid((N + ATT_BQ - 1) / ATT_BQ, H, B);
        attention_row_kernel<48><<<grid, ATT_BQ, 0, s>>>(qq, kk, vv, mm, oo, N, M, H, scale);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
