// K4: masked multi-head attention out = softmax(q k^T * scale) v of LightGlue.
//
// Replaces the TPU kernel behind LightGlue._attention
// (mpsfm_tpu/extraction/matchers/lightglue.py:322; MPSFM_LG_ATTN=pallas calls
// JAX's TPU flash_attention, whose pallas_call is the kernel, :364-388). The
// function is the JAX package's einsum path (:389-391): logits = q.k * scale,
// a masked key's logit replaced by -1e9, softmax over the keys, the product
// with v. q is (B, N, H, HD), k and v (B, M, H, HD), the key mask (B, M) one
// byte a key (nonzero = a real key), out (B, N, H, HD), all contiguous.
// LightGlue calls it with HD = 64 (the official 256 = 4 x 64) in its self
// blocks (N = M) and cross blocks (N != M in general); HD = 16 is the tests'
// LightGlue (64 = 4 x 16).
//
// Design: the flash algorithm, not the TPU kernel's blocks. One CTA of 64
// threads per (query tile of 64, head, batch element); a thread owns one query
// row: its q and its float32 accumulator in registers, its running max m and
// sum l. The keys go by tiles of 64: each tile's mask is staged first, and a
// tile without a real key is skipped whenever the batch element has one (a
// masked key's weight exp(-1e9 - m) is then exactly 0, so the result is the
// same; LightGlue pads its keypoints at the end, so the skipped tiles are the
// padding past the last real key). The other tiles' K and V rows are staged
// in shared memory, and every thread reads them as float4 broadcasts. Within a
// tile a thread takes 8 keys at a time: their 8 logits, one rescale of (l,
// acc) by exp(m_old - m_new), then the 8 keys' p v added. A masked key gets
// -1e9 as in the plain version, so a row whose first tile is all masked (only
// when every key of the batch element is) keeps a finite running max (-1e9);
// a key past M gets -inf and weight 0 (every tile holds at least one key below
// M, so the max stays finite). Padded query rows are computed like any other
// (they attend the real keys) and finite; rows past N are not written.
// Float32 in and out, all arithmetic float32; the wrapper gives bfloat16
// operands to it as their float32 values and rounds the result.
//
// What bounds it on the H100: 4 B H N M' HD FLOP (two products of N x M' x HD
// FMA, M' the real keys) against 67 TFLOP/s of float32 outside the tensor
// cores; at N = M' = 8192, H = 4, HD = 64 that is 68.7 GFLOP, 1.03 ms, while
// the bytes (q, k, v and out, 33.6 MB in float32) take 10 us. So operations
// bound it. This first kernel runs the FMAs in float32 on the CUDA cores, one
// shared-memory float4 read per 4 FMA: no tensor cores (bf16 wgmma), no TMA,
// no warp specialisation; those are later work.

#include <cuda_runtime.h>

#define ATT_BQ 64  // query rows of a CTA, one a thread
#define ATT_BK 64  // keys of a staged tile
#define ATT_CH 8   // keys between two rescales of the accumulator

template <int HD>
__global__ void __launch_bounds__(ATT_BQ) attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                                           const float* __restrict__ v,
                                                           const unsigned char* __restrict__ mask,
                                                           float* __restrict__ out, int N, int M, int H, float scale) {
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

extern "C" int attention_f32(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int N,
                             int M, int H, int hd, float scale, void* stream) {
    if (B < 1 || N < 1 || M < 1 || H < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + ATT_BQ - 1) / ATT_BQ, H, B);
    const cudaStream_t s = (cudaStream_t)stream;
    const float* qq = (const float*)q;
    const float* kk = (const float*)k;
    const float* vv = (const float*)v;
    const unsigned char* mm = (const unsigned char*)mask;
    float* oo = (float*)out;
    if (hd == 64)
        attention_kernel<64><<<grid, ATT_BQ, 0, s>>>(qq, kk, vv, mm, oo, N, M, H, scale);
    else if (hd == 16)
        attention_kernel<16><<<grid, ATT_BQ, 0, s>>>(qq, kk, vv, mm, oo, N, M, H, scale);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
