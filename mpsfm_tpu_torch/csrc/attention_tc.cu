// K4, tensor-core route: LightGlue's masked multi-head attention
// out = softmax(q k^T * scale) v on bfloat16 operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel behind LightGlue._attention
// (mpsfm_tpu/extraction/matchers/lightglue.py:322; MPSFM_LG_ATTN=pallas calls
// JAX's TPU flash_attention, whose pallas_call is the kernel, :364-388) for the
// bfloat16 operands LightGlue runs by default (lightglue.py:87-90); float32
// operands (the parity setting) stay on csrc/attention.cu. The function is
// the float32 kernel's: logits = q.k * scale, a masked key's logit -1e9, a key
// past M -inf (weight 0), softmax over the keys, the product with v; a batch
// element without a real key weighs all of its M keys equally; padded query
// rows stay finite and rows past N are not written. q is (B, N, H, HD), k and
// v (B, M, H, HD), out (B, N, H, HD), all contiguous bfloat16; the key mask
// (B, M) one byte a key (nonzero = a real key). HD = 64 (the official
// LightGlue) or 16 (the tests').
//
// The one change in arithmetic: P is rounded to bfloat16 as the A operand of
// P.V, as the JAX package's bfloat16 paths do (lightglue.py:312,
// pmat.astype(v.dtype)). Logits, the running max and sum, and the output
// accumulator are float32; the result is rounded once to bfloat16.
//
// Design (the flash algorithm on wgmma and TMA). One CTA takes 128 queries of
// one (batch element, head): two consumer warpgroups of 64 query rows each and
// one producer warp. The producer stages the Q tile once by TMA, then K and V
// tiles of 64 keys through a ring of TC_STAGES stages, each with a "full"
// mbarrier (TMA's transaction bytes) and an "empty" one (one arrival a
// consumer warp). The tensor maps are 4-D over the (B, L, H, HD) tensors, box
// {HD, 1, rows, 1}, so a tile is rows of HD bfloat16 with no transpose copy,
// swizzled 128 B at HD 64 (one row) and 32 B at HD 16 (one row); TMA fills
// keys past M and queries past N with zeros. S = Q.K^T is
// wgmma m64n64k16 with both operands K-major in shared memory (HD / 16
// k-steps); the online softmax runs on S in registers in the log2 domain (a
// row sits in a quad of lanes: two xor shuffles for its max; the sum is kept
// per thread and reduced once at the end); the mask codes are applied only on
// a tile that mixes real and other keys. P, converted to bf16x2 in
// registers, is the A operand of O += P.V (wgmma m64nHDk16, A from registers:
// the accumulator's fragment layout is the A fragment's, so no shuffle), with
// V an MN-major B operand read through the transpose bit. Key tiles without a
// real key are skipped whenever the batch element has one (their weights are
// exactly 0), as in the float32 kernel: every thread reads one bit mask a
// tile, built once per CTA from the key mask.
//
// What bounds it on the H100: 4 B H N M' HD FLOP (M' the real keys) at 989
// TFLOP/s of bfloat16 tensor cores; at N = 8192, H = 4, HD = 64, 4 pairs of
// 4942 real keys that is 165.8 GFLOP, 0.168 ms, against 34 MB of operands
// (10 us). At HD 64 the softmax's one exp2 per logit takes the SM's 16 MUFU
// lanes as long as the two products take its tensor cores, so the design
// keeps two CTAs (four consumer warpgroups) on an SM, whose products and
// softmaxes overlap; no ping-pong scheduling, no persistent CTAs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TC_BK 64                        // keys of a staged tile
#define TC_WG 2                         // consumer warpgroups, 64 query rows each
#define TC_BQ (64 * TC_WG)              // query rows of a CTA
#define TC_STAGES 3                     // K/V ring depth
#define TC_MINB 2                       // CTAs an SM the registers are sized for (96 a thread)
#define TC_THREADS (128 * TC_WG + 32)   // the consumers and one producer warp
#define TC_LOG2E 1.4426950408889634f
#define TC_MASKED (-1e9f * TC_LOG2E)    // a masked key's logit -1e9, in the log2 domain

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
        "[%2];" ::"r"(dst),
        "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// keep the compiler from moving accumulator accesses across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a tile of rows of RB bytes (RB = 128: 128 B
// swizzle, layout type 1; RB = 32: 32 B swizzle, type 3), 8-row groups RB * 8
// bytes apart (the stride byte offset). The leading byte offset is unused by
// these layouts (one swizzle atom along the contiguous dimension); it is set to
// the same stride.
template <int RB>
__device__ __forceinline__ uint64_t smem_desc(uint32_t saddr) {
    static_assert(RB == 128 || RB == 32, "row bytes");
    constexpr uint64_t layout = RB == 128 ? 1 : 3;
    constexpr uint64_t group = (uint64_t)(RB * 8) >> 4;
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | (group << 16) | (group << 32) | (layout << 62);
}

// S (64 x 64, float32) (+)= A (64 x 16, K-major in shared memory) . B (16 x 64, K-major in shared memory)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 64, float32) += A (64 x 16, bf16x2 registers) . B (16 x 64, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 16, float32) += A (64 x 16, bf16x2 registers) . B (16 x 16, MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (HD == 64)
        wgmma_rs_n64(d, a, db);
    else
        wgmma_rs_n16(d, a, db);
}

__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low 16 bits
    return *reinterpret_cast<const uint32_t*>(&p);
}

}  // namespace

// Dynamic shared memory, from a 1024-byte aligned base: Q (TC_BQ rows), K and V
// (TC_STAGES tiles of TC_BK rows each), then one 64-bit real-key mask a key tile.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, TC_MINB)
    attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const unsigned char* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out, int N, int M, int H, float scale_log2) {
    constexpr int RB = HD * 2;                     // bytes of a row
    constexpr uint32_t Q_BYTES = TC_BQ * RB;
    constexpr uint32_t TILE_BYTES = TC_BK * RB;
    constexpr int NO = HD / 2;                     // output accumulator floats a thread
    static_assert(HD == 64 || HD == 16, "head width");
    __shared__ __align__(8) uint64_t bars[1 + 2 * TC_STAGES];  // Q; full[s]; empty[s]
    extern __shared__ unsigned char smem_raw[];

    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
    const uint32_t sQ = raw + pad, sK = sQ + Q_BYTES, sV = sK + TC_STAGES * TILE_BYTES;
    uint64_t* tile_bits = reinterpret_cast<uint64_t*>(smem_raw + pad + Q_BYTES + 2 * TC_STAGES * TILE_BYTES);
    const uint32_t qbar = smem_u32(&bars[0]);
    auto full = [&](int s) { return smem_u32(&bars[1 + s]); };
    auto empty = [&](int s) { return smem_u32(&bars[1 + TC_STAGES + s]); };

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TC_BQ;
    if (tid == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < TC_STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 4 * TC_WG);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // the key tiles' real-key masks; a batch element with no real key skips no tile
    const int ntiles = (M + TC_BK - 1) / TC_BK;
    const unsigned char* mrow = mask + (size_t)b * M;
    int any_real = 0;
    for (int t = warp; t < ntiles; t += TC_THREADS / 32) {
        const int k0 = t * TC_BK;
        const uint32_t lo = __ballot_sync(~0u, k0 + lane < M && mrow[k0 + lane]);
        const uint32_t hi = __ballot_sync(~0u, k0 + 32 + lane < M && mrow[k0 + 32 + lane]);
        if (lane == 0) tile_bits[t] = ((uint64_t)hi << 32) | lo;
        any_real |= (lo | hi) != 0;
    }
    const bool skip_masked = __syncthreads_or(any_real);

    if (warp == 4 * TC_WG) {  // the producer warp: one thread issues every copy
        if (lane == 0) {
            mbar_expect_tx(qbar, Q_BYTES);
            tma_load_4d(sQ, &tm_q, qbar, 0, h, q0, b);
            int stage = 0;
            uint32_t phase = 0;
            for (int t = 0; t < ntiles; ++t) {
                if (skip_masked && tile_bits[t] == 0) continue;
                mbar_wait(empty(stage), phase ^ 1);  // the first round passes at once
                mbar_expect_tx(full(stage), 2 * TILE_BYTES);
                tma_load_4d(sK + stage * TILE_BYTES, &tm_k, full(stage), 0, h, t * TC_BK, b);
                tma_load_4d(sV + stage * TILE_BYTES, &tm_v, full(stage), 0, h, t * TC_BK, b);
                if (++stage == TC_STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // a consumer warpgroup: query rows 64 wg .. 64 wg + 63 of the tile; this thread holds rows
    // r0 = 16 (warp % 4) + lane / 4 and r0 + 8, columns 8 i + 2 (lane % 4) + {0, 1}
    const int wg = warp >> 2, quad = lane & 3;
    const uint32_t q_tile = sQ + wg * 64 * RB;
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(qbar, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < ntiles; ++t) {
        const uint64_t bits = tile_bits[t];
        if (skip_masked && bits == 0) continue;
        mbar_wait(full(stage), phase);
        const uint32_t k_tile = sK + stage * TILE_BYTES, v_tile = sV + stage * TILE_BYTES;
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)  // 16 columns = 32 bytes a k-step, inside the swizzled rows
            wgmma_ss_n64(s, smem_desc<RB>(q_tile + kk * 32), smem_desc<RB>(k_tile + kk * 32), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

        // On a tile of real keys only, the maxima are taken on the raw logits and each weight is one FFMA
        // and one exp2 (scale_log2 > 0); a tile mixing real keys with masked keys or keys past M is put in
        // the log2 domain first, with the masked keys' and the absent keys' codes.
        const bool full = bits == ~0ull;
        if (!full) {
            const int k0 = t * TC_BK;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
                s[i] = (bits >> col) & 1 ? s[i] * scale_log2 : (k0 + col < M ? TC_MASKED : -INFINITY);
            }
        }
        float x0 = -INFINITY, x1 = -INFINITY;  // this tile's row maxima (row r0: i % 4 < 2, row r0 + 8: the rest)
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
            x0 = fmaxf(x0, fmaxf(s[i], s[i + 1]));
            x1 = fmaxf(x1, fmaxf(s[i + 2], s[i + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            x0 = fmaxf(x0, __shfl_xor_sync(~0u, x0, off));
            x1 = fmaxf(x1, __shfl_xor_sync(~0u, x1, off));
        }
        if (full) {
            x0 *= scale_log2;
            x1 *= scale_log2;
        }
        // every processed tile holds a key below M, so the new maxima are finite
        const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
        const float c0 = fast_exp2(m0 - n0), c1 = fast_exp2(m1 - n1);
        m0 = n0;
        m1 = n1;
        const float a0 = full ? scale_log2 : 1.f;  // weight = exp2(a s - n)
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
            s[i] = fast_exp2(fmaf(s[i], a0, -n0));
            s[i + 1] = fast_exp2(fmaf(s[i + 1], a0, -n0));
            s[i + 2] = fast_exp2(fmaf(s[i + 2], a0, -n1));
            s[i + 3] = fast_exp2(fmaf(s[i + 3], a0, -n1));
            p0 += s[i] + s[i + 1];
            p1 += s[i + 2] + s[i + 3];
        }
        l0 = l0 * c0 + p0;
        l1 = l1 * c1 + p1;
        if (__any_sync(~0u, c0 != 1.f || c1 != 1.f)) {  // a row's maximum moved: rescale the warp's outputs
#pragma unroll
            for (int i = 0; i < NO; i += 4) {
                o[i] *= c0;
                o[i + 1] *= c0;
                o[i + 2] *= c1;
                o[i + 3] *= c1;
            }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {  // keys 16 kk .. 16 kk + 15: S's columns as P's A fragment
            const uint32_t a[4] = {pack_bf16x2(s[8 * kk], s[8 * kk + 1]), pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]),
                                   pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]),
                                   pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7])};
            wgmma_rs<HD>(o, a, smem_desc<RB>(v_tile + kk * 16 * RB));  // 16 key rows a k-step
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        if (lane == 0) mbar_arrive(empty(stage));
        if (++stage == TC_STAGES) {
            stage = 0;
            phase ^= 1;
        }
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(~0u, l0, off);
        l1 += __shfl_xor_sync(~0u, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r0 = q0 + wg * 64 + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int n = r0 + 8 * half;
        if (n >= N) continue;
        const float inv = half ? inv1 : inv0;
        __nv_bfloat16* op = out + (((size_t)b * N + n) * H + h) * HD + 2 * quad;
#pragma unroll
        for (int i = 0; i < NO; i += 4) {
            const uint32_t pr = pack_bf16x2(o[i + 2 * half] * inv, o[i + 2 * half + 1] * inv);
            *reinterpret_cast<uint32_t*>(op + 8 * (i >> 2)) = pr;
        }
    }
}

namespace {

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library needs no -lcuda
EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t rc =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
    }
    return fn;
}

// the 4-D map of a contiguous (B, L, H, hd) bfloat16 tensor, box {hd, 1, rows, 1}
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int hd, int rows) {
    const EncodeTiledFn encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)H * hd * 2, (cuuint64_t)L * H * hd * 2};
    const cuuint32_t box[4] = {(cuuint32_t)hd, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUtensorMapSwizzle swz = hd == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const unsigned char* mask, __nv_bfloat16* out, int B, int N,
           int M, int H, float scale, cudaStream_t s) {
    CUtensorMap mq, mk, mv;
    if (!make_map(&mq, q, B, N, H, HD, TC_BQ) || !make_map(&mk, k, B, M, H, HD, TC_BK) ||
        !make_map(&mv, v, B, M, H, HD, TC_BK))
        return (int)cudaErrorInvalidValue;
    const int ntiles = (M + TC_BK - 1) / TC_BK;
    const size_t smem = 1024 + (size_t)TC_BQ * HD * 2 + 2 * (size_t)TC_STAGES * TC_BK * HD * 2 + 8 * (size_t)ntiles;
    // the dynamic shared memory this instantiation may take on each device, raised as needed
    static size_t allowed[64] = {};
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (smem > allowed[dev]) {
        rc = cudaFuncSetAttribute(attention_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (rc != cudaSuccess) return (int)rc;
        allowed[dev] = smem;
    }
    const dim3 grid((N + TC_BQ - 1) / TC_BQ, H, B);
    attention_tc_kernel<HD><<<grid, TC_THREADS, smem, s>>>(mq, mk, mv, mask, out, N, M, H, scale * TC_LOG2E);
    return (int)cudaGetLastError();
}

}  // namespace

// q, k, v and out 16-byte aligned (TMA's rule for a global address); scale > 0
extern "C" int attention_bf16(const void* q, const void* k, const void* v, const void* mask, void* out, int B, int N,
                              int M, int H, int hd, float scale, void* stream) {
    if (B < 1 || N < 1 || M < 1 || H < 1 || B > 65535 || H > 65535 || !(scale > 0.f))
        return (int)cudaErrorInvalidValue;
    const unsigned char* mm = (const unsigned char*)mask;
    __nv_bfloat16* oo = (__nv_bfloat16*)out;
    const cudaStream_t s = (cudaStream_t)stream;
    if (hd == 64) return launch<64>(q, k, v, mm, oo, B, N, M, H, scale, s);
    if (hd == 16) return launch<16>(q, k, v, mm, oo, B, N, M, H, scale, s);
    return (int)cudaErrorInvalidValue;
}
