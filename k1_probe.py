#!/usr/bin/env python3
"""K1's grid route on one CUDA card: where a panel's time goes, and the
variants of its serial steps, in turns.

    python3 k1_probe.py

K1's grid route is chol_grid_kernel of mpsfm_tpu_torch/csrc/cholesky.cu:
per 32-wide panel, the panel solve split by rows over the CTAs, a grid
barrier, the trailing update in 64 × 64 tiles (the corner tile's CTA then
factors the next diagonal block, grid_factor), a grid barrier; before the
loop the transpose of S and the first diagonal block, after it the
backward substitution, block q of x by CTA q mod G. The script builds copies of the source
with %globaltimer stamps (ns, one clock for every SM) written by each
CTA's thread 0 at those points (text edits; each copy is its own library
in mpsfm_tpu_torch/_build/, which the port never loads): the source as it
is and each of VARIANTS. It runs each at each K of chip_smoke.K1_TIMED_K
(the variants at 1024 and 3072), holds its x bit-equal to the route's own,
and prints per run: the kernel's wall by the stamps, the transpose + first
block, the backward substitution, and per panel (means over the panels)
the panel solve (from the first CTA's start to the last one's arrival),
each barrier (from the last CTA's arrival to the last CTA's exit), the
corner tile, the diagonal block (grid_factor, and its factorization
apart), and the other CTAs' tiles (slowest CTA). The device ms of the
unstamped source (CUDA events) are printed beside. It prints the card's
name and power limit first and exits 1 without a card.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

import chip_smoke

PANELS, CTAS, SLOTS = 128, 132, 8  # stamps a (panel, CTA)

# (anchor in the grid route's code, the text that replaces it); K1P(p, s) stamps slot s of panel p: 0 the
# panel solve's start, 1 the first barrier's arrival, 2 its exit, 3 the corner tile's end (CTA 0), 4
# grid_factor's end (CTA 0), 5 the second barrier's arrival; 6 and 7 grid_factor's loads' end and its
# factorization's end (at the row of its block, c0 / 32); of panel PANELS_END: 0 the kernel's start, 1 the
# first barrier's arrival, 2 the loop's end, 3 the CTA's backward substitution's end
BAR = "grid_barrier(a.bar, target += G);\n"
STAMPS = [
    ("    unsigned target = 0;\n", "    unsigned target = 0;\n    K1P(PANELS_END, 0);\n"),
    (f"    {BAR}\n    for (int c0 = 0;; c0 += CHOL_NB) {{", f"    K1P(PANELS_END, 1);\n    {BAR}\n"
     "    for (int c0 = 0;; c0 += CHOL_NB) {"),
    ("        // ---- panel solve: rows [lo, hi) of L21, a thread a row ----\n",
     "        // ---- panel solve: rows [lo, hi) of L21, a thread a row ----\n        K1P(c0 / CHOL_NB, 0);\n"),
    (f"        {BAR}\n        // ---- trailing update", f"        K1P(c0 / CHOL_NB, 1);\n        {BAR}"
     "        K1P(c0 / CHOL_NB, 2);\n\n        // ---- trailing update"),
    ("                if (n == 0) {  // the corner: factor the next diagonal block, which it left in D\n",
     "                if (n == 0) K1P(c0 / CHOL_NB, 3);\n"
     "                if (n == 0) {  // the corner: factor the next diagonal block, which it left in D\n"),
    ("                    if (warp == 0) grid_factor_block<SOLVE>(a, r0, nb1, yv1, D);\n",
     "                    if (warp == 0) grid_factor_block<SOLVE>(a, r0, nb1, yv1, D);\n"
     "                    K1P(c0 / CHOL_NB, 4);\n"),
    (f"        {BAR}    }}\n", f"        K1P(c0 / CHOL_NB, 5);\n        {BAR}    }}\n"),
    ("    for (int k = 0; k < CHOL_NB; ++k) r[k] = D[lane][k];\n",
     "    for (int k = 0; k < CHOL_NB; ++k) r[k] = D[lane][k];\n    K1P(c0 / CHOL_NB, 6);\n"),
    ("        if (k <= lane && (kFull || lane < nb)) Wd[k * ld + lane] = r[k];\n",
     "        if (k <= lane && (kFull || lane < nb)) Wd[k * ld + lane] = r[k];\n    K1P(c0 / CHOL_NB, 7);\n"),
    ("    if (!SOLVE || warp != 0) return;\n", "    K1P(PANELS_END, 2);\n    if (!SOLVE || warp != 0) return;\n"),
    ("grid_backward_block(a, q, nblk, lane);\n", "grid_backward_block(a, q, nblk, lane);\n    K1P(PANELS_END, 3);\n"),
]

# The grid route's serial steps as they were tried, each a set of (old, new) text edits of the source:
# grid_factor's updates predicated on lane >= k (factor_diag's form), its column broadcast by shuffles
# instead of shared memory, and grid_factor inlined into the kernel
UPDATE = "            for (int k = j + 1; k < CHOL_NB; ++k) r[k] -= l * col[j & 1][k];\n"
VARIANTS = {
    "grid_factor predicated": [(UPDATE, UPDATE.replace("r[k] -=", "if (lane >= k) r[k] -="))],
    "grid_factor shuffles": [("            col[j & 1][lane] = l;\n            __syncwarp();\n#pragma unroll\n" + UPDATE,
                              "#pragma unroll\n            for (int k = j + 1; k < CHOL_NB; ++k) "
                              "r[k] -= l * __shfl_sync(FULL, l, k);\n")],
    "grid_factor inlined": [("__device__ __noinline__ void grid_factor(", "__device__ __forceinline__ void grid_factor(")],
}

HEADER = f"""
#define K1P_PANELS {PANELS}
#define K1P_CTAS {CTAS}
#define PANELS_END (K1P_PANELS - 1)
__device__ unsigned long long k1_probe_buf[K1P_PANELS * K1P_CTAS * {SLOTS}];
__device__ __forceinline__ unsigned long long k1p_now() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}}
#define K1P(p, s) \\
    if (threadIdx.x == 0) k1_probe_buf[((p) * K1P_CTAS + blockIdx.x) * {SLOTS} + (s)] = k1p_now();
"""

READER = """
extern "C" int k1_probe_read(void* host, int n) {
    return (int)cudaMemcpyFromSymbol(host, k1_probe_buf, (size_t)n * sizeof(unsigned long long));
}
"""


def edited(src, edits):
    """The source with each (old, new) of edits made once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"csrc/cholesky.cu changed: {old!r} found {src.count(old)} times")
        src = src.replace(old, new)
    return src


def stamped_source(src):
    """The source with the stamps of STAMPS in its grid route's code."""
    head, grid = src.split("struct GridArgs {", 1)
    return (head.replace("#include <stdint.h>", "#include <stdint.h>\n" + HEADER) + "struct GridArgs {"
            + edited(grid, STAMPS) + READER)


def phases(buf, K, G):
    """The stamps of one run at K on G CTAs, in µs: the kernel, the
    transpose + first block, the loop, the backward substitution, and
    per-panel means of each step."""
    t = buf.reshape(PANELS, CTAS, SLOTS)[:, :G].astype(np.float64) / 1e3
    end = t[PANELS - 1]
    npan = (K + 31) // 32 - 1  # panels with a trailing update
    start = end[:, 0].min()
    rows = []
    for p in range(npan):
        s = t[p]
        f = t[p + 1][0]  # grid_factor's stamps of the next block
        bar2 = t[p + 1][:, 0].max() - s[:, 5].max() if p + 1 < npan else np.nan
        rows.append((s[:, 1].max() - s[:, 0].min(), s[:, 2].max() - s[:, 1].max(), s[0, 3] - s[0, 2],
                     s[0, 4] - s[0, 3], f[7] - f[6], (s[1:, 5] - s[1:, 2]).max() if G > 1 else 0.0, bar2))
    r = np.array(rows)
    names = ("solve", "bar1", "corner", "factor", "f_chol", "others", "bar2")
    return dict(kernel=end[:, 3].max() - start, first=end[:, 1].max() - start, loop=end[:, 2].max() - end[:, 1].max(),
                backward=end[:, 3].max() - end[:, 2].max(),
                **{n: float(np.nanmean(r[:, i])) for i, n in enumerate(names)})


def main():
    import torch

    if not torch.cuda.is_available():
        print("k1_probe: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.ba import cholesky

    print(chip_smoke.card_line())
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cholesky.KERNEL.source.read_text()
    built = {}
    for name, edits in (("as built", []), *VARIANTS.items()):
        tag = "".join(ch if ch.isalnum() else "_" for ch in name)
        path = kernels.BUILD_DIR / f"k1_probe_{tag}.cu"
        path.write_text(stamped_source(edited(src, edits)))
        built[name] = kernels.Kernel(f"k1probe_{tag}", path,
                                     {**cholesky.KERNEL.signatures, "k1_probe_read": [kernels.P, kernels.I]})
    kernels.build_all([*built.values(), cholesky.KERNEL])
    for name, k in built.items():
        log = k.build_log.splitlines()
        for i, ln in enumerate(log):
            if "Compiling entry" in ln and "chol_grid_kernelILb1" in ln:
                print(f"{name}: " + " ".join(x.strip() for x in log[i + 1:i + 3] if "spill" in x or "registers" in x))
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(chip_smoke.SEED)
    kept = cholesky.KERNEL
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for K in chip_smoke.K1_TIMED_K:
        A = rng.normal(size=(K, K)).astype(np.float32)
        S = torch.as_tensor(A @ A.T + K * np.eye(K, dtype=np.float32), device=dev)
        b = torch.as_tensor(rng.normal(size=K).astype(np.float32), device=dev)
        x = cholesky.solve_on_route(S, b, True)
        ms = chip_smoke.cuda_ms(lambda: cholesky.solve_on_route(S, b, True), 20)
        nt = (K - 32 + 63) // 64
        G = min(sms, max(1, nt * (nt + 1) // 2))
        for name in (built if K in (1024, 3072) else ["as built"]):
            runs = []
            cholesky.KERNEL = built[name]
            try:
                for _ in range(5):
                    xp = cholesky.solve_on_route(S, b, True)
                    torch.cuda.synchronize()
                    buf = np.zeros(PANELS * CTAS * SLOTS, np.uint64)
                    built[name].call("k1_probe_read", buf.ctypes.data_as(ctypes.c_void_p), buf.size)
                    runs.append(phases(buf, K, G))
                    if not torch.equal(xp, x):
                        raise AssertionError(f"{name}: the stamped kernel's x differs from the route's at K={K}")
            finally:
                cholesky.KERNEL = kept
            med = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
            print(f"K1 grid route K={K}, {name} ({G} CTAs, {(K + 31) // 32 - 1} panels with a trailing update; "
                  f"medians of 5 stamped runs, µs): kernel {med['kernel']:.1f} (the source unstamped, CUDA events: "
                  f"{ms * 1e3:.1f}); transpose + first block {med['first']:.1f}; panel loop {med['loop']:.1f}; "
                  f"backward substitution {med['backward']:.1f}; per panel: panel solve {med['solve']:.2f}, barrier "
                  f"{med['bar1']:.2f}, corner tile {med['corner']:.2f}, diagonal block {med['factor']:.2f} (of it "
                  f"the factorization {med['f_chol']:.2f}), other CTAs' tiles {med['others']:.2f}, barrier "
                  f"{med['bar2']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
