#!/usr/bin/env python3
"""Where K3's time goes on one CUDA card, at the main path's shape.

    python3 k3_probe.py

K3 is mpsfm_tpu_torch/csrc/bini_diag.cu, the deflated PCG of diag(H⁻¹),
here at 8 × 2048 right-hand sides of 145×193, 16 iterations (the inputs
chip_smoke.py makes). The script builds two variants of the source into
mpsfm_tpu_torch/_build/ by text edits (neither is kept or used by the
port):

- `phases`: thread 0 of each CTA adds clock64 deltas per pass and per
  reduction into a device array;
- `no_maps`: the iteration passes read constants in place of the maps
  (wrong values; for its time only).

It prints the card's name and power limit, the kernel's and `no_maps`'s
times taken in turns (kernel, no_maps, no_maps, kernel), the cycles of a
cluster-iteration by phase, and the SASS opcode counts of each pass loop
of the R = 7 instantiation (cuobjdump). It exits 1 without a card.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke

PHASES = ["coarse start", "pass p.Hp", "reduction", "pass r, (HZ)^T M^-1 r", "reduction", "pass r.z", "reduction",
          "pass p", "barrier"]
# the end of each phase of an iteration in csrc/bini_diag.cu, in order
PHASE_ENDS = [
    "s[k] = __fadd_rn(s[k], __fmul_rn(pv[k], hp[k]));\n        });",
    "cluster_sum<3 * R>(s, red, par, cluster, C);",
    "__fmul_rn(h2, v));\n            }\n        });",
    "cluster_sum<3 * R>(g, red, par, cluster, C);",
    "zdot(&c[3 * k], lx, ly))));\n            }\n        });",
    "cluster_sum<3 * R>(s, red, par, cluster, C);",
    "__fmul_rn(beta[k], pv[k]));\n        });",
    "cluster.sync();  // p is read across the band edges",
]
TIMER = '''
__device__ unsigned long long k3_probe_cycles[65536 * 10];
#define PHASE(n) do { if (threadIdx.x == 0) { const long long t_ = clock64(); \\
    k3_probe_cycles[blockIdx.x * 10 + (n)] += t_ - t_last; t_last = t_; } } while (0)
extern "C" int k3_probe_read(void* host, int n) {
    return (int)cudaMemcpyFromSymbol(host, k3_probe_cycles, (size_t)n * 10 * 8);
}
'''
NO_MAPS = [  # (read of the maps in an iteration pass, a constant of the same kind)
    ("const float exr = ex[j], exl = has_l ? ex[j - 1] : 0.f, eyd = ey[j], eyu = has_u ? ey[j - W] : 0.f;\n"
     "        const float pai = pa[j];\n        const float* up",
     "const float exr = 0.1f * j, exl = 0.2f, eyd = 0.3f * lr, eyu = 0.4f;\n"
     "        const float pai = 1.0f + col;\n        const float* up"),
    ("const float mi = minv[j], h0 = hz0[j], h1 = hz1[j], h2 = hz2[j];",
     "const float mi = 0.5f * j, h0 = 1.f, h1 = 0.5f * col, h2 = 0.25f * lr;"),
    ("            const float mi = minv[j], lx = lin_x[col], ly = lin_y[r0 + lr];",
     "            const float mi = 0.5f * j, lx = 0.1f * col, ly = 0.2f * lr;"),
]


def _edit(src, old, new, count):
    if src.count(old) != count:
        raise RuntimeError(f"csrc/bini_diag.cu changed: {count} x {old[:60]!r} expected")
    return src.replace(old, new)


def variants(src):
    """The sources of the `phases` and `no_maps` builds."""
    ph = _edit(src, "__device__ __forceinline__ float guard", TIMER + "__device__ __forceinline__ float guard", 1)
    ph = _edit(ph, "    int par = 0;\n", "    int par = 0;\n    long long t_last = clock64();\n", 1)
    loop = ph.index("    for (int it = 0; it < iters; ++it) {")
    head, body = ph[:loop] + "    PHASE(0);\n", ph[loop:]
    at = 0
    for n, end in enumerate(PHASE_ENDS, 1):
        at = body.index(end, at) + len(end)
        body = body[:at] + f"\n        PHASE({n});" + body[at:]
    loop = src.index("    auto hp_all")
    head_nm, body_nm = src[:loop], src[loop:]
    for old, new in NO_MAPS:
        body_nm = _edit(body_nm, old, new, 2 if "lin_x[col]" in old else 1)
    return head + body, head_nm + body_nm


def sass_loops(lib, prefix):
    """(instruction count, opcode counts) of each loop with an FMUL (the
    pixel passes), in program order, of the function whose mangled name
    starts with prefix."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", sass)
    sass = next(f for f in funcs if f.startswith(prefix))
    ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    index = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, text) in enumerate(ins):
        m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in index:
            body = ins[index[int(m.group(1), 16)]:i + 1]
            ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for _, t in body)
            if ops["FMUL"] and len(body) < 2000:
                loops.append((len(body), ops))
    return loops


def main():
    import torch

    if not torch.cuda.is_available():
        print("k3_probe: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import convert, kernels
    from mpsfm_tpu_torch.ba.covariance import point_covariances
    from mpsfm_tpu_torch.integration import bini_diag

    print(chip_smoke.card_line())
    src = bini_diag.KERNEL.source.read_text()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built = {}
    for name, text in zip(("phases", "no_maps"), variants(src)):
        path = kernels.BUILD_DIR / f"k3_probe_{name}.cu"
        path.write_text(text)
        sig = dict(bini_diag.KERNEL.signatures, **({"k3_probe_read": [kernels.P, kernels.I]} if name == "phases" else {}))
        built[name] = kernels.Kernel(f"k3probe_{name}", path, sig)
    kernels.build_all([bini_diag.KERNEL, *built.values()])

    dev = torch.device("cuda:0")
    inputs = chip_smoke.make_inputs(**chip_smoke.FULL)
    cov = point_covariances(convert.ba_data(inputs.ba, device=dev))
    st, dfl, rows, cols, iters = chip_smoke.k3_inputs(inputs.priors, cov, dev)
    Bn, H, W = dfl.minv.shape
    pl = bini_diag.plan(H, W)
    rp, cp = bini_diag.pad_queries(rows, cols, pl.R)
    r32, c32 = (t.to(torch.int32).contiguous() for t in (rp, cp))
    maps = [t.contiguous() for t in (st.ex, st.ey, st.pa, dfl.minv, dfl.hz, dfl.einv, dfl.lin_x, dfl.lin_y)]

    def run(k):  # the shared-memory mode (the main path's plan), one cluster a group
        out = torch.empty(rp.shape, device=dev)
        k.call("bini_diag_pcg", *[t.data_ptr() for t in maps], r32.data_ptr(), c32.data_ptr(), out.data_ptr(), None,
               iters, Bn, H, W, rp.shape[1], pl.C, pl.R, 0, Bn * rp.shape[1] // pl.R, kernels.stream_ptr(out))
        return out

    times = {"kernel": [], "no_maps": []}
    for name in ("kernel", "no_maps", "no_maps", "kernel"):
        k = bini_diag.KERNEL if name == "kernel" else built["no_maps"]
        times[name].append(chip_smoke.cuda_ms(lambda: run(k), 3))
    print(f"K3 at B={Bn} {H}x{W}, {rows.shape[1]} queries a lane, {iters} iterations, C={pl.C} R={pl.R}: "
          + "; ".join(f"{n} {' '.join(f'{t:.3f}' for t in ts)} ms" for n, ts in times.items()))

    n_cta = Bn * rp.shape[1] // pl.R * pl.C
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    run(built["phases"])  # its one run: the counters start at 0
    e1.record()
    e1.synchronize()
    cycles = np.zeros(n_cta * 10, np.uint64)
    built["phases"].call("k3_probe_read", cycles.ctypes.data, n_cta)
    per_cta = cycles.reshape(n_cta, 10)[:, :len(PHASES)].astype(np.float64).mean(0)
    per_iter = per_cta[1:] / iters
    waves = n_cta / pl.C / bini_diag.active_clusters(H, W, dev)
    print(f"cycles a cluster-iteration (thread 0 of each CTA, mean of {n_cta} CTAs): {per_iter.sum():.0f}; coarse "
          f"start {per_cta[0]:.0f} once; {e0.elapsed_time(e1):.3f} ms for {waves:.1f} waves of co-resident clusters, "
          f"{per_cta.sum() * waves / e0.elapsed_time(e1) / 1e6:.3f} GHz implied")
    for name, c in zip(PHASES[1:], per_iter):
        print(f"  {name:24s} {c:8.0f}")

    loops = sass_loops(str(bini_diag.KERNEL._target()), f"_Z16bini_diag_kernelILi{pl.R}ELb0EE")
    names = ["coarse start, r", "coarse start, p", "pass p.Hp", "pass r, (HZ)^T M^-1 r", "pass r.z", "pass p"]
    for name, (n, ops) in zip(names, loops):
        fp = ops["FADD"] + ops["FMUL"]
        print(f"SASS R={pl.R} {name:22s} {n:4d} instructions a pixel, {fp} FADD/FMUL, {ops['LDS'] + ops['STS']} "
              f"LDS/STS, {ops['LD']} LD (generic), {ops['LDG']} LDG")
    it = loops[2:6]
    print(f"SASS R={pl.R} an iteration: {sum(n for n, _ in it)} instructions a pixel, "
          f"{sum(o['FADD'] + o['FMUL'] for _, o in it)} of them FADD/FMUL")
    return 0


if __name__ == "__main__":
    sys.exit(main())
