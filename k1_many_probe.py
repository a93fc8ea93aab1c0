#!/usr/bin/env python3
"""K1 with many right-hand sides on one CUDA card: its substitution's tile
shape, variant against variant.

    python3 k1_many_probe.py

K1 many is mpsfm_tpu_torch/csrc/cholesky_many.cu (the point covariances'
solve X = S⁻¹B). Its substitution gives each thread a TM × 4 block of a
32 × NT block of results, and lays the threads of a warp out as
(32 / WX) × WX blocks; TM and WX set how many shared-memory loads and
wavefronts feed each FMA. The script builds the source as it is and with
the other (TM, WX) of {2, 4} × {8, 16} by text edits, each its own library
in mpsfm_tpu_torch/_build/ (none is used by the port), checks each against
the plain version at K = 384, N = 24 576 (the main path's shape) and at
K = 390, N = 1000 (ragged) by chip_smoke.py's bounds, and times them in
turns (each variant twice, in the order a b c d d c b a): the whole call
(CUDA events) and its substitution kernel alone (torch.profiler). It
prints the card's name and power limit, ptxas's registers and spills of
each substitution kernel, and a line per variant. It exits 1 without a
card.
"""

from __future__ import annotations

import re
import sys

import numpy as np

import chip_smoke

VARIANTS = [(2, 16), (2, 8), (4, 8), (4, 16)]  # (TM, WX)


def variant_source(src, csrc, tm, wx):
    """The source with SUB_TM = tm and SUB_WX = wx, including cholesky.cu by
    its absolute path (the variant is written outside csrc/)."""
    out = src.replace('#include "cholesky.cu"', f'#include "{csrc / "cholesky.cu"}"')
    for name, value in (("SUB_TM", tm), ("SUB_WX", wx)):
        out, n = re.subn(rf"^#define {name} \d+", f"#define {name} {value}", out, flags=re.M)
        if n != 1:
            raise RuntimeError(f"csrc/cholesky_many.cu changed: no #define {name}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("k1_many_probe: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.ba import cholesky

    print(chip_smoke.card_line())
    src = cholesky.KERNEL_MANY.source.read_text()
    tm0 = int(re.search(r"^#define SUB_TM (\d+)", src, re.M).group(1))
    wx0 = int(re.search(r"^#define SUB_WX (\d+)", src, re.M).group(1))
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built = {}
    for tm, wx in VARIANTS:
        if (tm, wx) == (tm0, wx0):
            built[tm, wx] = cholesky.KERNEL_MANY
            continue
        path = kernels.BUILD_DIR / f"k1_many_probe_tm{tm}_wx{wx}.cu"
        path.write_text(variant_source(src, kernels.CSRC, tm, wx))
        built[tm, wx] = kernels.Kernel(f"k1manyprobe_tm{tm}_wx{wx}", path, cholesky.KERNEL_MANY.signatures)
    kernels.build_all(list(built.values()))
    for (tm, wx), k in built.items():
        log = k.build_log.splitlines()
        for i, ln in enumerate(log):
            if "Compiling entry" in ln and "chol_subst_kernel" in ln:
                tail = " ".join(x.strip() for x in log[i + 1:i + 4] if "spill" in x or "registers" in x)
                print(f"TM={tm} WX={wx} {ln.split()[-3]}: {tail}")

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(chip_smoke.SEED)
    shapes = {}
    for K, N in ((384, 24576), (390, 1000)):
        A = rng.normal(size=(K, K)).astype(np.float32)
        S = torch.as_tensor(A @ A.T + K * np.eye(K, dtype=np.float32), device=dev)
        B = torch.as_tensor(rng.normal(size=(K, N)).astype(np.float32), device=dev)
        shapes[K, N] = (S, B, cholesky.cholesky_solve_plain(S, B))
    kept = cholesky.KERNEL_MANY

    def solve(k, S, B):
        cholesky.KERNEL_MANY = k
        try:
            return cholesky.cholesky_solve(S, B)
        finally:
            cholesky.KERNEL_MANY = kept

    for (tm, wx), k in built.items():
        for (K, N), (S, B, ref) in shapes.items():
            X = solve(k, S, B)
            err = float((X - ref).abs().max())
            rel = err / float(ref.abs().max())
            res = float(torch.linalg.norm(S.double() @ X.double() - B.double()) / torch.linalg.norm(B.double()))
            if not (err <= chip_smoke.K1_TOL and rel <= chip_smoke.K1_REL[1.0] and res <= chip_smoke.K1_REL[1.0]):
                raise AssertionError(f"TM={tm} WX={wx} at K={K}, N={N}: {err} {rel} {res}")

    S, B, _ = shapes[384, 24576]
    times = {v: [] for v in built}
    order = list(built) + list(reversed(built))
    for v in order:
        k = built[v]
        ms = chip_smoke.cuda_ms(lambda: solve(k, S, B), 20)
        by_name = chip_smoke.kernel_ms_by_name(lambda: solve(k, S, B), 20)
        subst = sum(t for n, t in by_name.items() if "chol_subst_kernel" in n)
        times[v].append((ms, subst))
    bound = 2.0 * 384 * 384 * 24576 / chip_smoke.PEAK_F32 * 1e3
    for (tm, wx), ts in times.items():
        threads = 32 // tm * 64 // 4
        print(f"TM={tm} WX={wx} ({threads} threads{', as built' if (tm, wx) == (tm0, wx0) else ''}): K1 many "
              f"{' '.join(f'{a:.4f}' for a, _ in ts)} ms, substitution {' '.join(f'{b:.4f}' for _, b in ts)} ms "
              f"(bound {bound:.5f} ms) at K=384, N=24576; within K1_TOL and K1_REL at 384 x 24576 and 390 x 1000")
    return 0


if __name__ == "__main__":
    sys.exit(main())
