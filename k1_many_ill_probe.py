#!/usr/bin/env python3
"""K1 with many right-hand sides on the ill-conditioned point-covariance
systems of chip_smoke.py's mapping and pipeline phases: how far float32
solves land from the float64 one, the kernel against its plain version and
the library, over copies of S perturbed at float32's rounding level.

    python3 k1_many_ill_probe.py [--trials 32]

For each phase it runs the phase's path as chip_smoke.py does (the mapping
over MappingScene, the pipeline over a rendered directory), keeps the
largest point-covariance solve (S, B) with chip_smoke.path_kernel_args,
and solves S_t X = B over chip_smoke.rounding_ensemble(S, trials): S
itself, then copies of it perturbed at float32's rounding, with the kernel
(cholesky.cholesky_solve), the plain version (cholesky_solve_plain) and
the library (torch.linalg.cholesky + torch.cholesky_solve, float32). Per
solver it prints the quartiles of max |X − X₆₄| / max |X₆₄| and of
‖S·X − B‖ / ‖B‖ against each trial's float64 solve; then the quartiles of
the kernel's over the plain version's per trial, and the trials where the
kernel is farther from float64 than K1_ILL_RATIO times the plain version.
It prints the card's name and power limit first and exits 1 without a
card.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke


def pipeline_system(dev):
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.render_rgbd_dir(Path(tmp) / "scene", **chip_smoke.PIPELINE)
        with chip_smoke.path_kernel_args() as kept:
            chip_smoke.run_pipeline(Path(tmp) / "scene", chip_smoke.PIPELINE_CONF, dev)
    return kept["K1 many"]["args"]


def mapping_system(dev):
    cfg = dict(chip_smoke.MAPPING)
    num_hyp = cfg.pop("num_hyp")
    rec, corr, _, _, _ = chip_smoke.mapping_state(dev, num_hyp=num_hyp, **cfg)
    with chip_smoke.path_kernel_args() as kept:
        chip_smoke.run_mapping(rec, corr, dev, num_hyp)
    return kept["K1 many"]["args"]


def quartiles(v):
    q = np.percentile(v, [25, 50, 75])
    return f"{q[0]:.3e} / {q[1]:.3e} / {q[2]:.3e}"


def probe(name, S, B, trials, seed):
    import torch

    from mpsfm_tpu_torch.ba import cholesky

    solvers = {
        "kernel": lambda S_: cholesky.cholesky_solve(S_, B),
        "plain": lambda S_: cholesky.cholesky_solve_plain(S_, B),
        "library": lambda S_: torch.cholesky_solve(B, torch.linalg.cholesky(S_)),
    }
    out = {k: [] for k in solvers}
    for S_t in chip_smoke.rounding_ensemble(S, trials, seed):
        for k, fn in solvers.items():
            out[k].append(chip_smoke.f64_gaps(S_t, B, fn(S_t)))
    kappa = float(torch.linalg.cond(S.double()))
    print(f"{name}: K={S.shape[0]}, N={B.shape[1]}, condition number {kappa:.3g}, {trials} trials (trial 0 = S)")
    for k, v in out.items():
        e, r = np.array(v).T
        print(f"  {k:8s} max relative error quartiles {quartiles(e)} (trial 0 {e[0]:.3e}); "
              f"residual {quartiles(r)} (trial 0 {r[0]:.3e})")
    ek, rk = np.array(out["kernel"]).T
    ep, rp = np.array(out["plain"]).T
    el = np.array(out["library"])[:, 0]
    ratio = ek / ep
    over = np.flatnonzero((ek > chip_smoke.K1_ILL_RATIO * ep) | (rk > chip_smoke.K1_ILL_RATIO * rp))
    print(f"  kernel / plain error quartiles {quartiles(ratio)}, min {ratio.min():.3f}, max {ratio.max():.3f}; "
          f"library / plain {quartiles(el / ep)}; trials past {chip_smoke.K1_ILL_RATIO}x in error or residual: "
          f"{over.tolist()} ({len(over)} of {trials}); medians kernel {np.median(ek):.3e} plain {np.median(ep):.3e}")


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_many_ill_probe: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import kernels

    print(chip_smoke.card_line())
    kernels.build_all(kernels.all_kernels())
    dev = torch.device("cuda:0")
    for seed, (name, fn) in enumerate((("pipeline phase", pipeline_system), ("mapping phase", mapping_system))):
        S, B = fn(dev)
        probe(name, S, B, args.trials, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
