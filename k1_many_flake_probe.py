#!/usr/bin/env python3
"""K1 many's float64 rule on the pipeline phase's point-covariance system,
under many nearby systems, on one CUDA card.

    python3 k1_many_flake_probe.py [--draws 300]

chip_smoke.pipeline_phase holds K1 many to its plain version at its
largest point-covariance solve (check_path_kernels: K = 48, N = 24 576,
κ ~4.5e8) with the float64 rule of chip_smoke.k1_many_check. This script
runs the phase's reconstruct once (as k1_many_ill_probe.py does), keeps
that solve's (S, B), and for each of DRAWS seeded draws takes a nearby
system, S perturbed at float32's rounding (chip_smoke.rounding_ensemble
with the draw's seed), and applies both rules to the kernel's solve:

- the old rule (the one chip_smoke.py held before): the medians over the system and
  K1_ILL_TRIALS - 1 copies of it of the kernel's max relative error and
  residual against the float64 solve, each within K1_ILL_RATIO times the
  plain version's;
- the repaired rule: the kernel's backward error on the system
  (chip_smoke.backward_error) within max(k1_eta_bound(K), K1_ILL_RATIO ×
  the plain version's).

It prints the failure rate of each, the quartiles of the statistics they
read (the median ratio of the old, the backward errors of the new), and
both rules on a planted fault, the plain solve with one tile of the first
panel's trailing update skipped (chip_smoke.k1_lost_tile), on the captured
system. It prints the card's name and power limit first, writes the whole
as JSON to chiprun_out/k1_many_flake_probe.json and exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke


def old_rule(S, B, solve, plain):
    """(pass, kernel / plain ratio of the median max relative errors, of the median residuals)."""
    gaps = np.array([chip_smoke.f64_gaps(S_t, B, solve(S_t, B)) + chip_smoke.f64_gaps(S_t, B, plain(S_t, B))
                     for S_t in chip_smoke.rounding_ensemble(S, chip_smoke.K1_ILL_TRIALS)])
    e_k, r_k, e_p, r_p = np.median(gaps, axis=0)
    return bool(e_k <= chip_smoke.K1_ILL_RATIO * e_p and r_k <= chip_smoke.K1_ILL_RATIO * r_p), e_k / e_p, r_k / r_p


def new_rule(S, B, solve, plain):
    """(pass, the kernel's backward error, the plain version's)."""
    eta_k = chip_smoke.backward_error(S, B, solve(S, B))
    eta_p = chip_smoke.backward_error(S, B, plain(S, B))
    return bool(eta_k <= max(chip_smoke.k1_eta_bound(S.shape[0]), chip_smoke.K1_ILL_RATIO * eta_p)), eta_k, eta_p


def quartiles(v):
    q = np.percentile(v, [25, 50, 75])
    return f"{q[0]:.3e} / {q[1]:.3e} / {q[2]:.3e} (max {np.max(v):.3e})"


def main(argv):
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=300)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_many_flake_probe: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.ba import cholesky

    card = chip_smoke.card_line()
    print(card)
    kernels.build_all(kernels.all_kernels())
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.render_rgbd_dir(Path(tmp) / "scene", **chip_smoke.PIPELINE)
        with chip_smoke.path_kernel_args() as kept:
            chip_smoke.run_pipeline(Path(tmp) / "scene", chip_smoke.PIPELINE_CONF, dev)
    S, B = kept["K1 many"]["args"]
    kappa = float(torch.linalg.cond(S.double()))
    print(f"the pipeline phase's largest point-covariance solve: K = {S.shape[0]}, N = {B.shape[1]}, condition "
          f"number {kappa:.3g}; backward error bound {chip_smoke.k1_eta_bound(S.shape[0]):.3e}")
    solve, plain = cholesky.cholesky_solve, cholesky.cholesky_solve_plain
    rows = []
    for d in range(args.draws):
        S_d = chip_smoke.rounding_ensemble(S, 2, seed=10_000 + d)[1]
        o = old_rule(S_d, B, solve, plain)
        n = new_rule(S_d, B, solve, plain)
        rows.append(dict(draw=d, old_pass=o[0], old_err_ratio=o[1], old_res_ratio=o[2], new_pass=n[0], eta_kernel=n[1],
                         eta_plain=n[2]))
    old_fail = sum(not r["old_pass"] for r in rows)
    new_fail = sum(not r["new_pass"] for r in rows)
    fault_old = old_rule(S, B, chip_smoke.k1_lost_tile, plain)
    fault_new = new_rule(S, B, chip_smoke.k1_lost_tile, plain)
    print(f"old rule (medians over {chip_smoke.K1_ILL_TRIALS} copies, the kernel's within {chip_smoke.K1_ILL_RATIO}x "
          f"the plain version's): {old_fail} of {args.draws} draws fail ({100 * old_fail / args.draws:.2f}%); kernel / "
          f"plain median max relative error {quartiles([r['old_err_ratio'] for r in rows])}, median residual "
          f"{quartiles([r['old_res_ratio'] for r in rows])}")
    print(f"repaired rule (backward error within max(K·2^-23, {chip_smoke.K1_ILL_RATIO}x the plain version's)): "
          f"{new_fail} of {args.draws} draws fail ({100 * new_fail / args.draws:.2f}%); kernel "
          f"{quartiles([r['eta_kernel'] for r in rows])}, plain {quartiles([r['eta_plain'] for r in rows])}")
    print(f"planted fault (one 32 x 32 tile of the first panel's trailing update skipped): old rule "
          f"{'passes' if fault_old[0] else 'fails'} (ratios {fault_old[1]:.3g}, {fault_old[2]:.3g}), repaired rule "
          f"{'passes' if fault_new[0] else 'fails'} (backward error {fault_new[1]:.3e}, plain {fault_new[2]:.3e})")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "k1_many_flake_probe.json").write_text(json.dumps(dict(
        card=card, K=S.shape[0], N=B.shape[1], kappa=kappa, draws=rows, old_fail=old_fail, new_fail=new_fail,
        fault=dict(old=fault_old, new=fault_new)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
