#!/usr/bin/env python3
"""K2's PCG against its plain version on the dense modes phase's own PCGs,
many times over, on one CUDA card.

    python3 k2_flake_probe.py

chip_smoke.dense_modes_phase holds K2 to its plain version at the widest
and the busiest PCG of its reconstruct (check_path_kernels). That run's
mapping differs from run to run on the card, and so do those PCGs' inputs;
on a lane whose residual stagnates near the tolerance the two float32
orders can stop many iterations apart. This script runs the phase's
reconstruct once (chip_smoke.dense_full_run), keeps both PCGs' inputs, runs
each as captured 5 times (K2 and the plain version each bit-identical from
run to run?), then DRAWS draws of neighbouring inputs: the right-hand side
times (1 + 2^-22 n), n standard normal, and the tolerance times 2^u, u
uniform in [-2, 2], seeded. For each draw it records whether the old
rule (every lane within K2_STALL iterations and K2_TOL) and the repaired
one (chip_smoke.k2_pcg_verdict: a lane that stopped elsewhere held by
k2_stall_rule) pass, and where the old rule fails, on its failing lanes,
the iteration counts, the kernel's and the plain version's distance from a
float64 run of the plain version stopped by the same tolerance,
k2_stall_rule's numbers, and the plain version's iteration counts at the
tolerance times and over 2, 4 and 8. It prints the card's name and power limit, a line per
PCG and the failure rates; the whole as JSON in
chiprun_out/k2_flake_probe.json. It exits 1 without a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

import chip_smoke

DRAWS = 200  # seeded draws of nearby inputs a PCG

def main():
    import torch

    if not torch.cuda.is_available():
        print("k2_flake_probe: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.ba import cholesky
    from mpsfm_tpu_torch.integration import bini_diag, bini_fused

    card = chip_smoke.card_line()
    print(card)
    kernels.build_all(kernels.all_kernels())
    counted = {"cholesky": cholesky.KERNEL, "cholesky_grid": cholesky.KERNEL_GRID,
               "cholesky_many": cholesky.KERNEL_MANY, "bini": bini_fused.KERNEL, "bini_diag": bini_diag.KERNEL}
    result = probe(torch.device("cuda:0"), counted, "full", DRAWS)
    result["card"] = card
    path = Path("chiprun_out")
    path.mkdir(exist_ok=True)
    (path / "k2_flake_probe.json").write_text(json.dumps(result, indent=1))
    return 0


def probe(dev, counted, size, draws):
    """The reconstruct of chip_smoke.dense_full_run at DENSE_SIZES[size] on
    dev, then its two PCGs as captured and under `draws` draws (see the
    module). Returns the summary."""
    import torch

    from mpsfm_tpu_torch.integration import bini_fused

    out, _, kept, _ = chip_smoke.dense_full_run(dev, counted, chip_smoke.DENSE_SIZES[size])
    print(f"dense modes reconstruct: {out['registered']}/{out['images']} registered, {out['points']} points, "
          f"{out['wall']:.1f} s wall")
    result = {"draws": draws, "pcgs": {}}
    rng = np.random.default_rng(chip_smoke.SEED + 31)
    for name in ("K2 widest", "K2 busiest"):
        st, b, dg, z, budget, tol, active = kept[name]["args"]
        runs = [(bini_fused.pcg(st, b, dg, z, budget, tol, active), bini_fused.pcg_plain(st, b, dg, z, budget, tol,
                                                                                         active)) for _ in range(5)]
        same = all(torch.equal(r[i][j], runs[0][i][j]) for r in runs for i in range(2) for j in range(2))
        (x, it), (xr, itr) = runs[0]
        row = dict(shape=list(z.shape), tol=tol, budget=budget, iterations=it.tolist(), plain_iterations=itr.tolist(),
                   max_abs=float(chip_smoke.lane_max_abs(x - xr).max()), run_to_run_identical=same,
                   failed_draws=[])
        old_fail = new_fail = 0
        for i in range(draws):
            tol_i = tol * 2.0 ** rng.uniform(-2, 2)
            noise = torch.as_tensor(rng.standard_normal(b.shape), dtype=b.dtype, device=dev)
            args_i = (st, b * (1 + 2.0 ** -22 * noise), dg, z, budget, tol_i)
            x, it = bini_fused.pcg(*args_i, active)
            xr, itr = bini_fused.pcg_plain(*args_i, active)
            err = chip_smoke.lane_max_abs(x - xr)
            gap = (it - itr).abs().cpu()
            old_ok = bool(((gap <= chip_smoke.K2_STALL) & (err <= chip_smoke.K2_TOL)).all())
            ok, stalled, line = chip_smoke.k2_pcg_verdict(args_i, active, x, it, xr, itr)
            old_fail += not old_ok
            new_fail += not ok
            if not old_ok:
                # the float64 run stopped by the same tolerance: which version it sides with
                st64 = bini_fused.Stencil(*(t.double() for t in st))
                x64, it64 = bini_fused.pcg_plain(st64, args_i[1].double(), dg.double(), z.double(), budget, tol_i,
                                                 active)
                lanes = (~((gap <= chip_smoke.K2_STALL) & (err <= chip_smoke.K2_TOL)))
                row["failed_draws"].append(dict(
                    draw=i, tol=tol_i, lanes=lanes.nonzero().flatten().tolist(), kernel=it.cpu()[lanes].tolist(),
                    plain=itr.cpu()[lanes].tolist(), float64_stopped=it64.cpu()[lanes].tolist(),
                    kernel_plain=err[lanes].tolist(),
                    kernel_f64_stopped=chip_smoke.lane_max_abs(x.double() - x64)[lanes].tolist(),
                    plain_f64_stopped=chip_smoke.lane_max_abs(xr.double() - x64)[lanes].tolist(),
                    repaired_rule=ok, line=line,
                    windows={f: [bini_fused.pcg_plain(*args_i[:5], t, active)[1].cpu()[lanes].tolist()
                                 for t in (tol_i * f, tol_i / f)] for f in (2, 4, 8)}))
        row.update(old_rule_failures=old_fail, repaired_rule_failures=new_fail)
        result["pcgs"][name] = row
        print(f"{name} PCG ({tuple(z.shape)}, tol {tol}, budget {budget}): as captured iterations kernel "
              f"{row['iterations']} plain {row['plain_iterations']}, max |d| {row['max_abs']:.3e}, 5 runs each "
              f"bit-identical: {same}; {draws} draws (b x (1 + 2^-22 n), tol x 2^[-2, 2]): the old rule (every lane "
              f"within {chip_smoke.K2_STALL} iteration and {chip_smoke.K2_TOL}) fails {old_fail} "
              f"({old_fail / draws:.1%}), the repaired rule (k2_pcg_verdict) {new_fail} ({new_fail / draws:.1%})")
        for d in row["failed_draws"]:
            gaps = {k: [f"{v:.2e}" for v in d[k]] for k in ("kernel_plain", "kernel_f64_stopped", "plain_f64_stopped")}
            print(f"  draw {d['draw']} tol {d['tol']:.3e}: lanes {d['lanes']} iterations kernel {d['kernel']} plain "
                  f"{d['plain']}, |kernel - plain| {gaps['kernel_plain']}; a float64 run stopped by the tolerance: "
                  f"iterations {d['float64_stopped']}, from it kernel {gaps['kernel_f64_stopped']} plain "
                  f"{gaps['plain_f64_stopped']}; repaired rule {'passes' if d['repaired_rule'] else 'FAILS'}: "
                  f"{d['line']}; the plain version's iterations at the tolerance x and / 2, 4, 8: {d['windows']}")
    return result


if __name__ == "__main__":
    sys.exit(main())
