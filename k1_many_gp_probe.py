#!/usr/bin/env python3
"""K1 many at the RoMa GP's K_bb: how far the kernel's solve lands from the
float64 one against its plain version, and whether the factor or the
substitutions put it there.

    python3 k1_many_gp_probe.py [--dump DIR]

It runs chip_smoke.py's phase 15 path once (seeded official-layout RoMa
checkpoints, the matcher at 672² on the first pair of the neural phase's
render) and keeps the GP's K_bb and right-hand sides f (K = 2304, N = 512).
Then, against the float64 solve of K_bb X = f, it prints max |X − X₆₄| /
max |X₆₄| and ‖K_bb·X − f‖ / ‖f‖ of: the kernel (cholesky.cholesky_solve),
the plain version (cholesky_solve_plain), and torch.cholesky_solve (the
library's substitutions) on three factors of K_bb: the kernel's own (the
grid route's U = Lᵀ read back from K1's workspace), the plain version's,
torch.linalg.cholesky's; with each factor's backward error ‖L·Lᵀ − K_bb‖ /
‖K_bb‖ and its largest distance from the plain factor by 32-column panel.
--dump writes K_bb and f as .npy files there. It prints the card's name
and power limit first and exits 1 without a card.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

import chip_smoke


def gp_system(dev):
    """The GP's (K_bb, f) of the first pair of the neural phase's render."""
    from mpsfm_tpu_torch.extraction.nets import roma

    size = chip_smoke.PAPER_SIZES["full"]
    with tempfile.TemporaryDirectory() as tmp:
        paths, _ = chip_smoke.paper_checkpoints(Path(tmp) / "weights", size, dev)
        chip_smoke.render_rgbd_dir(Path(tmp) / "scene", **dict(chip_smoke.NEURAL_SIZES["full"]["render"], n_images=2))
        grays, _ = chip_smoke.neural_images(Path(tmp) / "scene")
        m = roma.RomaMatcher({"weights_path": str(paths["roma"]), "dinov2_weights_path": str(paths["dinov2"])},
                             device=dev)
        with chip_smoke.last_call(roma, "cholesky_solve", lambda a, out: a[0].shape[0]) as kept:
            m(grays[0], grays[1])
    return kept["args"][0].contiguous(), kept["args"][1].contiguous()


def kernel_factor(S):
    """The factor K1's grid route leaves in its workspace: U = Lᵀ with rows grid_ld(K) floats apart."""
    import torch

    from mpsfm_tpu_torch.ba import cholesky
    from mpsfm_tpu_torch.kernels import stream_ptr

    K = S.shape[0]
    ld = cholesky.grid_ld(K)
    work = torch.zeros(cholesky.work_floats(K, False, True), dtype=torch.float32, device=S.device)
    bar = torch.zeros(2 + 64 * -(-K // cholesky.NB), dtype=torch.int32, device=S.device)
    b = torch.ones(K, device=S.device)
    x = torch.empty_like(b)
    cholesky.KERNEL.call("chol_solve_grid_f32", S.data_ptr(), b.data_ptr(), work.data_ptr(), bar.data_ptr(),
                         x.data_ptr(), K, stream_ptr(S))
    return torch.tril(work[:K * ld].view(K, ld)[:, :K].T)


def main():
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--dump", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_many_gp_probe: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.ba import cholesky

    print(chip_smoke.card_line())
    dev = torch.device("cuda:0")
    kernels.build_all([cholesky.KERNEL, cholesky.KERNEL_MANY])
    S, f = gp_system(dev)
    K, N = f.shape
    if args.dump:
        Path(args.dump).mkdir(parents=True, exist_ok=True)
        np.save(Path(args.dump) / "K_bb.npy", S.cpu().numpy())
        np.save(Path(args.dump) / "f.npy", f.cpu().numpy())
    S64, f64 = S.double(), f.double()
    X64 = torch.cholesky_solve(f64, torch.linalg.cholesky(S64))
    print(f"K_bb: K = {K}, N = {N}, condition number {float(torch.linalg.cond(S64)):.4g}, entries "
          f"{float(S.min()):.4g} .. {float(S.max()):.4g}")

    def gaps(X):
        X = X.double()
        return (float((X - X64).abs().max() / X64.abs().max()),
                float(torch.linalg.norm(S64 @ X - f64) / torch.linalg.norm(f64)))

    print("solve: max |X - X64| / max |X64|, residual")
    print("  kernel (cholesky_solve)       %.3e  %.3e" % gaps(cholesky.cholesky_solve(S, f)))
    print("  plain (cholesky_solve_plain)  %.3e  %.3e" % gaps(cholesky.cholesky_solve_plain(S, f)))
    factors = {"kernel": kernel_factor(S), "plain": torch.tril(cholesky.cholesky_factor_plain(S)),
               "torch.linalg.cholesky": torch.linalg.cholesky(S)}
    for name, L in factors.items():
        back = float(torch.linalg.norm(L.double() @ L.double().T - S64) / torch.linalg.norm(S64))
        e, r = gaps(torch.cholesky_solve(f, L))
        d = (L - factors["plain"]).abs()
        panels = [float(d[:, c:c + cholesky.NB].max()) for c in range(0, K, cholesky.NB)]
        print(f"  torch.cholesky_solve on the {name} factor: {e:.3e}  {r:.3e}; backward error of the factor "
              f"{back:.3e}; max |L - L_plain| by panel: first {panels[0]:.2e}, median {np.median(panels):.2e}, "
              f"last {panels[-1]:.2e}, max {max(panels):.2e} (panel {int(np.argmax(panels))})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
