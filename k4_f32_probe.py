#!/usr/bin/env python3
"""K4's float32 kernel on one CUDA card, against other builds of it.

    python3 k4_f32_probe.py [--baseline PATH ...]
    python3 k4_f32_probe.py --hd48

K4's float32 route is mpsfm_tpu_torch/csrc/attention.cu. The script builds
the source as it is and each --baseline source (another version of the
file, e.g. a parent commit's or a variant's, in the gitignored
mpsfm_tpu_torch/_build/), each its own library there (none is used by the
port).
It holds each build within chip_smoke's K4_TOL of attention_plain and times
the builds in turns (a b ... b a, each twice) at the shapes the port calls
it with, on seeded inputs: MASt3R's encoder call (both views batched) and
its decoder cross call, DepthAnythingV2-vitl's at input 518 x 686, RoMa's
DINOv2 at 672^2 (both images batched), LightGlue's self call at the 8192
bucket (4 pairs, 4942 real keys) and the tests' LightGlue's hd 16 call at
the 2048 bucket. Beside them, at each shape: scaled_dot_product_attention
(float32, the key mask), attention_plain, and at RoMa's shape RoMa's own
matmul + softmax (extraction/nets/roma._vit_block before it moved onto K4),
each timed only; the bound (chip_smoke.k4_check's). It prints the card's
name and power limit, ptxas's registers and spills of each build's
kernels, and a line per shape; the whole as JSON in
chiprun_out/k4_f32_probe.json. It exits 1 without a card.

With --hd48 it times K4's two candidate routes for heads 48 wide (the
trained prior's default net, 96 = 2 × 48) in turns: the port's,
attention_row_kernel<48> through the wrapper, and q, k and v zero-padded to
64 on the hd 64 tile kernel (called directly, the output sliced back);
beside SDPA and attention_plain, at the trainer's shape (8 frames of 80
tokens + the class token), the backend's at inference (1 frame) and a
512-pixel frame's (769 tokens); each route held within K4_TOL of
attention_plain. JSON in chiprun_out/k4_hd48_probe.json.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

import chip_smoke

REPS = 10  # calls a timing
# name: B, N, M, H, hd, real keys of each batch element
SHAPES = {
    "mast3r_encoder": (2, 1200, 1200, 16, 64, 1200),
    "mast3r_cross": (1, 1200, 1200, 12, 64, 1200),
    "da2_vitl": (1, 1814, 1814, 16, 64, 1814),
    "roma_dinov2": (2, 2305, 2305, 16, 64, 2305),
    "lightglue_8192": (4, 8192, 8192, 4, 64, 4942),
    "lightglue_2048_hd16": (1, 2048, 2048, 4, 16, 2011),
}
HD48_SHAPES = {
    "trainer": (8, 81, 81, 2, 48, 81),
    "backend": (1, 81, 81, 2, 48, 81),
    "backend_512": (1, 769, 769, 2, 48, 769),
}


def hd48_routes():
    """--hd48: attention_row_kernel<48> against the padded route (module doc)."""
    import torch
    import torch.nn.functional as F

    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.extraction.matchers import attention as att

    card = chip_smoke.card_line()
    print(card)
    kernels.build_all([att.KERNEL])
    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED + 24)

    def padded_route(q, k, v, mask, scale):
        qp, kp, vp = (F.pad(t, (0, 64 - t.shape[-1])).contiguous() for t in (q, k, v))
        out = torch.empty_like(qp)
        B, N, H, _ = qp.shape
        att.KERNEL.call("attention_f32", qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), mask.data_ptr(), out.data_ptr(),
                        B, N, kp.shape[1], H, 64, float(scale), kernels.stream_ptr(q))
        return out[..., : q.shape[-1]]

    result = {"card": card, "shapes": {}}
    for shape, (B, N, M, H, hd, real) in HD48_SHAPES.items():
        mask = torch.as_tensor(np.arange(M)[None].repeat(B, 0) < real, device=dev)
        q = torch.as_tensor(rng.normal(size=(B, N, H, hd)), dtype=torch.float32, device=dev)
        k, v = (torch.as_tensor(rng.normal(size=(B, M, H, hd)), dtype=torch.float32, device=dev) for _ in range(2))
        scale = hd ** -0.5
        ref = att.attention_plain(q, k, v, mask, scale)
        routes = {"attention_row_kernel<48> (the port's)": lambda: att.attention(q, k, v, mask, scale),
                  "padded to 64 (tile kernel)": lambda: padded_route(q, k, v, mask, scale)}
        times, errs = {name: [] for name in routes}, {}
        for name in list(routes) + list(routes)[::-1]:
            got = routes[name]()
            torch.cuda.synchronize()
            errs[name] = float((got - ref).abs().max())
            if not errs[name] <= chip_smoke.K4_TOL or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} at {shape}: max |d| {errs[name]:.3e} > {chip_smoke.K4_TOL}")
            times[name].append(chip_smoke.cuda_ms(routes[name], REPS * 10))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        am = mask[:, None, None, :]
        lib = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, scale=scale),
                                 REPS * 10)
        plain = chip_smoke.cuda_ms(lambda: att.attention_plain(q, k, v, mask, scale), REPS)
        flops = att.attention_flops(N, H, hd, mask)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4 + mask.numel()
        bound = max(flops / chip_smoke.PEAK_F32, nbytes / chip_smoke.PEAK_BYTES) * 1e3
        result["shapes"][shape] = dict(shape=[B, N, M, H, hd, real], ms=times, max_abs_err=errs, sdpa_ms=lib,
                                       plain_ms=plain, bound_ms=bound)
        print(f"hd 48 {shape} ({B}x{N}x{H}x{hd} against {M} keys): "
              + "; ".join(f"{n} {min(t):.4f}-{max(t):.4f} ms (max |d| {errs[n]:.2e})" for n, t in times.items())
              + f"; SDPA float32 {lib:.4f} ms; plain {plain:.4f} ms; bound {bound:.5f} ms")
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "k4_hd48_probe.json").write_text(json.dumps(result, indent=1))
    return 0


def main(argv):
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k4_f32_probe: no CUDA card available", file=sys.stderr)
        return 1
    if "--hd48" in argv:
        return hd48_routes()
    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.extraction.matchers import attention as att

    baselines = [a for a in argv if a != "--baseline"]
    card = chip_smoke.card_line()
    print(card)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds = {"source": att.KERNEL}
    for i, path in enumerate(baselines):
        builds[f"baseline {i} {path}"] = kernels.Kernel(f"attention_probe_base{i}", str(Path(path).resolve()),
                                                        att.KERNEL.signatures)
    kernels.build_all(list(builds.values()))
    for name, k in builds.items():
        print(f"{name} ptxas: " + " | ".join(chip_smoke.ptxas_notes(k.build_log) or ["(built earlier, no log)"]))

    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED + 23)
    result = {"card": card, "shapes": {}}
    default = att.KERNEL
    try:
        for shape, (B, N, M, H, hd, real) in SHAPES.items():
            mask = torch.as_tensor(np.arange(M)[None].repeat(B, 0) < real, device=dev)
            q = torch.as_tensor(rng.normal(size=(B, N, H, hd)), dtype=torch.float32, device=dev)
            k, v = (torch.as_tensor(rng.normal(size=(B, M, H, hd)), dtype=torch.float32, device=dev)
                    for _ in range(2))
            scale = hd ** -0.5
            ref = att.attention_plain(q, k, v, mask, scale)
            times, errs = {name: [] for name in builds}, {}
            for name in list(builds) + list(builds)[::-1]:
                att.KERNEL = builds[name]
                got = att.attention(q, k, v, mask, scale)
                torch.cuda.synchronize()
                errs[name] = float((got - ref).abs().max())
                if not errs[name] <= chip_smoke.K4_TOL or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{name} at {shape}: max |d| {errs[name]:.3e} > {chip_smoke.K4_TOL}")
                times[name].append(chip_smoke.cuda_ms(lambda: att.attention(q, k, v, mask, scale), REPS))
            att.KERNEL = default
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            am = mask[:, None, None, :]
            lib = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, scale=scale),
                                     REPS)
            plain = chip_smoke.cuda_ms(lambda: att.attention_plain(q, k, v, mask, scale), 2)
            row = dict(shape=[B, N, M, H, hd, real], ms={n: t for n, t in times.items()}, max_abs_err=errs,
                       sdpa_ms=lib, plain_ms=plain)
            if shape == "roma_dinov2":  # RoMa's own attention on (B, heads, n, hd), as _vit_block computed it
                row["roma_matmul_softmax_ms"] = chip_smoke.cuda_ms(
                    lambda: torch.softmax((qt @ kt.transpose(-1, -2)) * scale, -1) @ vt, REPS)
            flops = att.attention_flops(N, H, hd, mask)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4 + mask.numel()
            row["bound_ms"] = max(flops / chip_smoke.PEAK_F32, nbytes / chip_smoke.PEAK_BYTES) * 1e3
            result["shapes"][shape] = row
            print(f"{shape} ({B}x{N}x{H}x{hd} against {M} keys, {real} real): "
                  + "; ".join(f"{n} {min(t):.4f}-{max(t):.4f} ms ({row['bound_ms'] / min(t) * 100:.1f}% of the bound, "
                              f"max |d| {errs[n]:.2e})" for n, t in times.items())
                  + f"; SDPA float32 {lib:.4f} ms; plain {plain:.4f} ms"
                  + (f"; RoMa's matmul + softmax {row['roma_matmul_softmax_ms']:.4f} ms"
                     if "roma_matmul_softmax_ms" in row else "")
                  + f"; bound {row['bound_ms']:.4f} ms")
            del q, k, v, ref, qt, kt, vt
    finally:
        att.KERNEL = default
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "k4_f32_probe.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
