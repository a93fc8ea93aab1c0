#!/usr/bin/env python3
"""K4's tensor-core kernel on one CUDA card: its CTA shape, variant
against variant.

    python3 k4_probe.py

K4's bfloat16 route is mpsfm_tpu_torch/csrc/attention_tc.cu: a CTA of
TC_WG consumer warpgroups (64 query rows each) and a producer warp, a ring
of TC_STAGES K/V tiles, registers sized for TC_MINB CTAs an SM. The script
builds the source as it is and with other (TC_WG, TC_MINB, TC_STAGES) by
text edits, each its own library in mpsfm_tpu_torch/_build/ (none is used
by the port), checks each against the plain version by chip_smoke's
k4_bf16_bound, and times them in turns (each variant twice, in the order
a b c ... c b a) at LightGlue's 8192 self-attention call (4 pairs × 4
heads × 8192 queries, 4942 real keys, hd 64) and at the 2048 bucket (one
pair, hd 64 and hd 16), on seeded inputs. It prints the card's name and
power limit, ptxas's registers, spills and serialization warnings of each
variant's hd 64 instantiation, a line per variant, and
scaled_dot_product_attention's time at each shape. It exits 1 without a
card.
"""

from __future__ import annotations

import re
import sys

import numpy as np

import chip_smoke

NAMES = ("TC_WG", "TC_MINB", "TC_STAGES")
VARIANTS = [(1, 3, 3), (2, 1, 3), (2, 2, 2), (2, 2, 4)]  # beside the source's own
SHAPES = [(4, 8192, 4, 64, 4942), (1, 2048, 4, 64, 2011), (1, 2048, 4, 16, 2011)]  # B, N (= M), H, hd, real keys


def variant_source(src, values):
    out = src
    for name, value in zip(NAMES, values):
        out, n = re.subn(rf"^#define {name} \d+", f"#define {name} {value}", out, flags=re.M)
        if n != 1:
            raise RuntimeError(f"csrc/attention_tc.cu changed: no #define {name}")
    return out


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k4_probe: no CUDA card available", file=sys.stderr)
        return 1
    from mpsfm_tpu_torch import kernels
    from mpsfm_tpu_torch.extraction.matchers import attention as att

    print(chip_smoke.card_line())
    src = att.KERNEL_TC.source.read_text()
    own = tuple(int(re.search(rf"^#define {n} (\d+)", src, re.M).group(1)) for n in NAMES)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built = {}
    for values in [own] + [v for v in VARIANTS if v != own]:
        path = kernels.BUILD_DIR / ("attention_tc_probe_" + "_".join(map(str, values)) + ".cu")
        path.write_text(variant_source(src, values))
        built[values] = kernels.Kernel(path.stem, str(path), att.KERNEL_TC.signatures)
    kernels.build_all(list(built.values()))
    for values, k in built.items():
        lines = k.build_log.splitlines()
        at = next(i for i, ln in enumerate(lines) if "Compiling entry" in ln and "kernelILi64" in ln)
        notes = [ln.strip() for ln in lines[at + 1:at + 4] if "registers" in ln or "spill" in ln]
        notes += ["wgmma serialized (C7512)" for ln in lines if "C7512" in ln and "kernelILi64" in ln]
        print(f"{dict(zip(NAMES, values))}: {' | '.join(notes)}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED + 20)
    cases = []
    for B, N, H, hd, real in SHAPES:
        mask = torch.as_tensor(np.arange(N)[None].repeat(B, 0) < real, device=dev)
        q, k, v = (torch.as_tensor(rng.normal(size=(B, N, H, hd)), dtype=torch.float32, device=dev).bfloat16()
                   for _ in range(3))
        scale = hd ** -0.5
        cases.append(((B, N, H, hd, real), (q, k, v, mask, scale), *chip_smoke.k4_bf16_bound(q, k, v, mask, scale)))
    times = {values: [[] for _ in cases] for values in built}
    default = att.KERNEL_TC
    try:
        for values in list(built) + list(built)[::-1]:
            att.KERNEL_TC = built[values]
            for i, (_, args, ref, bound) in enumerate(cases):
                got = att.attention(*args)
                torch.cuda.synchronize()
                ratio = float(((got.float() - ref).abs() / bound).max())
                if not ratio <= 1:
                    raise AssertionError(f"{dict(zip(NAMES, values))}: {ratio:.3f} of k4_bf16_bound")
                times[values][i].append(chip_smoke.cuda_ms(lambda: att.attention(*args), 20))
    finally:
        att.KERNEL_TC = default
    for values, per in times.items():
        print(f"{dict(zip(NAMES, values))}{' (the source)' if values == own else ''}: " + "; ".join(
            f"{B}x{N}x{H}x{hd} ({real} real keys) {min(t):.4f}-{max(t):.4f} ms"
            for ((B, N, H, hd, real), *_), t in zip(cases, per)))
    for (B, N, H, hd, real), (q, k, v, mask, scale), *_ in cases:
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        am = mask[:, None, None, :]
        ms = chip_smoke.cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am, scale=scale), 20)
        print(f"scaled_dot_product_attention {B}x{N}x{H}x{hd} ({real} real keys): {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
