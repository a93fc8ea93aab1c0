"""SuperPoint's forward: operations from the input's shape, 2·Cin·Cout·k²
a pixel of each convolution's output (the encoder at 1, 1/2, 1/4 and 1/8 of
the padded input, both heads at 1/8)."""

from __future__ import annotations

LAYERS = (  # (scale divisor, Cin, Cout, k)
    (1, 1, 64, 3), (1, 64, 64, 3), (2, 64, 64, 3), (2, 64, 64, 3), (4, 64, 128, 3), (4, 128, 128, 3),
    (8, 128, 128, 3), (8, 128, 128, 3), (8, 128, 256, 3), (8, 256, 65, 1), (8, 128, 256, 3), (8, 256, 256, 1))


def flops(B, H, W):
    """B images of H × W (multiples of 8)."""
    return sum(2 * ci * co * k * k * (H // s) * (W // s) for s, ci, co, k in LAYERS) * B


TARGET = ("mpsfm_tpu_torch.extraction.features.superpoint", "SuperPointNet.forward")


def record(args, kwargs, out):
    B, _, H, W = args[1].shape
    return {"shape": (B, H, W), "precision": "float32"}


def least_s(rec, peaks):
    return flops(*rec["shape"]) / peaks.FLOPS["float32"]
