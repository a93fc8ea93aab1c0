"""VGG16-NetVLAD's forward: the 13 convolutions of VGG16's trunk (2·Cin·Cout·9
a pixel at 1, 1/2, 1/4, 1/8 and 1/16 of the input), the soft assignment and
the residual aggregation (4·K·D a location) and the whitening (2·4096·K·D)."""

from __future__ import annotations

TRUNK = ((1, 3, 64), (1, 64, 64), (2, 64, 128), (2, 128, 128), (4, 128, 256), (4, 256, 256), (4, 256, 256),
         (8, 256, 512), (8, 512, 512), (8, 512, 512), (16, 512, 512), (16, 512, 512), (16, 512, 512))


def flops(B, H, W, K=64, D=512):
    trunk = sum(2 * ci * co * 9 * (H // s) * (W // s) for s, ci, co in TRUNK)
    return B * (trunk + 4 * K * D * (H // 16) * (W // 16) + 2 * 4096 * K * D)


TARGET = ("mpsfm_tpu_torch.extraction.retrieval", "vgg16_features")


def record(args, kwargs, out):
    B, H, W, _ = args[1].shape
    return {"shape": (B, H, W), "precision": "float32"}


def least_s(rec, peaks):
    return flops(*rec["shape"]) / peaks.FLOPS["float32"]
