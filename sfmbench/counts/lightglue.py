"""LightGlue's forward outside its attention (K4 counts that): operations
of B pairs at buckets (N0, N1) of width D over L layers. Each side and
layer: the self block's Wqkv (3D²), output (D²) and FFN (4D² + 2D²), the
cross block's to_qk, to_v, to_out (3D²) and FFN (6D²), 2 operations a
multiply-add; input_proj and final_proj (2D²) once; the similarity
2·N0·N1·D."""

from __future__ import annotations


def flops(B, N0, N1, D=256, L=9):
    per_token = 2 * D * D * (L * (3 + 1 + 6 + 3 + 6) + 2)
    return B * ((N0 + N1) * per_token + 2 * N0 * N1 * D)


TARGET = ("mpsfm_tpu_torch.extraction.matchers.lightglue", "LightGlue._forward")


def record(args, kwargs, out):
    self, d0, d1 = args[0], args[4], args[5]
    return {"shape": (d0.shape[0], d0.shape[1], d1.shape[1], self.conf["dim"], self.conf["n_layers"]),
            "precision": "float32"}


def least_s(rec, peaks):
    """Its dense layers compute in float32 on bfloat16-rounded values."""
    return flops(*rec["shape"]) / peaks.FLOPS["float32"]
