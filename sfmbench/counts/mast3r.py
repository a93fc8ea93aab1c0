"""MASt3R's forward outside its attention (K4 counts that): the matrix
products and convolutions of the reference's forward
(reference/mast3r.forward) at the pair's padded size, counted from their
shapes by torch's FlopCounterMode on meta tensors, with the attention's two
products left out (2 operations a multiply-add)."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

TARGET = ("mpsfm_tpu_torch.extraction.nets.mast3r", "Mast3rNet.forward")
_CACHE = {}


def _reference():
    spec = importlib.util.spec_from_file_location(
        "sfmbench_counts_mast3r_reference", Path(__file__).resolve().parents[1] / "reference" / "mast3r.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flops(reference, spec, patch_hw, B=1):
    c = reference.conf_of(spec)
    h, w = patch_hw
    p = {n: torch.empty(s, device="meta") for n, s, _, _ in reference.param_shapes(c)}
    x = torch.empty((B, h * c["patch"], w * c["patch"], 3), device="meta")
    attend = reference.heads_attention
    reference.heads_attention = lambda q, k, v: torch.empty_like(q)
    try:
        with FlopCounterMode(display=False) as fc:
            reference.forward(c, p, x, x, patch_hw)
    finally:
        reference.heads_attention = attend
    return fc.get_total_flops()


def record(args, kwargs, out):
    self, xa, patch_hw = args[0], args[1], args[3]
    return {"shape": (xa.shape[0], *patch_hw), "precision": "float32",
            "spec": {k: (list(v) if isinstance(v, tuple) else v) for k, v in self.conf.items()}}


def least_s(rec, peaks):
    B, h, w = rec["shape"]
    key = (repr(sorted(rec["spec"].items())), B, h, w)
    if key not in _CACHE:
        _CACHE[key] = flops(_reference(), rec["spec"], (h, w), B)
    return _CACHE[key] / peaks.FLOPS["float32"]
