"""Metric3Dv2's forward at its canonical crop: the matrix products and
convolutions of the reference's forward (reference/metric3dv2.forward),
counted from their shapes by torch's FlopCounterMode on meta tensors, so
that no number is computed (2 operations a multiply-add)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def flops(reference, spec):
    c = reference.conf_of(spec)
    crop_h, crop_w = c["crop_size"]
    hw = (crop_h // c["patch"], crop_w // c["patch"])
    p = {n: torch.empty(s, device="meta") for n, s, _, _ in reference.param_shapes(c)}
    x = torch.empty((1, crop_h, crop_w, 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        reference.forward(c, p, x, hw)
    return fc.get_total_flops()


TARGET = ("mpsfm_tpu_torch.extraction.nets.metric3d", "Metric3Dv2.forward")
_CACHE = {}


def record(args, kwargs, out):
    self, x = args[0], args[2]
    c = self.conf
    return {"shape": tuple(x.shape), "precision": "float32",
            "spec": {k: (list(v) if isinstance(v, tuple) else v) for k, v in c.items()}}


def _reference():
    """reference/metric3dv2.py, loaded by path."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "sfmbench_counts_metric3dv2_reference", Path(__file__).resolve().parents[1] / "reference" / "metric3dv2.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def least_s(rec, peaks):
    key = repr(sorted(rec["spec"].items()))
    if key not in _CACHE:
        _CACHE[key] = flops(_reference(), rec["spec"])
    return _CACHE[key] * rec["shape"][0] / peaks.FLOPS["float32"]
