"""The two-view nets on the port: chip_smoke's phase 16 rehearsed on the CPU,
its configs against the YAML files, the 'depth' mode on a scene without
sensor depth, and MASt3R's attention on K4.

This file imports no JAX, so its card-only cases run on the card's host:
MASt3R's forward at tests/test_mast3r.py's TINY width (its decoder 32 wide,
so that every head is 16 wide, one of K4's head widths) on the card launches
K4's float32 kernel enc_depth + 4·dec_depth times and agrees with the same
forward on the CPU, which launches nothing.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu_torch.config import load_cfg
from mpsfm_tpu_torch.extraction import priors
from mpsfm_tpu_torch.extraction.matchers import attention
from mpsfm_tpu_torch.extraction.nets import mast3r

ROOT = Path(__file__).resolve().parents[1]
TINY = chip_smoke.TWO_VIEW_SIZES["small"]["mast3r"]  # tests/test_mast3r.py's TINY
CARD = {**TINY, "dec_dim": 32}  # head widths 16 in both stacks: one of K4's instantiations (16, 64)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("conf,path", [("SP_MAST3R_CONF", "sp-mast3r.yaml"),
                                       ("SP_MAST3R_DENSE_CONF", "sp-mast3r-dense.yaml"),
                                       ("SP_LG_DAV2_CONF", "sp-lg_dav2.yaml")])
def test_phase_confs_are_the_configs_with_the_cuts(conf, path):
    """Phase 16's confs are the YAML files as the port loads them with
    TWO_VIEW_CUTS (Metric3Dv2-small normals, the directory store, dist_ba
    off); paper/sp-mast3r.yaml is sp-mast3r.yaml with resize_max null,
    which changes nothing on the phase's 640×480 images."""
    want = chip_smoke.merge_conf(json.loads(json.dumps(load_cfg(ROOT / "configs" / path))), chip_smoke.TWO_VIEW_CUTS)
    assert getattr(chip_smoke, conf) == want
    paper = json.loads(json.dumps(load_cfg(ROOT / "configs" / "paper" / "sp-mast3r.yaml")))
    assert paper == chip_smoke.merge_conf(json.loads(json.dumps(load_cfg(ROOT / "configs" / "sp-mast3r.yaml"))),
                                          {"extractors": {"resize_max": None}})


def test_chip_smoke_two_view_phase_on_the_cpu():
    """Phase 16 at its small size, every device the CPU (no launch counted,
    no K4 check): checkpoints written and loaded at the tiny widths, MASt3R
    on every pair and DepthAnythingV2 on every image, card against CPU
    against itself, the three reconstructs to their outputs on the render
    without sensor depth: the mast3r confs with a pair depth for every pair
    (sp-mast3r.yaml's per-image depth is the oracle's, which has none: the
    images keep the Metric3Dv2 normals only), sp-mast3r-dense with dense
    matches, sp-lg_dav2 with DepthAnythingV2's depth store."""
    out, launches, k4 = chip_smoke.two_view_phase("cpu", {}, "small")
    full = out["full"]
    assert full["mast3r_ok"] and full["da2_ok"] and full["k4_launches"] == 0 and k4 == {}
    assert full["forwards"] == len(full["mast3r_matches"]) == 3 and any(full["mast3r_matches"])
    assert out["card_vs_cpu"]["ok"] and max(out["card_vs_cpu"]["gaps"].values()) == 0.0
    runs = out["pipelines"]
    for name in ("sp-mast3r", "sp-mast3r-dense"):
        r = runs[name]
        assert r["pair_depths"] == r["pairs"] == 3 and r["tensors"]["mast3r"] == ["cpu"]
        assert r["k4_per_forward"] == {"mast3r": TINY["enc_depth"] + 4 * TINY["dec_depth"]}
    assert runs["sp-mast3r"]["forwards"]["mast3r"] == 3 and runs["sp-mast3r-dense"]["forwards"]["mast3r"] == 6
    assert any(runs["sp-mast3r-dense"]["dense_per_pair"])
    assert runs["sp-lg_dav2"]["forwards"]["da2"] == 3 and "depth" in runs["sp-lg_dav2"]["depth_keys"]
    assert launches == {"sp-mast3r": {}, "sp-mast3r-dense": {}, "sp-lg_dav2": {}}


def test_oracle_without_ground_truth_raises_missing_depth():
    """The port's oracle backend has no depth without depth_gt and says so
    (the JAX package's writes 0-d NaN maps its store cannot read back)."""
    with pytest.raises(priors.MissingDepthError, match="depth_gt"):
        priors.get_prior_backend("oracle")(None, intrinsics=(1.0, 1.0, 0.0, 0.0))


def forward(dev, seed=0):
    net = mast3r.Mast3rNet(CARD, device=dev)
    net.init_random(seed)
    rng = np.random.default_rng(seed + 1)
    xa, xb = (torch.as_tensor(rng.normal(size=(1, 48, 64, 3)), dtype=torch.float32, device=dev) for _ in range(2))
    n = attention.KERNEL.launches
    with torch.no_grad():
        out = net.forward(xa, xb, (3, 4))
    return {k: v.cpu().numpy() for k, v in out.items()}, attention.KERNEL.launches - n


def test_mast3r_takes_the_plain_attention_on_the_cpu():
    out, launched = forward(torch.device("cpu"))
    assert launched == 0 and all(np.isfinite(v).all() for v in out.values())


@pytest.mark.cuda
def test_mast3r_forward_launches_k4_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    got, launched = forward(torch.device("cuda"))
    want, _ = forward(torch.device("cpu"))
    assert launched == CARD["enc_depth"] + 4 * CARD["dec_depth"]
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= chip_smoke.TWO_VIEW_REL * np.abs(want[k]).max(), k
