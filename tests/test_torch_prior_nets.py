"""The prior nets on the port (slice 17: DepthPro, the vit_mono prior and its
trainer): chip_smoke's prior nets phase rehearsed on the CPU, its configs
against the YAML files, and DepthPro's and MonoViT's attention on K4.

This file imports no JAX, so its card-only cases run on the card's host:
DepthPro at chip_smoke's small widths (heads of 16, one of K4's head
widths) on the card launches K4's float32 kernel 3 · depth times a forward
(the patch, image and FOV encoders) and agrees with the same forward on the
CPU; the trainer's step on the card at its default net (heads of 48 on the
hd 64 kernel, padded) launches it once a block and its gradients agree with
the CPU's (chip_smoke.trainer_gradients).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu_torch.config import load_cfg
from mpsfm_tpu_torch.extraction.matchers import attention
from mpsfm_tpu_torch.extraction.nets.depth_pro import DepthPro

ROOT = Path(__file__).resolve().parents[1]
SMALL = chip_smoke.PRIOR_SIZES["small"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_phase_conf_is_the_config_with_the_cuts():
    """SP_LG_DEPTHPRO_CONF is configs/sp-lg_depthpro.yaml as the port loads
    it with phase 16's cuts (Metric3Dv2-small normals, the directory store,
    dist_ba off)."""
    want = chip_smoke.merge_conf(json.loads(json.dumps(load_cfg(ROOT / "configs" / "sp-lg_depthpro.yaml"))),
                                 chip_smoke.TWO_VIEW_CUTS)
    assert chip_smoke.SP_LG_DEPTHPRO_CONF == want


def test_chip_smoke_prior_nets_phase_on_the_cpu():
    """The phase at its small size, every device the CPU (no launch counted,
    no K4 check): DepthPro's checkpoint seeded and loaded at the tiny widths, card against CPU against itself, sp-lg_depthpro to
    its outputs on the render without sensor depth (its kernels' arguments
    kept), the trainer's loss falling and its gradients against themselves,
    and the trained vit_mono prior registering every image."""
    out, launches, k4 = chip_smoke.prior_nets_phase("cpu", {}, "small")
    full = out["full"]
    assert full["ok"] and full["k4_launches"] == 0 and full["forwards"] == 3 and k4 == {}
    assert full["depth_median"] > 0 and max(out["card_vs_cpu"].values()) == 0.0
    runs = out["pipelines"]
    assert runs["sp-lg_depthpro"]["forwards"]["depthpro"] == 3 and runs["sp-lg_depthpro"]["registered"] >= 2
    assert runs["vit_mono"]["forwards"]["vit_mono"] == 3 and runs["vit_mono"]["registered"] == 3
    tr = out["trainer"]
    assert tr["losses"][-1] < tr["losses"][0] and tr["gradients"]["ok"] and max(tr["gradients"]["gaps"].values()) == 0
    assert launches == {"sp-lg_depthpro": {}, "fit_scene_prior": {}, "vit_mono": {}}


def forward(dev, seed=0):
    net = DepthPro(SMALL["depthpro"], device=dev)
    net.params = {k: v.to(dev) for k, v in DepthPro(SMALL["depthpro"], device="cpu").init_random(seed).items()}
    x = torch.as_tensor(np.random.default_rng(seed + 1).normal(size=(1, 224, 224, 3)), dtype=torch.float32,
                        device=dev)
    n = attention.KERNEL.launches
    with torch.no_grad():
        inv, fov = net.forward(x)
    return (inv.cpu().numpy(), fov.cpu().numpy()), attention.KERNEL.launches - n


def test_depth_pro_takes_the_plain_attention_on_the_cpu():
    (inv, fov), launched = forward(torch.device("cpu"))
    assert launched == 0 and np.isfinite(inv).all() and np.isfinite(fov).all()


@pytest.mark.cuda
def test_depth_pro_forward_launches_k4_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    got, launched = forward(torch.device("cuda"))
    want, _ = forward(torch.device("cpu"))
    assert launched == 3 * SMALL["depthpro"]["depth"]
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= chip_smoke.PRIOR_REL * np.abs(b).max()


@pytest.mark.cuda
def test_trainer_step_on_the_card_equals_the_cpu():
    """The default net (heads of 48): one launch a block in the step, every
    gradient within TRAIN_GRAD_REL of the CPU's, the qkv weights' non-zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    batch = {"rgb": rng.uniform(0, 1, (2, 64, 80, 3)).astype(np.float32),
             "depth": rng.uniform(2, 5, (2, 64, 80)).astype(np.float32),
             "normals": np.tile(np.float32([0, 0, -1]), (2, 64, 80, 1)),
             "valid": np.ones((2, 64, 80), np.float32)}
    g = chip_smoke.trainer_gradients(torch.device("cuda"), {"net": {}}, batch)
    assert g["launches"] == 4 and g["ok"], g
