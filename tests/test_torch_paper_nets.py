"""The paper's nets on the port: chip_smoke's phase 15 rehearsed on the CPU,
its configs against the YAML files, and RoMa's GP solve on K1 many.

This file imports no JAX, so its card-only cases run on the card's host:
the RoMa forward at tests/test_roma.py's TINY width on the card launches K1
many once a batch item (its GP's K_bb solve) and K4 float32 once a DINOv2
block, and agrees with the same forward on the CPU; K1 many at the GP's full shape (K = 48² = 2304, N = 512)
on a K_bb made from seeded features holds chip_smoke.k1_many_check_in_situ's
rules against its plain version. On the CPU the same GP takes
cholesky_solve_plain and launches nothing.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu_torch.ba import cholesky
from mpsfm_tpu_torch.config import load_cfg
from mpsfm_tpu_torch.extraction.matchers import attention
from mpsfm_tpu_torch.extraction.nets import roma

ROOT = Path(__file__).resolve().parents[1]
TINY = chip_smoke.PAPER_SIZES["small"]["roma"]  # tests/test_roma.py's TINY


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def merged(a, b):
    out = json.loads(json.dumps(a))
    for k, v in b.items():
        out[k] = merged(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


CUTS = {"extractors": {"depth": "metric3dv2-small"},
        "image_priors": {"depth": {"depth_uncertainty": 0.0433, "prior_std_multiplier": 2.045}},
        "cache_format": "npy", "mapper": {"ba": {"dist_ba": "off"}}}


@pytest.mark.parametrize("conf,path", [("PAPER_LG_CONF", "paper/sp-lg_m3dv2.yaml"),
                                       ("ROMA_DENSE_CONF", "sp-roma-dense_m3dv2.yaml")])
def test_phase_confs_are_the_configs_with_the_cuts(conf, path):
    """Phase 15's confs are the YAML files as the port loads them, cut as
    the neural phase's (d) cuts sp-lg_m3dv2 (Metric3Dv2-small with its
    calibration, the directory store, dist_ba off)."""
    want = merged(json.loads(json.dumps(load_cfg(ROOT / "configs" / path))), CUTS)
    assert getattr(chip_smoke, conf) == want


def test_chip_smoke_paper_nets_phase_on_the_cpu():
    """Phase 15 at its small size, every device the CPU (no launch counted,
    no K1 many check): checkpoints written and loaded at the tiny widths,
    DSINE and RoMa on every image and pair, card against CPU against
    itself, both reconstructs to their outputs with DSINE's normals2 in the
    depth store and a RoMa GP solve and forward a pair; no K4 launch or
    check on the CPU."""
    out, launches, row = chip_smoke.paper_nets_phase("cpu", {}, "small")
    full = out["full"]
    assert full["dsine_ok"] and full["roma_ok"] and full["roma_gp_launches"] == 0 and row is None
    assert full["roma_k4_launches"] == 0 and full["roma_vit_depth"] == TINY["vit_depth"] and out["k4"] is None
    assert len(full["roma_matches"]) == 3 and full["gp_K"] == 16 * 16 and out["card_vs_cpu"]["ok"]
    lg, rm = out["pipelines"]["paper sp-lg_m3dv2"], out["pipelines"]["sp-roma-dense_m3dv2"]
    assert {"normals2", "normals2_variance"} <= set(lg["depth_keys"]) and lg["tensors"]["normals"] == ["cpu"]
    assert rm["gp_calls"] == rm["pairs"] == rm["forwards"]["dense"] > 0 and rm["gp_launches"] == 0
    assert any(rm["dense_per_pair"])
    assert launches == {"paper sp-lg_m3dv2": {}, "sp-roma-dense_m3dv2": {}}


def test_gp_takes_the_plain_version_on_the_cpu():
    net = roma.RomaNet(TINY, device="cpu")
    net.init_random(0)
    rng = np.random.default_rng(0)
    xa, xb = (torch.as_tensor(rng.normal(size=(2, 6, 5, TINY["gp_dim"])), dtype=torch.float32) for _ in range(2))
    n = cholesky.KERNEL_MANY.launches
    mu = net._gp(net.params, xa, xb)
    assert mu.shape == (2, 6, 5, TINY["gp_dim"]) and cholesky.KERNEL_MANY.launches == n


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_roma_forward_launches_k1_many_once_a_pair_on_the_card(cuda):
    """RoMa's forward on a batch of 2 pairs: K1 many once a pair (the GP),
    K4 float32 once a DINOv2 block (both images of every pair batched),
    neither on the CPU; the card against the CPU."""
    rng = np.random.default_rng(1)
    xa, xb = (rng.normal(size=(2, 112, 112, 3)).astype(np.float32) for _ in range(2))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        net = roma.RomaNet(TINY, device=dev)
        net.init_random(2)
        n, k = cholesky.KERNEL_MANY.launches, attention.KERNEL.launches
        with torch.no_grad():
            flow, cert = net.forward(torch.as_tensor(xa, device=dev), torch.as_tensor(xb, device=dev))
        out[dev.type] = (flow.cpu().numpy(), cert.cpu().numpy(), cholesky.KERNEL_MANY.launches - n,
                         attention.KERNEL.launches - k)
    assert out["cuda"][2] == 2 and out["cpu"][2] == 0
    assert out["cuda"][3] == TINY["vit_depth"] and out["cpu"][3] == 0
    assert np.abs(out["cuda"][0] - out["cpu"][0]).max() <= chip_smoke.ROMA_FLOW_TOL
    assert np.abs(out["cuda"][1] - out["cpu"][1]).max() <= chip_smoke.ROMA_FLOW_TOL * max(1, np.abs(out["cpu"][1]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("common", [0.0, 3.0])
def test_k1_many_at_the_gp_shape_on_the_card(cuda, common):
    """K_bb = exp((cos − 1)/T) + 0.1·I of 48² seeded unit features, with a
    component common to all of them or none (the seeded RoMa's features
    share one: K_bb's entries 0.18-1.1 and κ 1.6e4 at 672²), and 512
    right-hand sides linear in the grid's coordinates, as the GP's position
    embedding is: the kernel against its plain version by
    chip_smoke.k1_many_check_in_situ's rules. Where a row's update ran as
    one float32 chain over all K terms, the common case lay ~7x farther
    from the float64 solve than the plain version (an emulation on the CPU;
    3.8e-4 against 5.9e-5 on the GP's own K_bb on the H100)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    u = torch.randn(2304, 256, generator=g, device=cuda) + common * torch.randn(1, 256, generator=g, device=cuda)
    u = torch.nn.functional.normalize(u, dim=-1)
    K_bb = torch.exp((u @ u.T - 1) / 0.2) + 0.1 * torch.eye(2304, device=cuda)
    grid = torch.linspace(-1 + 1 / 48, 1 - 1 / 48, 48, device=cuda)
    coords = torch.stack(torch.meshgrid(grid, grid, indexing="xy"), -1).reshape(-1, 2)
    f = coords @ torch.randn(2, 512, generator=g, device=cuda)
    chip_smoke.k1_many_check_in_situ(K_bb, f.contiguous(), "GP shape")
