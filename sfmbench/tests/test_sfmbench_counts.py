"""Each counting function against a count by hand at a small shape."""

import importlib.util

import torch

from conftest import HERE
from sfmb import peaks


def load(kind, name):
    spec = importlib.util.spec_from_file_location(f"t_{kind}_{name}", HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k4():
    k4 = load("counts", "k4")
    # 2 elements, 3 queries, 2 heads of 4; element 0 has 2 real keys of 5, element 1 none (weighs all 5)
    keys = k4.real_keys([(2, 5), (0, 5)])
    assert keys == 7
    # logits and P·V: 3 queries × 7 keys × 4 multiply-adds, 2 ops each, 2 heads, twice
    assert k4.flops(2, 3, 5, 2, 4, keys) == 2 * 2 * (3 * 7 * 4) * 2
    # q and out: 2·3·2·4 values each, k and v: 2·5·2·4 each, 2 bytes a value, and 2·5 mask bytes
    assert k4.bytes_moved(2, 3, 5, 2, 4, 2) == 2 * (2 * 48 + 2 * 80) + 10
    rec = {"shape": (2, 3, 5, 2, 4), "precision": "bfloat16", "itemsize": 2,
           "mask": torch.tensor([[1, 1, 0, 0, 0], [0, 0, 0, 0, 0]], dtype=torch.bool)}
    assert k4.least_s(rec, peaks) == max(336 / 989e12, 522 / 3.35e12)


def test_k3():
    k3 = load("counts", "k3")
    # 2 lanes × 3 queries of a 4 × 5 grid, 2 iterations: 6 right-hand sides × 20 pixels × (66 + 31)
    assert k3.flops(2, 3, 4, 5, 2) == 6 * 20 * 97
    assert k3.bytes_moved(2, 3, 4, 5) == 4 * (7 * 40 + 18 + 18)


def test_superpoint():
    sp = load("counts", "superpoint")
    H, W = 16, 24
    convs = [(H * W, 1, 64, 9), (H * W, 64, 64, 9), (H * W // 4, 64, 64, 9), (H * W // 4, 64, 64, 9),
             (H * W // 16, 64, 128, 9), (H * W // 16, 128, 128, 9), (6, 128, 128, 9), (6, 128, 128, 9),
             (6, 128, 256, 9), (6, 256, 65, 1), (6, 128, 256, 9), (6, 256, 256, 1)]
    assert sp.flops(2, H, W) == 2 * sum(2 * px * ci * co * k for px, ci, co, k in convs)


def test_lightglue():
    lg = load("counts", "lightglue")
    D, L, N0, N1 = 8, 1, 3, 5
    # a token through one layer: Wqkv 3D², out D², self FFN 2D·2D + 2D·D, to_qk, to_v, to_out 3D², cross FFN 6D²;
    # input_proj and final_proj 2D²; 2 ops a multiply-add; similarity N0·N1·D multiply-adds
    per_token = 2 * (3 + 1 + 6 + 3 + 6 + 2) * D * D
    assert lg.flops(1, N0, N1, D, L) == (N0 + N1) * per_token + 2 * N0 * N1 * D


def test_netvlad():
    nv = load("counts", "netvlad")
    H, W = 32, 48
    trunk = 2 * 9 * (H * W * (3 * 64 + 64 * 64) + H * W // 4 * (64 * 128 + 128 * 128)
                     + H * W // 16 * (128 * 256 + 2 * 256 * 256) + H * W // 64 * (256 * 512 + 2 * 512 * 512)
                     + H * W // 256 * 3 * 512 * 512)
    assert nv.flops(1, H, W, K=2, D=512) == trunk + 4 * 2 * 512 * 6 + 2 * 4096 * 2 * 512


def test_metric3dv2_one_block_by_hand():
    m3d, ref = load("counts", "metric3dv2"), load("reference", "metric3dv2")
    base = dict(encoder="vit_small_reg", dim=32, heads=2, hooks=[0, 1, 2, 3], feature_channels=[8, 12, 16, 16],
                decoder_channels=[8, 8, 12, 16, 16], hidden=8, iters=2, crop_size=[56, 84], pos_grid=8)
    f4 = m3d.flops(ref, {**base, "depth": 4})
    f5 = m3d.flops(ref, {**base, "depth": 5})
    N, D = 4 * 6 + 5, 32  # patches of the 56 × 84 crop, the class and 4 register tokens
    # qkv 3D², proj D², the MLP's 4D² twice, and q·kᵀ and a·v (N² D each); 2 ops a multiply-add
    assert f5 - f4 == 2 * N * D * D * (3 + 1 + 8) + 2 * 2 * N * N * D
