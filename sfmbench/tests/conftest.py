"""The benchmark's own tests: sfmbench/ on the path, the repository's root
as the checkout, and `tiny_checkout`, a temporary checkout whose
BENCHMARK.json also holds a tiny cell (narrow nets, 160×120 images, the
CPU) for the runs these tests drive."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

TINY_M3D = dict(dim=32, depth=4, heads=2, hooks=[0, 1, 2, 3], feature_channels=[8, 12, 16, 16],
                decoder_channels=[8, 8, 12, 16, 16], hidden=8, iters=2, crop_size=[112, 112], pos_grid=8)
TINY_MAST3R = dict(enc_dim=64, enc_depth=2, enc_heads=4, dec_dim=64, dec_depth=2, dec_heads=4,
                   dpt_layer_dims=[8, 16, 32, 64], dpt_feature_dim=32, desc_dim=8)
# the tiny cell's limits, from its sound CPU runs (the published cells' are in configs/)
TINY_LIMITS = {"sp_kp_miss": 0.01, "sp_desc_gap": 1e-3, "lg_match_miss": 0.05, "m3d_depth_gap": 1e-4,
               "m3d_normal_gap": 1e-4, "k4_gap": 0.02, "k3_gap": 1e-4, "k1_berr": 1e-3, "k2_gap": 1e-3,
               "pose_err_deg": 6.5}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_tiny_checkout(dest):
    """A checkout in `dest`: BENCHMARK.json with a cell tiny.rgb3 added, the
    sfmbench folder with its tiny config and traffic files added (no file
    of the benchmark edited), the port linked in."""
    dest = Path(dest)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(HERE, dest / "sfmbench", ignore=shutil.ignore_patterns(".weights", ".cache", "__pycache__"))
    (dest / "mpsfm_tpu_torch").symlink_to(ROOT / "mpsfm_tpu_torch")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests", "file": "sfmbench/configs/tiny.json", "reduced": [],
                             "why": "tests"})
    bench["configs"].append({"name": "tiny-mast3r", "source": "tests", "file": "sfmbench/configs/tiny-mast3r.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny.rgb3", "config": "tiny", "traffic": "tiny3", "chips": 1, "why": "tests"})
    bench["workloads"].append({"name": "tiny-mast3r.rgb3", "config": "tiny-mast3r", "traffic": "tiny3", "chips": 1,
                               "why": "tests"})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    cfg = json.loads((HERE / "configs" / "sp-lg_m3dv2.json").read_text())
    ex = cfg["conf"]["extractors"]
    cfg["name"] = "tiny"
    ex["pairs_type"] = "exhaustive"
    del ex["retrieval"], ex["retrieval_conf"], cfg["nets"]["netvlad"]
    cfg["counted"].remove("netvlad")
    ex["feature_conf"]["max_keypoints"] = cfg["nets"]["superpoint"]["max_keypoints"] = 512
    cfg["nets"]["metric3dv2"].update(TINY_M3D)
    ex["depth_conf"].update(TINY_M3D)
    cfg["nets"]["lightglue"]["n_layers"] = ex["matcher_conf"]["n_layers"] = 2
    cfg["limits"] = TINY_LIMITS
    (dest / "sfmbench" / "configs" / "tiny.json").write_text(json.dumps(cfg, indent=1))
    cfg = json.loads((HERE / "configs" / "sp-mast3r.json").read_text())
    ex = cfg["conf"]["extractors"]
    cfg["name"] = "tiny-mast3r"
    ex["pairs_type"] = "exhaustive"
    del ex["retrieval"], ex["retrieval_conf"], cfg["nets"]["netvlad"]
    cfg["counted"].remove("netvlad")
    ex["feature_conf"]["max_keypoints"] = cfg["nets"]["superpoint"]["max_keypoints"] = 512
    cfg["nets"]["metric3dv2"].update(TINY_M3D)
    ex["normals_conf"].update(TINY_M3D)
    cfg["nets"]["mast3r"].update(TINY_MAST3R)
    ex["dense_matcher_conf"].update(TINY_MAST3R)
    cfg["limits"] = {k: v for k, v in TINY_LIMITS.items()
                     if k not in ("lg_match_miss", "m3d_depth_gap", "k1_berr", "k2_gap", "pose_err_deg")}
    cfg["limits"]["mast3r_depth_gap"] = 1e-4
    (dest / "sfmbench" / "configs" / "tiny-mast3r.json").write_text(json.dumps(cfg, indent=1))
    traffic = json.loads((HERE / "traffic" / "rgb3-640.json").read_text())
    traffic.update(width=160, height=120, focal=130.0, texture_res=256, pool=2)
    (dest / "sfmbench" / "traffic" / "tiny3.json").write_text(json.dumps(traffic))
    return dest


@pytest.fixture(scope="session")
def tiny_checkout(tmp_path_factory):
    return make_tiny_checkout(tmp_path_factory.mktemp("checkout"))
