"""The neural extraction slice as a whole on the port, against the JAX
package on the CPU.

tests/test_pipeline_e2e.py's scene (5 images of 320×240) under a small
sp-lg + Metric3Dv2 conf: SuperPoint with the JAX package's init_random(0)
weights, LightGlue at the official 256 × 4 heads × 9 layers (the JAX
package's loader reads 9-layer checkpoints only) whose blocks are identities (their
last FFN layer zeroed, input_proj the identity, final_proj 80·I, the
matchability bias 10, so the assignment is the dual softmax of the
descriptors' similarities and a few matches pass the 0.1 filter; seeded
weights in the official layout), Metric3Dv2 at tests/test_metric3d.py's
TINY config, and NetVLAD retrieval (n_retrieval 3) from a matconvnet
.mat at small widths. Every checkpoint is written here and loaded by both
packages.

(a) Stores: the port's own extraction against the JAX run's caches: the
    same pairs, keypoints as sets (at least 99% common), scores within
    1e-4 and descriptors within one float16 step (both stores keep them as
    float16), matches as sets of keypoint pairs, the Metric3Dv2 maps within
    1e-4 relative.
(b) Decisions: from the JAX run's caches (JAX's registration draws), the
    port registers the JAX run's images in its order with its points.
(c) custom.yaml and the three sp-lg_m3dv2*.yaml configs build the port's
    SuperPoint, LightGlue and Metric3Dv2 and no longer raise
    NotImplementedError; custom.yaml maps the scene; paper/sp-lg_m3dv2.yaml
    still raises, naming item 6 (DSINE normals).
(d) chip_smoke's neural extraction phase rehearsed on the CPU at its small
    size.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import jax
from mpsfm_tpu.extraction.features.superpoint import SuperPoint as JSuperPoint
from mpsfm_tpu.extraction.matchers.lightglue import LightGlue as JLightGlue
from mpsfm_tpu.extraction.nets.metric3d import Metric3Dv2 as JMetric3Dv2
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch import pipeline as tpipeline
from mpsfm_tpu_torch.config import load_cfg
from mpsfm_tpu_torch.datasets.simple import SimpleParser as TParser
from mpsfm_tpu_torch.extraction import priors as tpriors
from mpsfm_tpu_torch.extraction.base import Extraction as TExtraction
from mpsfm_tpu_torch.extraction.features.superpoint import SuperPoint
from mpsfm_tpu_torch.extraction.matchers.lightglue import LightGlue
from mpsfm_tpu_torch.mapper import registration as treg
from mpsfm_tpu_torch.scene import correspondences
from mpsfm_tpu_torch.utils import io as tio

from synthetic import PlaneScene, render_scene_dir
from test_torch_metric3d import TINY
from test_torch_netvlad import _fake_mat
from test_torch_pipeline_dense import merged, run_jax_modes

ROOT = Path(__file__).resolve().parents[1]
REL, COMMON, POINTS_REL = 1e-4, 0.99, 0.01
LG = {"dim": 256, "num_heads": 4, "n_layers": 9, "dtype": "float32"}
PORT_CONFIGS = ["custom", "sp-lg_m3dv2", "sp-lg_m3dv2-small", "sp-lg_m3dv2-large"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_checkpoints(d):
    """superpoint_v1.pth, superpoint_lightglue.pth (the identity-block
    LightGlue), metric_depth_vit_small_800k.pth (TINY, depth_model.
    prefixes) and a small Pitts30K_struct.mat, from the JAX package's
    params. Returns their paths by role."""
    d.mkdir(parents=True, exist_ok=True)
    sp = JSuperPoint()
    sp.init_random(0)
    torch.save(convert.superpoint_state_dict(jax.tree.map(np.asarray, sp.params)), d / "superpoint_v1.pth")
    lg = JLightGlue(LG)
    lg.init_random(0)
    p = jax.tree.map(lambda x: np.array(x), lg.params)
    for blk in [f"{kind}_{l}" for l in range(LG["n_layers"]) for kind in ("self", "cross")]:
        p[blk]["ffn1"]["w"][:] = 0
        p[blk]["ffn1"]["b"][:] = 0
    p["input_proj"]["w"] = np.eye(256, dtype=np.float32)
    p["final_proj"]["w"] = 80 * np.eye(256, dtype=np.float32)
    p["matchability"]["w"][:] = 0
    p["matchability"]["b"][:] = 10
    torch.save(convert.lightglue_state_dict(p, LG["n_layers"]), d / "superpoint_lightglue.pth")
    m = JMetric3Dv2(TINY)
    m.init_random(0)
    torch.save(convert.metric3d_state_dict({k: np.asarray(v) for k, v in m.params.items()}, "depth_model."),
               d / "metric_depth_vit_small_800k.pth")
    _fake_mat(d / "Pitts30K_struct.mat", np.random.default_rng(4))
    return {"features": d / "superpoint_v1.pth", "matcher": d / "superpoint_lightglue.pth",
            "depth": d / "metric_depth_vit_small_800k.pth", "retrieval": d / "Pitts30K_struct.mat"}


def conf_for(ckpt):
    return {"matches_mode": "sparse",
            "extractors": {"features": "superpoint", "matcher": "lightglue", "depth": "metric3dv2-small",
                           "pairs_type": "retrieval", "n_retrieval": 3, "retrieval": "netvlad",
                           "resize_max": 0, "feature_conf": {"weights_path": str(ckpt["features"]),
                                                             "max_keypoints": 1024},
                           "matcher_conf": {"weights_path": str(ckpt["matcher"]), **LG},
                           "depth_conf": {"weights_path": str(ckpt["depth"]), **TINY},
                           "retrieval_conf": {"weights_path": str(ckpt["retrieval"]), "resize_max": 160}},
            "mapper": {"int_covs": False, "ba": {"max_iters": 10}, "registration": {"num_hyp": 256}},
            "image_priors": {"cg_max_iter": 150, "max_iter": 3}}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The render, the checkpoints, and the JAX package's reconstruct of it
    in a subprocess (its HDF5 caches in <scene>/cache)."""
    tmp = tmp_path_factory.mktemp("neural")
    rng = np.random.default_rng(0)
    scene = PlaneScene(rng=rng, n_images=5, n_points=0, img_wh=(320, 240), focal=260.0, baseline=0.3)
    data = render_scene_dir(scene, tmp / "render", rng=rng, depth_noise=0.01)
    ckpt = write_checkpoints(tmp / "weights")
    shutil.copytree(data, tmp / "jax" / "scene")
    (tmp / "conf.json").write_text(json.dumps(conf_for(ckpt)))
    out = run_jax_modes([("neural", str(tmp / "jax" / "scene"), str(tmp / "conf.json"), str(tmp / "jax" / "out"))])
    return dict(tmp=tmp, data=data, scene=scene, ckpt=ckpt, jax=out["neural"], cache=tmp / "jax" / "scene" / "cache")


def test_stores_equal_jax(jax_run, tmp_path):
    """(a)."""
    conf = load_cfg(jax_run["tmp"] / "conf.json")
    ex = TExtraction(conf.extractors, TParser(jax_run["data"]), tmp_path / "cache", device="cpu")
    pairs = ex.extract_pairs()
    ex.extract_features()
    ex.extract_matches(pairs)
    ex.extract_mono()
    jc = jax_run["cache"]
    assert tio.read_pairs(jc / "pairs.txt") == pairs and len(pairs) < 10  # retrieval kept a subset of the 10
    names = TParser(jax_run["data"]).image_names()
    kp = {}
    for name in names:
        kj = tio.get_keypoints(jc / "feats-superpoint.h5", name)
        kt = tio.get_keypoints(ex.paths["sfeats"], name)
        idx = {tuple(k): i for i, k in enumerate(kj.tolist())}
        common = [(idx[tuple(k)], i) for i, k in enumerate(kt.tolist()) if tuple(k) in idx]
        assert len(common) >= COMMON * max(len(kj), len(kt)) and len(kt) > 300, name
        a, b = np.array(common).T
        dj = tio.get_descriptors(jc / "feats-superpoint.h5", name)[a]
        dt = tio.get_descriptors(ex.paths["sfeats"], name)[b]
        step = np.spacing(np.abs(dj).astype(np.float16)).astype(np.float64)  # one float16 step of each value
        assert (np.abs(dj - dt) <= step + 1e-6).all(), name
        kp[name] = (kj, kt)
    total = 0
    for n0, n1 in pairs:
        sets = []
        for which, path in ((0, jc / "matches-lightglue.h5"), (1, ex.paths["smatches"])):
            m, _ = tio.get_matches(path, n0, n1)
            sets.append({(tuple(kp[n0][which][i]), tuple(kp[n1][which][j])) for i, j in m})
        assert sets[0] == sets[1], (n0, n1)
        total += len(sets[1])
    assert total > 20
    for name in names:
        mj = tio.get_mono_map(jc / "depth-metric3dv2-small.h5", name)
        mt = tio.get_mono_map(ex.paths["depth"], name)
        assert mj.keys() == mt.keys() and {"depth", "normals", "valid"} <= set(mt)
        for k in mj:
            x, y = np.asarray(mj[k]), np.asarray(mt[k])
            if x.dtype == bool:
                np.testing.assert_array_equal(x, y)
            else:
                assert np.abs(x - y).max() <= REL * np.abs(x).max(), (name, k)


def test_decisions_equal_jax_from_its_caches(jax_run, tmp_path):
    """(b)."""
    from test_torch_registration import jax_draws

    scene_path = tmp_path / "scene"
    shutil.copytree(jax_run["tmp"] / "jax" / "scene", scene_path)
    kept = {}
    base = tpipeline.MpsfmMapper

    def mapper(*a, **k):
        kept["mapper"] = base(*a, **k)
        return kept["mapper"]

    verified = []
    estimate = correspondences.estimate_two_view_geometry_batch

    def verify(pairs, *a, **k):
        verified.append(len(pairs))
        return estimate(pairs, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treg, "_draw", jax_draws)
        mp.setattr(tpipeline, "MpsfmMapper", mapper)
        mp.setattr(correspondences, "estimate_two_view_geometry_batch", verify)
        rec, ok = tpipeline.reconstruct(scene_path, conf=load_cfg(jax_run["tmp"] / "conf.json"),
                                        sfm_outputs_dir=tmp_path / "out", device="cpu")
    j = jax_run["jax"]
    order = [i for i in kept["mapper"].nextview.registration_order if i is not None]
    assert verified == [0]  # the JAX run's verification was read from its cache
    assert bool(ok) == j["ok"] and order == j["order"] and sorted(rec.reg_image_ids()) == j["registered"], (order, j)
    assert abs(rec.num_points3D() - j["points"]) <= POINTS_REL * j["points"], (rec.num_points3D(), j)


@pytest.mark.parametrize("name", PORT_CONFIGS)
def test_configs_build_the_ports_models(jax_run, tmp_path, name):
    """(c) each config as the CLI loads it, with the tiny checkpoints in its
    weights paths: SuperPoint, LightGlue and (sp-lg_m3dv2*) the Metric3Dv2
    of its size; without weights SuperPoint is refused (RuntimeError, not
    NotImplementedError); custom.yaml maps the scene."""
    cfg = load_cfg(ROOT / "configs" / f"{name}.yaml")
    ex_conf = cfg.extractors
    assert ex_conf.features == "superpoint" and ex_conf.matcher == "lightglue"
    parser = TParser(jax_run["data"])
    with pytest.raises(RuntimeError, match="SuperPoint selected but no weights_path"):
        TExtraction(ex_conf, parser, tmp_path / "none", device="cpu").extract_features()
    ck = jax_run["ckpt"]
    tiny = {k: v for k, v in TINY.items() if k != "encoder"}  # the config's name picks the encoder
    over = {"extractors": {"feature_conf": {"weights_path": str(ck["features"]), "max_keypoints": 1024},
                           "matcher_conf": {"weights_path": str(ck["matcher"]), **LG}, "resize_max": 0,
                           "depth_conf": {"weights_path": str(ck["depth"]), **tiny}}}
    cfg = cfg.merged(over)
    ex = TExtraction(cfg.extractors, parser, tmp_path / "c", device="cpu")
    assert isinstance(ex._get_feature_model(), SuperPoint) and isinstance(ex._get_matcher(), LightGlue)
    if name == "custom":  # mapped to its end on a copy of the first 3 images
        assert cfg.matches_mode == "sparse+measured"
        data = tmp_path / "three"
        shutil.copytree(jax_run["data"], data)
        for i in (3, 4):
            (data / "images" / f"im{i:02d}.png").unlink()
            (data / "depth" / f"im{i:02d}.npy").unlink()
        rec, ok = tpipeline.reconstruct(data, conf=cfg, sfm_outputs_dir=tmp_path / "out", device="cpu")
        assert rec.num_images() == 3 and (data / "cache" / "matches-lightglue.h5").exists()
        assert (tmp_path / "out" / "images.txt").exists()
    else:
        be = tpriors.get_prior_backend(cfg.extractors.depth, dict(cfg.extractors.depth_conf), device="cpu")
        assert isinstance(be.backend, tpriors._Metric3DBackend)
        size = cfg.extractors.depth.rsplit("-", 1)[-1]
        assert be.backend.net.conf["encoder"] == {"small": "vit_small_reg", "large": "vit_large_reg",
                                                  "giant2": "vit_giant2_reg"}[size]


def test_paper_config_still_raises_naming_dsine(jax_run, tmp_path):
    cfg = load_cfg(ROOT / "configs" / "paper" / "sp-lg_m3dv2.yaml")
    assert cfg.extractors.normals == "dsine-kappa-fc"
    ex = TExtraction(cfg.extractors, TParser(jax_run["data"]), tmp_path / "c", device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        ex.extract_mono()


def test_chip_smoke_neural_phase_on_the_cpu():
    """(d) the phase at its small size, every device the CPU (no launch
    counted): checkpoints written and loaded manifest-free at small widths,
    the nets card-vs-CPU comparison against itself, K4 checks skipped (no
    kernel launched; the bfloat16 agreement run compares the plain attention
    with itself), the pipeline under the sp-lg_m3dv2-small conf to its end."""
    out, launches, k4 = chip_smoke.neural_phase("cpu", {}, "small")
    ag, k4_launches = out["full"]["bf16_agreement"], out["full"]["k4_launches"]
    assert ag["share"] == 1.0 and ag["entries"] > 0 and ag["matches_k4"] == ag["matches_plain"]
    assert all(k4_launches[dt] == {"attention": 0, "attention_tc": 0, "forwards": k4_launches[dt]["forwards"]}
               and k4_launches[dt]["forwards"] > 0 for dt in ("bfloat16", "float32"))
    assert out["pipeline"]["reached_end"] and out["pipeline"]["stores"] == {"features", "matches", "depth", "pairs"}
    assert out["pipeline"]["pairs_from"] == "netvlad" and out["pipeline"]["depth_equal"]
    assert out["card_vs_cpu"]["ok"] and launches == {} and k4 == {}


def test_chip_smoke_neural_conf_is_the_small_config():
    """The phase's conf is configs/sp-lg_m3dv2-small.yaml as the port loads
    it, with NetVLAD retrieval and the directory store."""
    cfg = load_cfg(ROOT / "configs" / "sp-lg_m3dv2-small.yaml")
    want = merged(json.loads(json.dumps(cfg)), {"extractors": {"retrieval": "netvlad"}, "cache_format": "npy",
                                                "mapper": {"ba": {"dist_ba": "off"}}})
    assert chip_smoke.NEURAL_CONF == want
