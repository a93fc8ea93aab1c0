"""The main path from images on the port (slice 7): reconstruct over a
rendered RGB-D directory (tests/synthetic.render_scene_dir: PNG images,
.npy depth, intrinsics.yaml), on the CPU.

(a) The JAX package's reconstruct maps a scene (in a subprocess, as its CLI
    runs; its caches in the scene's cache directory), then the port's
    reconstruct(device="cpu") maps it from the JAX run's caches: features,
    matches, pairs and the verification (the TVG cache) are hits, and the
    registration RANSACs take JAX's draws. Mapping decisions are then
    compared apart from extraction rounding: the same registered images in
    the same order, the same point count, ATE equal to 1e-4.
(b) The port's own extraction end to end meets the assertions of
    tests/test_pipeline_e2e.py::test_cli_pipeline_on_rendered_scene (>= 4/5
    registered, > 50 points, ATE < 0.1); its text and binary COLMAP models
    parse with the JAX package's readers, with the same images and points;
    its depth output holds the same fields in either store.
(c) The port's CLI in a subprocess with --device cpu, twice: the second run
    takes every artifact from the caches.
(d) Without a card, the default device raises.

The 5-image 320×240 twin of (a) is slow (the JAX package compiles its whole
pipeline, ~2 min on two cores); tier-1 keeps a 4-image 160×120 twin with 512
keypoints. Also slow: tests/test_fused_refine.py's fused-vs-classic case on
the port. The card-only case maps the small scene of chip_smoke.py on the
card and on the CPU.

JAX is imported only inside the tests that run it (and in their subprocess),
so the card-only case collects on a host without the JAX package's
dependencies.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu_torch import pipeline as tpipeline
from mpsfm_tpu_torch.config import load_cfg
from mpsfm_tpu_torch.mapper import registration as treg
from mpsfm_tpu_torch.scene import correspondences
from mpsfm_tpu_torch.utils import colmap_io as tcolmap
from mpsfm_tpu_torch.utils import io as tio

from synthetic import PlaneScene, render_scene_dir, umeyama_alignment

ROOT = Path(__file__).resolve().parents[1]
# tests/test_pipeline_e2e.py's conf
PIPE_CONF = """
matches_mode: sparse+measured
extractors:
  features: classical
  matcher: nn
  pairs_type: exhaustive
  feature_conf:
    max_keypoints: {kps}
  resize_max: 0
mapper:
  int_covs: false
  ba:
    max_iters: 10
  registration:
    num_hyp: 256
image_priors:
  cg_max_iter: 150
  max_iter: 3
  depth:
    prior_uncertainty: true
    depth_uncertainty: null
    prior_std_multiplier: 1.0
"""
E2E = dict(n_images=5, img_wh=(320, 240), focal=260.0, kps=1024)
SMALL = dict(n_images=4, img_wh=(160, 120), focal=130.0, kps=512)

JAX_RUNNER = r"""
import json, sys
sys.path.insert(0, %(root)r)
import jax
jax.config.update("jax_platforms", "cpu")
from mpsfm_tpu import pipeline
from mpsfm_tpu.config import load_cfg

kept = {}


class Mapper(pipeline.MpsfmMapper):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        kept["mapper"] = self


pipeline.MpsfmMapper = Mapper
rec, ok = pipeline.reconstruct(%(scene)r, conf=load_cfg(%(conf)r), sfm_outputs_dir=%(out)r)
print("RESULT " + json.dumps({
    "ok": bool(ok),
    "order": [int(i) for i in kept["mapper"].nextview.registration_order if i is not None],
    "registered": sorted(int(i) for i in rec.reg_image_ids()),
    "points": rec.num_points3D(),
    "centers": {int(i): rec.images[i].pose.center().tolist() for i in rec.reg_image_ids()},
}))
"""


@pytest.fixture(autouse=True)
def few_threads():
    """The tier-1 run shares the host's cores among its workers: torch's CPU
    ops take two threads in these tests, so that the workers do not
    oversubscribe the cores (results agree across thread counts to the
    tolerances below)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def render(tmp_path, n_images, img_wh, focal, kps, seed=0):
    """A rendered scene (tests/test_pipeline_e2e.py's PlaneScene) and the
    path of its conf."""
    rng = np.random.default_rng(seed)
    scene = PlaneScene(rng=rng, n_images=n_images, n_points=0, img_wh=img_wh, focal=focal, baseline=0.3)
    data_dir = render_scene_dir(scene, tmp_path / "scene", rng=rng, depth_noise=0.01)
    conf = tmp_path / "conf.yaml"
    conf.write_text(PIPE_CONF.format(kps=kps))
    return scene, data_dir, conf


def ate(centers, scene):
    """ATE of {image id: centre} against the render's poses (the image id
    is the index of imNN.png)."""
    ids = sorted(centers)
    est = np.stack([np.asarray(centers[i]) for i in ids])
    gt = np.stack([scene.poses[i].center() for i in ids])
    s, R, t = umeyama_alignment(est, gt)
    return float(np.sqrt((((s * (R @ est.T)).T + t - gt) ** 2).sum(-1).mean()))


def run_jax(data_dir, conf, out):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = JAX_RUNNER % {"root": str(ROOT), "scene": str(data_dir), "conf": str(conf), "out": str(out)}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=1200,
                         cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    out["centers"] = {int(k): v for k, v in out["centers"].items()}
    return out


def run_port(data_dir, conf, out, **kw):
    """The port's reconstruct on the CPU; returns (rec, ok, mapper)."""
    kept = {}
    base = tpipeline.MpsfmMapper

    def mapper(*a, **k):
        kept["mapper"] = base(*a, **k)
        return kept["mapper"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipeline, "MpsfmMapper", mapper)
        rec, ok = tpipeline.reconstruct(data_dir, conf=load_cfg(conf), sfm_outputs_dir=out, device="cpu", **kw)
    return rec, ok, kept["mapper"]


def decisions_equal_jax(tmp_path, size):
    """(a): the port maps from the JAX run's caches with JAX's draws."""
    from test_torch_registration import jax_draws

    scene, data_dir, conf = render(tmp_path, **size)
    jax_out = run_jax(data_dir, conf, tmp_path / "jax_out")
    cache = data_dir / "cache"
    before = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()}
    verified = []

    def verify(pairs, *a, **k):
        verified.append(len(pairs))
        return estimate(pairs, *a, **k)

    estimate = correspondences.estimate_two_view_geometry_batch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treg, "_draw", jax_draws)
        mp.setattr(correspondences, "estimate_two_view_geometry_batch", verify)
        rec, ok, mapper = run_port(data_dir, conf, tmp_path / "port_out")
    # every cache of the JAX run was a hit: features, matches and pairs untouched (the measured depth
    # is written anew by use_measured in both packages), no pair verified again
    after = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()}
    assert {k for k in after if after[k] != before.get(k)} <= {"depth-measured.h5", "two_view_geometry.h5"}
    assert verified == [0]
    port_centers = {i: rec.images[i].pose.center() for i in rec.reg_image_ids()}
    order = [i for i in mapper.nextview.registration_order if i is not None]
    ate_j, ate_t = ate(jax_out["centers"], scene), ate(port_centers, scene)
    assert ok and jax_out["ok"]
    assert order == jax_out["order"] and sorted(rec.reg_image_ids()) == jax_out["registered"]
    assert rec.num_points3D() == jax_out["points"], (rec.num_points3D(), jax_out["points"])
    assert abs(ate_t - ate_j) <= 1e-4, (ate_t, ate_j)
    return jax_out, rec


def test_pipeline_decisions_equal_jax_small(tmp_path):
    _, rec = decisions_equal_jax(tmp_path, SMALL)
    assert rec.num_reg_images() == SMALL["n_images"]


@pytest.mark.slow
def test_pipeline_decisions_equal_jax_e2e(tmp_path):
    _, rec = decisions_equal_jax(tmp_path, E2E)
    assert rec.num_reg_images() >= 4


def _depth_fields(path):
    with tio.open_store(path) as f:
        return {n: ({k: np.asarray(f[n][k]) for k in f[n].keys()}, dict(f[n].attrs)) for n in f.keys()}


def test_pipeline_own_extraction_meets_the_e2e_bounds(tmp_path):
    """(b) on tests/test_pipeline_e2e.py's scene and conf."""
    from mpsfm_tpu.eval import ate_between as jate_between
    from mpsfm_tpu.eval import rotation_errors_deg as jrot
    from mpsfm_tpu.utils import colmap_io as jcolmap

    from mpsfm_tpu_torch.eval import ate_between, rotation_errors_deg

    scene, data_dir, conf = render(tmp_path, **E2E)
    out = tmp_path / "out"
    rec, ok, _ = run_port(data_dir, conf, out)
    assert ok
    for name in ("cameras.txt", "images.txt", "points3D.txt", "cameras.bin", "images.bin", "points3D.bin"):
        assert (out / name).exists()
    for read in (jcolmap.read_text, jcolmap.read_binary, tcolmap.read_text, tcolmap.read_binary):
        back = read(out)
        assert {im.name for im in back.registered_images.values()} == {
            im.name for im in rec.registered_images.values()}
        assert back.num_points3D() == rec.num_points3D()
    back = jcolmap.read_text(out)
    assert len(back.registered_images) >= 4, f"registered {len(back.registered_images)}/5"
    assert back.num_points3D() > 50
    centers = {int(im.name[2:4]): im.pose.center() for im in back.registered_images.values()}
    assert ate(centers, scene) < 0.1
    # the evaluation module against the JAX package's, on the same two models
    ours, theirs = ate_between(tcolmap.read_text(out), tcolmap.read_binary(out)), jate_between(back,
                                                                                              jcolmap.read_binary(out))
    assert ours.keys() == theirs.keys() and all(np.allclose(ours[k], theirs[k], atol=1e-12)
                                                for k in ours if k != "per_image")
    assert np.allclose(rotation_errors_deg(tcolmap.read_text(out), rec), jrot(back, jcolmap.read_binary(out)),
                       atol=1e-6)
    # the depth output in either store: the same fields
    tcolmap.write_depths(rec, tmp_path / "depths.npyd")
    h5, npy = _depth_fields(out / "depths.h5"), _depth_fields(tmp_path / "depths.npyd")
    assert h5.keys() == npy.keys() and len(h5) == 5
    for n in h5:
        assert h5[n][0].keys() == npy[n][0].keys() and {"prior_depth", "uncertainty", "valid"} <= h5[n][0].keys()
        assert all(h5[n][0][k].dtype == npy[n][0][k].dtype and np.array_equal(h5[n][0][k], npy[n][0][k])
                   for k in h5[n][0])
        assert h5[n][1] == npy[n][1]


def test_pipeline_directory_store_equals_hdf5(tmp_path):
    """cache_format npy maps the scene as the HDF5 caches do (the same
    registered images and points), and writes no HDF5 file."""
    _, data_dir, conf = render(tmp_path, **SMALL)
    a, ok_a, _ = run_port(data_dir, conf, tmp_path / "h5")
    assert ok_a and (tmp_path / "h5" / "depths.h5").exists()
    cfg = load_cfg(conf).merged({"cache_format": "npy"})
    b, ok_b = tpipeline.reconstruct(data_dir, conf=cfg, cache_dir=tmp_path / "cache_npy",
                                    sfm_outputs_dir=tmp_path / "npy", device="cpu")
    assert ok_b and (tmp_path / "npy" / "depths.npyd").is_dir() and not (tmp_path / "npy" / "depths.h5").exists()
    assert sorted(a.reg_image_ids()) == sorted(b.reg_image_ids()) and a.num_points3D() == b.num_points3D()
    assert {p.suffix for p in (tmp_path / "cache_npy").iterdir()} == {".npyd", ".txt"}


def test_cli_on_the_cpu_and_from_its_caches(tmp_path):
    """(c) python -m mpsfm_tpu_torch.cli --device cpu, twice; the second run
    takes the pairs, features and matches from the caches (not rewritten)
    and maps the same points."""
    _, data_dir, conf = render(tmp_path, **SMALL)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"

    def cli(out):
        res = subprocess.run([sys.executable, "-m", "mpsfm_tpu_torch.cli", "--conf", str(conf), "--data_dir",
                              str(data_dir), "--sfm_outputs_dir", str(out), "--device", "cpu"],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
        return res.stdout

    first = cli(tmp_path / "out1")
    assert "success=True registered=4/4" in first, first[-500:]
    cache = data_dir / "cache"
    kept = ("feats-classical.h5", "matches-nn.h5", "pairs.txt")
    stamps = {n: (cache / n).stat().st_mtime_ns for n in kept}
    second = cli(tmp_path / "out2")
    assert "success=True registered=4/4" in second
    assert stamps == {n: (cache / n).stat().st_mtime_ns for n in kept}
    assert second.split("points=")[1].split()[0] == first.split("points=")[1].split()[0]


def test_without_a_card_the_default_device_raises(tmp_path, monkeypatch):
    """(d) reconstruct and the CLI run on the card unless asked for the CPU."""
    from mpsfm_tpu_torch import cli
    from mpsfm_tpu_torch.extraction.features.classical import ClassicalFeatures
    from mpsfm_tpu_torch.extraction.matchers.nn import MutualNNMatcher

    _, data_dir, conf = render(tmp_path, n_images=2, img_wh=(40, 30), focal=35.0, kps=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tpipeline.reconstruct(data_dir), lambda: cli.main(["--data_dir", str(data_dir)]),
                 lambda: ClassicalFeatures(), lambda: MutualNNMatcher()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (data_dir / "cache").exists()


def test_chip_smoke_conf_is_the_main_path_conf():
    """chip_smoke.py's MAIN_CONF is configs/classical-nn_measured.yaml;
    its pipeline conf adds only one card (dist_ba off) and the directory
    store."""
    assert chip_smoke.MAIN_CONF == load_cfg(ROOT / "configs" / "classical-nn_measured.yaml").to_dict()
    conf = load_cfg(ROOT / "configs" / "classical-nn_measured.yaml").merged(
        {"cache_format": "npy", "mapper": {"ba": {"dist_ba": "off"}}})
    assert conf.to_dict() == chip_smoke.PIPELINE_CONF
    import yaml

    # the e2e conf: tests/test_pipeline_e2e.py's, on one card and in the directory store

    ref = yaml.safe_load(PIPE_CONF.format(kps=1024))
    got = json.loads(json.dumps(chip_smoke.E2E_CONF))
    assert got.pop("cache_format") == "npy" and got["mapper"]["ba"].pop("dist_ba") == "off"
    assert got == ref


def test_chip_smoke_pipeline_helpers_on_the_cpu(tmp_path):
    """chip_smoke.py's rendered RGB-D directory through the port on the CPU:
    every stage on the device asked for, the written model read back, and
    the card-vs-CPU phase run CPU against CPU."""
    scene = chip_smoke.render_rgbd_dir(tmp_path / "s", **chip_smoke.PIPELINE_SMALL)
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == ["depth", "images", "intrinsics.yaml", "truth"]
    truth = tcolmap.read_text(tmp_path / "s" / "truth")
    assert [truth.images[i].name for i in truth.reg_image_ids()] == [f"im{i:02d}.png" for i in range(5)]
    with chip_smoke.devices_seen() as seen:
        rec, ok, _ = chip_smoke.run_pipeline(tmp_path / "s", chip_smoke.E2E_CONF, "cpu")
    assert seen == {k: {"cpu"} for k in ("features", "matches", "populate", "mapper")}
    assert ok and rec.num_reg_images() == 5 and chip_smoke.ate_rmse(rec, scene.poses) < chip_smoke.PIPELINE_ATE
    assert chip_smoke.check_written_model(rec, tmp_path / "s" / "sfm_outputs") <= 1e-6
    summ = chip_smoke.pipeline_card_vs_cpu(torch.device("cpu"))
    assert summ["cuda"]["registered"] == summ["cpu"]["registered"] == [0, 1, 2, 3, 4]


@pytest.mark.slow
def test_fused_refine_matches_classic_on_the_port(tmp_path, monkeypatch):
    """tests/test_fused_refine.py's case on the port: the main path's conf
    over its 6-image wedge scene, with the fused refinement and with
    MPSFM_FUSED_REFINE=0, the same decisions and nearly the same poses."""
    scene = PlaneScene(rng=np.random.default_rng(5), n_images=6, img_wh=(320, 240), focal=260.0, baseline=0.2,
                       wedge=True)
    data_dir = render_scene_dir(scene, tmp_path / "scene", rng=np.random.default_rng(5), depth_noise=0.01)
    conf = ROOT / "configs" / "classical-nn_measured.yaml"
    runs = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("MPSFM_FUSED_REFINE", fused)
        rec, ok, _ = run_port(data_dir, conf, tmp_path / f"out{fused}")
        assert ok
        runs[fused] = rec
    classic, fused = runs["0"], runs["1"]
    assert classic.num_reg_images() == fused.num_reg_images() == 6
    assert abs(classic.num_points3D() - fused.num_points3D()) <= 0.02 * classic.num_points3D()
    for imid, im in classic.registered_images.items():
        q_c, q_f = im.pose.q, fused.images[imid].pose.q
        if np.dot(q_c, q_f) < 0:
            q_f = -q_f
        assert np.abs(q_c - q_f).max() < 5e-3
        assert np.abs(im.pose.t - fused.images[imid].pose.t).max() < 2e-2


@pytest.mark.cuda
def test_small_pipeline_card_vs_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chip_smoke.pipeline_card_vs_cpu("cuda")
