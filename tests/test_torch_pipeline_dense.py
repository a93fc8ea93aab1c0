"""The extraction modes off the main path on the port (slice 10): dense NCC
matches, dense-anchored matches, pair-depth priors and sky masks, in the
Extraction facade and the pipeline, against the JAX package on the CPU.

(a) Caches: the JAX package's Extraction and the port's write the dense,
    anchored, pair-depth and mask caches of one rendered scene; each
    package reads the other's HDF5 files, and they hold the same fields
    (keypoints and masks equal, certainties within 1e-5, the same dtypes);
    the port's directory store holds what its HDF5 files hold. The
    anchoring runs on the JAX package's features in both packages.
(b) load_correspondence_inputs in the sparse+dense and dense modes from
    the JAX package's caches: the same keypoints, index offsets, matches
    and scores.
(c) tests/test_dense_retrieval_masks.py's mask wiring on the port.
(d) The JAX package's reconstruct maps a 3-image 160×120 scene in each
    mode (in one subprocess), then the port maps it from the JAX run's
    caches with JAX's registration draws: the same registered images in
    the same order, points within 1%, ATE within 1e-3.
(e) The port's CLI in the pair-depth mode, the twin of
    tests/test_pipeline_e2e.py::test_cli_pipeline_pair_depth_mode.
(f) chip_smoke.dense_modes_phase rehearsed on the CPU at its small size.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu.datasets.simple import SimpleParser as JParser
from mpsfm_tpu.extraction.base import Extraction as JExtraction
from mpsfm_tpu.utils import io as jio
from mpsfm_tpu_torch import pipeline as tpipeline
from mpsfm_tpu_torch.config import load_cfg
from mpsfm_tpu_torch.datasets.simple import SimpleParser as TParser
from mpsfm_tpu_torch.extraction.base import Extraction as TExtraction
from mpsfm_tpu_torch.mapper import registration as treg
from mpsfm_tpu_torch.scene import correspondences
from mpsfm_tpu_torch.utils import io as tio

from synthetic import PlaneScene, render_scene_dir
from test_torch_pipeline import ate

ROOT = Path(__file__).resolve().parents[1]
CERT_TOL, POINTS_REL, ATE_TOL = 1e-5, 0.01, 1e-3
EXTRACT = {"features": "classical", "matcher": "nn", "feature_conf": {"max_keypoints": 256}, "resize_max": 0,
           "masks": "heuristic", "dense_matcher_conf": {"certainty_threshold": 0.5}}
# tests/test_pipeline_e2e.py's conf at 512 keypoints, in each mode
BASE = {"extractors": {"features": "classical", "matcher": "nn", "pairs_type": "exhaustive",
                       "feature_conf": {"max_keypoints": 512}, "resize_max": 0},
        "mapper": {"int_covs": False, "ba": {"max_iters": 10}, "registration": {"num_hyp": 256}},
        "image_priors": {"cg_max_iter": 150, "max_iter": 3,
                         "depth": {"prior_uncertainty": True, "depth_uncertainty": None, "prior_std_multiplier": 1.0}}}
MODES = {
    "sparse+dense+measured": {"matches_mode": "sparse+dense+measured", "extractors": {"masks": "heuristic"}},
    "dense+measured": {"matches_mode": "dense+measured"},
    "sparse+measured+depth": {"matches_mode": "sparse+measured+depth"},
    "dense_anchor": {"matches_mode": "sparse+measured", "extractors": {"matcher": "dense_anchor"}},
}

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
for mode, scene, conf, out in json.loads(%(jobs)r):
    rec, ok = pipeline.reconstruct(scene, conf=load_cfg(conf), sfm_outputs_dir=out)
    print("RESULT " + json.dumps({
        "mode": mode, "ok": bool(ok),
        "order": [int(i) for i in kept["mapper"].nextview.registration_order if i is not None],
        "registered": sorted(int(i) for i in rec.reg_image_ids()),
        "points": rec.num_points3D(),
        "centers": {int(i): rec.images[i].pose.center().tolist() for i in rec.reg_image_ids()},
    }), flush=True)
"""


@pytest.fixture(autouse=True)
def few_threads():
    """The tier-1 run shares the host's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def merged(a, b):
    out = json.loads(json.dumps(a))
    for k, v in b.items():
        out[k] = merged(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def render(path, n_images=3, img_wh=(160, 120), focal=130.0, seed=0):
    rng = np.random.default_rng(seed)
    scene = PlaneScene(rng=rng, n_images=n_images, n_points=0, img_wh=img_wh, focal=focal, baseline=0.3)
    return scene, render_scene_dir(scene, path, rng=rng, depth_noise=0.01)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return render(tmp_path_factory.mktemp("dense") / "scene")[1]


def store_items(path):
    """{group path: {dataset: array}} of a store, either format."""
    out = {}

    def walk(g, prefix):
        for k in g.keys():
            obj = g[k]
            key = f"{prefix}/{k}" if prefix else k
            if tio.is_group(obj):
                walk(obj, key)
            else:
                out.setdefault(prefix, {})[k] = np.asarray(obj)

    with tio.open_store(path) as f:
        walk(f, "")
    return out


def assert_same_store(a, b, cert_tol=0.0):
    A, B = store_items(a), store_items(b)
    assert A.keys() == B.keys() and A
    for g in A:
        assert A[g].keys() == B[g].keys()
        for k in A[g]:
            x, y = A[g][k], B[g][k]
            assert x.dtype == y.dtype and x.shape == y.shape, (g, k)
            if k == "certainty":
                np.testing.assert_allclose(x, y, atol=cert_tol)
            else:
                assert np.array_equal(x, y), (g, k)


def copy_store(src, dst):
    """Every group and dataset of the store src into a new store dst (the
    other format), with the keypoints' attributes."""
    with tio.open_store(src) as f, tio.open_store(dst, "w") as g:
        for grp, items in store_items(src).items():
            for k, v in items.items():
                g.create_dataset(f"{grp}/{k}" if grp else k, data=v)
            if grp and "keypoints" in items:
                g[f"{grp}/keypoints"].attrs["uncertainty"] = f[grp]["keypoints"].attrs["uncertainty"]


def extract_all(ex):
    """Every cache of the dense modes, the anchoring last."""
    pairs = ex.extract_pairs()
    ex.extract_features()
    ex.extract_dense_matches(pairs)
    ex.extract_matches_dense_anchored(pairs)
    ex.extract_pair_depths(pairs)
    ex.extract_masks()
    return pairs


def test_dense_caches_equal_and_read_across_packages(scene_dir, tmp_path):
    """(a) and (b)."""
    jdir, hdir, ndir = tmp_path / "jax", tmp_path / "port_h5", tmp_path / "port_npy"
    jex = JExtraction(EXTRACT, JParser(scene_dir), jdir)
    pairs = extract_all(jex)
    # the port anchors on the JAX package's features: copied into each store first
    hdir.mkdir()
    shutil.copy(jdir / "feats-classical.h5", hdir / "feats-classical.h5")
    copy_store(jdir / "feats-classical.h5", ndir / "feats-classical.npyd")
    tex = TExtraction(EXTRACT, TParser(scene_dir), hdir, device="cpu")
    assert extract_all(tex) == pairs
    nex = TExtraction({**EXTRACT, "cache_format": "npy"}, TParser(scene_dir), ndir, device="cpu")
    extract_all(nex)
    for stem in ("dense-dense_ncc", "matches-dense_ncc-anchored", "pair-depth-dense_ncc", "masks"):
        assert_same_store(jdir / f"{stem}.h5", hdir / f"{stem}.h5", CERT_TOL)
        assert_same_store(hdir / f"{stem}.h5", ndir / f"{stem}.npyd")
    assert sum(len(v["matches0"][v["matches0"] >= 0]) for v in store_items(hdir / "matches-dense_ncc-anchored.h5")
               .values()) > 30
    # each package's loaders on the other's HDF5 files
    for ex, other in ((jex, hdir), (tex, jdir)):
        ex.paths.update(dpairs=other / "dense-dense_ncc.h5", masks=other / "masks.h5",
                        pair_depth=other / "pair-depth-dense_ncc.h5")
    for name0, name1 in pairs + [p[::-1] for p in pairs]:
        (k0, k1, c), (j0, j1, jc) = tex.load_dense_pair(name0, name1), jex.load_dense_pair(name0, name1)
        assert np.array_equal(k0, j0) and np.array_equal(k1, j1) and np.abs(c - jc).max() <= CERT_TOL
    for name in TParser(scene_dir).image_names():
        m = tex.load_mask(name)
        assert m.dtype == bool and np.array_equal(m, jex.load_mask(name))
        jm, tm = jex.load_mono_from_pairs(name, pairs), tex.load_mono_from_pairs(name, pairs)
        assert jm.keys() == tm.keys() and all(np.array_equal(jm[k], tm[k]) for k in jm)
    # (b): the port's loader on the JAX package's caches
    for mode in ("sparse+dense", "dense"):
        jex = JExtraction({**EXTRACT, "matches_mode": mode}, JParser(scene_dir), jdir)
        jex.extract_matches(pairs)
        tex = TExtraction({**EXTRACT, "matches_mode": mode}, TParser(scene_dir), jdir, device="cpu")
        kj, mj, sj = jex.load_correspondence_inputs(pairs)
        kt, mt, st = tex.load_correspondence_inputs(pairs)
        assert kj.keys() == kt.keys() and mj.keys() == mt.keys() and sj.keys() == st.keys()
        assert all(np.array_equal(kj[n], kt[n]) for n in kj)
        assert all(np.array_equal(mj[p], mt[p]) and np.array_equal(sj[frozenset(p)], st[frozenset(p)]) for p in mj)
        n_sparse = len(jio.get_keypoints(jdir / "feats-classical.h5", pairs[0][0])) if "sparse" in mode else 0
        assert mt[pairs[0]][:, 0].max() >= n_sparse and mt[pairs[0]][:, 0].max() < len(kt[pairs[0][0]])


def test_pair_depths_skip_only_an_image_without_sensor_depth(tmp_path):
    """An image without sensor depth under the measured backend is left out
    of its pairs' depth store, as in the JAX package; any other fault of the
    backend surfaces."""
    _, sdir = render(tmp_path / "scene")
    names = TParser(sdir).image_names()
    (sdir / "depth" / (Path(names[0]).stem + ".npy")).unlink()
    conf = {**EXTRACT, "depth": "measured"}
    jex, tex = JExtraction(conf, JParser(sdir), tmp_path / "jax"), TExtraction(conf, TParser(sdir), tmp_path / "port",
                                                                               device="cpu")
    pairs = jex.extract_pairs()
    jex.extract_pair_depths(pairs)
    tex.extract_pair_depths(pairs)
    assert_same_store(tmp_path / "jax" / "pair-depth-dense_ncc.h5", tmp_path / "port" / "pair-depth-dense_ncc.h5")
    items = store_items(tmp_path / "port" / "pair-depth-dense_ncc.h5")
    # one group per (pair, image): each of the two pairs with the first image keeps only the other one
    assert {g.split("/")[-1] for g in items} == {Path(n).name for n in names[1:]}
    assert len(items) == 2 * len(pairs) - 2

    def broken(*a, **k):
        raise RuntimeError("backend fault")

    tex = TExtraction(conf, TParser(sdir), tmp_path / "port", extract="d", device="cpu")
    tex.depth_backend = broken
    with pytest.raises(RuntimeError, match="backend fault"):
        tex.extract_pair_depths(pairs)


def test_mask_extraction_wiring(tmp_path):
    """(c) tests/test_dense_retrieval_masks.py's case on the port: the masks
    store, and the mask reaching the Depth prior."""
    from mpsfm_tpu_torch.scene.image_priors import ImagePriors

    scene = PlaneScene(rng=np.random.default_rng(2), n_images=2, img_wh=(96, 72), focal=80.0, baseline=0.2)
    render_scene_dir(scene, tmp_path / "scene", rng=np.random.default_rng(2))
    parser = TParser(tmp_path / "scene")
    ex = TExtraction({"masks": "heuristic"}, parser, tmp_path / "cache", device="cpu")
    path = ex.extract_masks()
    assert path is not None and path.exists()
    name = parser.image_names()[0]
    mask = ex.load_mask(name)
    assert mask is not None and mask.dtype == bool and mask.shape == (72, 96)
    rec = parser.build_reconstruction()
    imid = next(iter(rec.images))
    H, W = 72, 96
    half = np.ones((H, W), bool)
    half[: H // 2] = False
    d = np.full((H, W), 2.0)
    pri = ImagePriors(
        {}, rec, imid,
        depth_dict={"depth": d, "depth_variance": d * 0.01, "valid": d > 0},
        normals_dict={"normals": np.tile([0.0, 0, -1], (H, W, 1)), "normals_variance": np.full((H, W), 0.01)},
        mask=half, device="cpu",
    )
    iv = np.asarray(pri.depth.valid)
    assert iv[iv.shape[0] // 4].mean() < 0.1  # masked top half invalid
    assert iv[(3 * iv.shape[0]) // 4].mean() > 0.9
    assert TExtraction({}, parser, tmp_path / "cache", device="cpu").extract_masks() is None


def run_jax_modes(jobs):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = JAX_RUNNER % {"root": str(ROOT), "jobs": json.dumps(jobs)}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=1200,
                         cwd=ROOT)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    out = {}
    for ln in res.stdout.splitlines():
        if ln.startswith("RESULT "):
            r = json.loads(ln[len("RESULT "):])
            r["centers"] = {int(k): v for k, v in r["centers"].items()}
            out[r["mode"]] = r
    return out


def test_pipeline_decisions_equal_jax_in_each_mode(tmp_path):
    """(d)."""
    from test_torch_registration import jax_draws

    scene, data_dir = render(tmp_path / "render")
    jobs = []
    for mode, over in MODES.items():
        d = tmp_path / mode.replace("+", "_")
        shutil.copytree(data_dir, d / "scene")
        (d / "conf.json").write_text(json.dumps(merged(BASE, over)))
        jobs.append((mode, str(d / "scene"), str(d / "conf.json"), str(d / "jax_out")))
    jax_out = run_jax_modes(jobs)
    estimate = correspondences.estimate_two_view_geometry_batch
    for mode, scene_path, conf, _ in jobs:
        cache = Path(scene_path) / "cache"
        before = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()}
        verified = []

        def verify(pairs, *a, **k):
            verified.append(len(pairs))
            return estimate(pairs, *a, **k)

        kept = {}
        base = tpipeline.MpsfmMapper

        def mapper(*a, **k):
            kept["mapper"] = base(*a, **k)
            return kept["mapper"]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(treg, "_draw", jax_draws)
            mp.setattr(correspondences, "estimate_two_view_geometry_batch", verify)
            mp.setattr(tpipeline, "MpsfmMapper", mapper)
            rec, ok = tpipeline.reconstruct(scene_path, conf=load_cfg(conf),
                                            sfm_outputs_dir=Path(scene_path).parent / "port_out", device="cpu")
        # every cache of the JAX run was a hit (the measured depth is written anew by both packages)
        after = {p.name: p.stat().st_mtime_ns for p in cache.iterdir()}
        assert {k for k in after if after[k] != before.get(k)} <= {"depth-measured.h5", "two_view_geometry.h5"}, mode
        assert verified == [0], mode
        j = jax_out[mode]
        order = [i for i in kept["mapper"].nextview.registration_order if i is not None]
        port_centers = {i: rec.images[i].pose.center() for i in rec.reg_image_ids()}
        assert ok and j["ok"] and len(j["registered"]) >= 2, (mode, j)
        assert order == j["order"] and sorted(rec.reg_image_ids()) == j["registered"], (mode, order, j)
        assert abs(rec.num_points3D() - j["points"]) <= POINTS_REL * j["points"], (mode, rec.num_points3D(), j)
        if len(j["registered"]) >= 3:
            assert abs(ate(port_centers, scene) - ate(j["centers"], scene)) <= ATE_TOL, mode


def test_cli_pipeline_pair_depth_mode(tmp_path):
    """(e) the port's CLI (--device cpu) on tests/test_pipeline_e2e.py's
    scene and conf in the sparse+measured+depth mode: >= 4 of 5 registered,
    and the pair-depth cache keyed by pair and image."""
    import h5py

    scene, data_dir = render(tmp_path / "scene", n_images=5, img_wh=(320, 240), focal=260.0)
    conf = tmp_path / "conf.json"
    conf.write_text(json.dumps(merged(BASE, {"matches_mode": "sparse+measured+depth",
                                             "extractors": {"feature_conf": {"max_keypoints": 1024}}})))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run([sys.executable, "-m", "mpsfm_tpu_torch.cli", "--conf", str(conf), "--data_dir",
                          str(data_dir), "--sfm_outputs_dir", str(tmp_path / "out"), "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "success=True" in res.stdout, res.stdout[-2000:] + res.stderr[-2000:]
    from mpsfm_tpu_torch.utils.colmap_io import read_text

    assert len(read_text(tmp_path / "out").registered_images) >= 4
    pd = list((data_dir / "cache").glob("pair-depth-*.h5"))
    assert pd, list((data_dir / "cache").iterdir())
    with h5py.File(pd[0], "r") as f:
        some = []
        f.visit(some.append)
        assert any(k.endswith("depth") for k in some)


def test_chip_smoke_dense_modes_phase_on_the_cpu():
    """(f) the phase at its small size, every device the CPU (no launch
    counted, no kernel held)."""
    out, launches, k1 = chip_smoke.dense_modes_phase("cpu", {}, "small")
    assert launches == {} and k1 is None
    assert out["registered"] == 3 and sum(out["dense_per_pair"]) > 500
    assert out["devices"] == {k: {"cpu"} for k in ("features", "matches", "populate", "mapper", "dense", "masks")}
    assert out["small"]["anchored"]["inlier_share"] > chip_smoke.ANCHOR_INLIERS
    assert out["small"]["pair depth"]["depth_entries"] > 0
    assert out["card_vs_cpu"]["ncc_share"] == 1.0 and out["card_vs_cpu"]["sky_share"] == 1.0


def test_chip_smoke_dense_conf_is_the_pipeline_conf():
    """The phase's confs: the pipeline phase's in the sparse+dense+measured
    mode with heuristic masks; the e2e conf with the anchored matcher and
    in the pair-depth mode."""
    assert chip_smoke.DENSE_CONF == merged(chip_smoke.PIPELINE_CONF, {"matches_mode": "sparse+dense+measured",
                                                                      "extractors": {"masks": "heuristic"}})
    assert chip_smoke.ANCHOR_CONF == merged(chip_smoke.E2E_CONF, {"extractors": {"matcher": "dense_anchor"}})
    assert chip_smoke.PAIR_DEPTH_CONF == merged(chip_smoke.E2E_CONF, {"matches_mode": "sparse+measured+depth"})
    assert chip_smoke.DENSE == dict(chip_smoke.PIPELINE, n_images=5)
