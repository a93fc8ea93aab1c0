"""The port stands alone, parallel/ and the neural extraction included: it
imports neither jax nor the JAX package nor, at import time, OpenCV,
onnxruntime, PyYAML, h5py or scipy.io (the image decoder, the artifact
store and the intrinsics reader of the main path, the dense matcher, the
sky masks and the nets need none of them), reads none of the JAX
package's files (the pinned checkpoint manifests are its own copies), its
state-creating entry points refuse to fall back to the CPU, and
chip_smoke.py gives no result without a card or without the package.
The card-only cases hold the dense NCC flow, the sky masks and the neural
extraction, card against CPU, at chip_smoke.py's shapes.

The import check runs in a subprocess because tests/conftest.py imports
jax and mpsfm_tpu into this one.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu_torch import convert, resolve_device
from mpsfm_tpu_torch.ba import dense
from mpsfm_tpu_torch.estimators.two_view import estimate_two_view_geometry_batch
from mpsfm_tpu_torch.integration.bini import Integrator

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import mpsfm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mpsfm_tpu_torch.__path__, "mpsfm_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "mpsfm_tpu.")) or m == "mpsfm_tpu")
# the scene, config, utils, extraction and pipeline modules (and everything
# else) import neither parser at import time: the card's host need not have them
bad += sorted(m for m in ("yaml", "h5py") if m in sys.modules)
need = {"mpsfm_tpu_torch.ba.covariance", "mpsfm_tpu_torch.integration.bini_diag", "mpsfm_tpu_torch.scene.image_priors",
        "mpsfm_tpu_torch.mapper.depth_consistency", "mpsfm_tpu_torch.geometry.linalg",
        "mpsfm_tpu_torch.geometry.projection", "mpsfm_tpu_torch.geometry.triangulation",
        "mpsfm_tpu_torch.estimators.essential", "mpsfm_tpu_torch.estimators.homography",
        "mpsfm_tpu_torch.estimators.pnp", "mpsfm_tpu_torch.estimators.ransac", "mpsfm_tpu_torch.estimators.two_view",
        "mpsfm_tpu_torch.config", "mpsfm_tpu_torch.utils.interp", "mpsfm_tpu_torch.utils.io",
        "mpsfm_tpu_torch.utils.profiling", "mpsfm_tpu_torch.native", "mpsfm_tpu_torch.scene.corrgraph",
        "mpsfm_tpu_torch.scene.reconstruction", "mpsfm_tpu_torch.scene.correspondences",
        "mpsfm_tpu_torch.scene.priors", "mpsfm_tpu_torch.ba.problem", "mpsfm_tpu_torch.ba.shift_scale",
        "mpsfm_tpu_torch.ba.solver", "mpsfm_tpu_torch.ba.schur_sparse",
        "mpsfm_tpu_torch.mapper.optimizer", "mpsfm_tpu_torch.mapper.image_selection",
        "mpsfm_tpu_torch.mapper.triangulator", "mpsfm_tpu_torch.mapper.registration", "mpsfm_tpu_torch.mapper.mapper",
        "mpsfm_tpu_torch.utils.workqueue", "mpsfm_tpu_torch.utils.colmap_io", "mpsfm_tpu_torch.datasets.simple",
        "mpsfm_tpu_torch.extraction.pairs", "mpsfm_tpu_torch.extraction.features.classical",
        "mpsfm_tpu_torch.extraction.matchers.nn", "mpsfm_tpu_torch.extraction.priors",
        "mpsfm_tpu_torch.extraction.base", "mpsfm_tpu_torch.eval", "mpsfm_tpu_torch.pipeline", "mpsfm_tpu_torch.cli",
        "mpsfm_tpu_torch.parallel", "mpsfm_tpu_torch.parallel.dist_ba", "mpsfm_tpu_torch.parallel.multihost",
        "mpsfm_tpu_torch.parallel.sharded_inference", "mpsfm_tpu_torch.extraction.matchers.dense_ncc",
        "mpsfm_tpu_torch.extraction.guided_filter", "mpsfm_tpu_torch.extraction.masks",
        "mpsfm_tpu_torch.extraction.manifest", "mpsfm_tpu_torch.extraction.weights",
        "mpsfm_tpu_torch.extraction.features.superpoint", "mpsfm_tpu_torch.extraction.matchers.attention",
        "mpsfm_tpu_torch.extraction.matchers.lightglue", "mpsfm_tpu_torch.extraction.retrieval",
        "mpsfm_tpu_torch.extraction.nets", "mpsfm_tpu_torch.extraction.nets.depth_anything",
        "mpsfm_tpu_torch.extraction.nets.metric3d", "mpsfm_tpu_torch.extraction.nets.depth_pro",
        "mpsfm_tpu_torch.extraction.nets.mono", "mpsfm_tpu_torch.extraction.nets.train_mono",
        "mpsfm_tpu_torch.utils.viz", "mpsfm_tpu_torch.vars"}
# the pinned manifests are the port's own copies, not the JAX package's files
from mpsfm_tpu_torch.extraction import manifest
bad += [] if manifest.MANIFEST_DIR.parent.parent.name == "mpsfm_tpu_torch" else [str(manifest.MANIFEST_DIR)]
# the neural extraction imports scipy only to read a .mat checkpoint, when called
bad += sorted(m for m in ("scipy.io",) if m in sys.modules)
# the card's host has no OpenCV and no onnxruntime: no module of the port imports them at import time
bad += sorted(m for m in ("cv2", "onnxruntime") if m in sys.modules)
print(len(names), bad)
sys.exit(1 if bad or len(names) < 60 or not need <= set(names) else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_converters_refuse_the_cpu_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays = {f: np.zeros(3, np.float32) for f in dense.DenseBAData._fields}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.dense_ba_data(arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.anchor_state(np.zeros((1, 6, 2)), np.zeros((1, 2)), np.zeros((1, 3, 3)), [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.ba_data(chip_smoke.ba_arrays(chip_smoke.synthetic_bundle(2, 8)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dense.densify(chip_smoke.synthetic_bundle(2, 8), 2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Integrator()
    assert resolve_device("cpu").type == "cpu"
    assert convert.dense_ba_data(arrays, device="cpu").quat.device.type == "cpu"


def test_new_converters_and_estimators_refuse_the_cpu_without_a_card(monkeypatch):
    """The converters of the cameras, poses and depth-consistency inputs, and
    the two-view entry point, put their state on the card or raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam = {"fx": 500.0, "fy": 500.0, "cx": 320.0, "cy": 240.0, "width": 640, "height": 480}
    pose = (np.array([1.0, 0, 0, 0]), np.zeros(3))
    image = (np.ones((4, 5), np.float32), np.ones((4, 5), np.float32), np.eye(3, dtype=np.float32), *pose)
    pair = (SimpleNamespace(**cam), SimpleNamespace(**cam), np.zeros((9, 2)), np.zeros((9, 2)),
            np.stack([np.arange(9)] * 2, -1))
    for call in (lambda: convert.camera(cam), lambda: convert.rigid(*pose), lambda: convert.dc_inputs(image, [image]),
                 lambda: estimate_two_view_geometry_batch([pair])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert convert.camera(cam, device="cpu").fx.device.type == "cpu"
    assert convert.rigid(*pose, device="cpu").quat.dtype == torch.float32
    args = convert.dc_inputs(image, [image, image], device="cpu")
    assert [tuple(a.shape) for a in args] == [(4, 5), (4, 5), (3, 3), (2,), (2, 4, 5), (2, 4, 5), (2, 3, 3), (2, 32)]


def test_chip_smoke_gives_no_result_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_mapper_entry_points_refuse_the_cpu_without_a_card(monkeypatch):
    """MpsfmMapper, Registration and DepthConsistencyChecker run on the card
    unless the caller asks for the CPU: without one their default raises."""
    from mpsfm_tpu_torch.mapper import MpsfmMapper
    from mpsfm_tpu_torch.mapper.depth_consistency import DepthConsistencyChecker
    from mpsfm_tpu_torch.mapper.registration import Registration, run_ransac_pnp
    from mpsfm_tpu_torch.scene.correspondences import Correspondences
    from mpsfm_tpu_torch.scene.reconstruction import Reconstruction

    rec = Reconstruction()
    corr = Correspondences({}, rec, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: MpsfmMapper({}, rec, corr), lambda: Registration({}, rec, corr, None),
                 lambda: DepthConsistencyChecker({}, rec),
                 lambda: run_ransac_pnp(np.zeros((8, 3)), np.zeros((8, 2)), 1e-4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mapper = MpsfmMapper({}, rec, corr, device="cpu")
    assert mapper.optimizer.device.type == mapper.registration.device.type == mapper.dc.device.type == "cpu"


def test_dense_and_mask_entry_points_refuse_the_cpu_without_a_card(monkeypatch):
    """The dense matcher, its registry, the sky masks and the heuristic on a
    host array run on the card unless the caller asks for the CPU; a tensor
    keeps its own device."""
    from mpsfm_tpu_torch.extraction.base import get_dense_matcher
    from mpsfm_tpu_torch.extraction.masks import SkyMask, sky_mask_heuristic
    from mpsfm_tpu_torch.extraction.matchers.dense_ncc import DenseNCCMatcher

    img = np.zeros((16, 20, 3), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: DenseNCCMatcher(), lambda: get_dense_matcher("dense_ncc"), lambda: SkyMask(),
                 lambda: sky_mask_heuristic(img)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert sky_mask_heuristic(img, device="cpu").device.type == "cpu"
    assert sky_mask_heuristic(torch.as_tensor(img)).device.type == "cpu"


def test_neural_extraction_entry_points_refuse_the_cpu_without_a_card(monkeypatch):
    """SuperPoint, LightGlue, NetVLAD and Metric3Dv2 put their weights on the
    card unless the caller asks for the CPU; a Metric3Dv2 backend with a
    checkpoint builds its net on the card."""
    from mpsfm_tpu_torch.extraction.features.superpoint import SuperPoint
    from mpsfm_tpu_torch.extraction.matchers.lightglue import LightGlue
    from mpsfm_tpu_torch.extraction.nets.metric3d import Metric3Dv2
    from mpsfm_tpu_torch.extraction.retrieval import NetVLAD

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: SuperPoint(), lambda: LightGlue(), lambda: NetVLAD(), lambda: Metric3Dv2()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    lg = LightGlue({"dim": 32, "num_heads": 2, "n_layers": 1}, device="cpu")
    lg.init_random(0)
    assert lg.params["self_0"]["Wqkv"]["w"].device.type == "cpu"


@pytest.mark.cuda
def test_neural_extraction_card_vs_cpu():
    """chip_smoke.neural_card_vs_cpu at its small size: SuperPoint,
    LightGlue (K4), NetVLAD and Metric3Dv2-small on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = chip_smoke.neural_card_vs_cpu(torch.device("cuda"), chip_smoke.NEURAL_SIZES["small"])
    assert out["ok"], out


@pytest.mark.cuda
def test_dense_ncc_and_masks_card_vs_cpu():
    """chip_smoke.dense_card_vs_cpu on the card: the NCC flow of a 640×480
    pair, the sky heuristic at 640×480 and the onnx path at 701×800."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (60, 80)).astype(np.float32)
    A = np.kron(base, np.ones((8, 8), np.float32))
    pair = [A, np.roll(A, (3, 6), axis=(0, 1))]
    out = chip_smoke.dense_card_vs_cpu(torch.device("cuda"), chip_smoke.DENSE_SIZES["full"], pair)
    assert out["ncc_share"] >= chip_smoke.NCC_FLOW_SHARE and out["sky_share"] >= chip_smoke.MASK_SHARE


@pytest.mark.cuda
def test_sky_heuristic_card_vs_cpu_on_seeded_bands():
    """The heuristic mask on the card and on the CPU over seeded 480×640
    images with a sky band, and the pyrDown ladder bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mpsfm_tpu_torch.extraction.masks import pyr_down_ladder, sky_mask_heuristic

    for seed in range(3):
        rng = np.random.default_rng(seed)
        img = chip_smoke.sky_image(rng, (480, 640))
        g = sky_mask_heuristic(img, device="cuda").cpu()
        c = sky_mask_heuristic(img, device="cpu")
        assert (g == c).double().mean() >= chip_smoke.MASK_SHARE
        u8 = chip_smoke.onnx_image(rng, (1400, 1500))
        assert torch.equal(pyr_down_ladder(torch.as_tensor(u8, device="cuda")).cpu(),
                           pyr_down_ladder(torch.as_tensor(u8)))
