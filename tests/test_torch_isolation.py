"""The port stands alone: it imports neither jax nor the JAX package (nor,
at import time, PyYAML or h5py), its state-creating entry points refuse
to fall back to the CPU, and chip_smoke.py gives no result without a card
or without the package.

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
# the scene, config and utils modules (and everything else) import neither
# parser at import time: the card's host need not have them
bad += sorted(m for m in ("yaml", "h5py") if m in sys.modules)
print(len(names), bad)
need = {"mpsfm_tpu_torch.ba.covariance", "mpsfm_tpu_torch.integration.bini_diag", "mpsfm_tpu_torch.scene.image_priors",
        "mpsfm_tpu_torch.mapper.depth_consistency", "mpsfm_tpu_torch.geometry.linalg",
        "mpsfm_tpu_torch.geometry.projection", "mpsfm_tpu_torch.geometry.triangulation",
        "mpsfm_tpu_torch.estimators.essential", "mpsfm_tpu_torch.estimators.homography",
        "mpsfm_tpu_torch.estimators.pnp", "mpsfm_tpu_torch.estimators.ransac", "mpsfm_tpu_torch.estimators.two_view",
        "mpsfm_tpu_torch.config", "mpsfm_tpu_torch.utils.interp", "mpsfm_tpu_torch.utils.io",
        "mpsfm_tpu_torch.utils.profiling", "mpsfm_tpu_torch.native", "mpsfm_tpu_torch.scene.corrgraph",
        "mpsfm_tpu_torch.scene.reconstruction", "mpsfm_tpu_torch.scene.correspondences",
        "mpsfm_tpu_torch.scene.priors", "mpsfm_tpu_torch.ba.problem", "mpsfm_tpu_torch.ba.shift_scale",
        "mpsfm_tpu_torch.mapper.optimizer"}
sys.exit(1 if bad or len(names) < 41 or not need <= set(names) else 0)
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
