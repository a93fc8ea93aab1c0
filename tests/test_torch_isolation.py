"""The port stands alone: it imports neither jax nor the JAX package, its
state-creating entry points refuse to fall back to the CPU, and
chip_smoke.py gives no result without a card or without the package.

The import check runs in a subprocess because tests/conftest.py imports
jax and mpsfm_tpu into this one.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu_torch import convert, resolve_device
from mpsfm_tpu_torch.ba import dense
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
print(len(names), bad)
need = {"mpsfm_tpu_torch.ba.covariance", "mpsfm_tpu_torch.integration.bini_diag", "mpsfm_tpu_torch.scene.image_priors"}
sys.exit(1 if bad or len(names) < 14 or not need <= set(names) else 0)
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
