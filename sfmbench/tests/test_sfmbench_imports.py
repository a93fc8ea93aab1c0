"""The references import neither jax nor the JAX package nor the port,
compared by the top-level name of each module, whole."""

import subprocess
import sys

from conftest import HERE

CODE = """
import importlib.util, pathlib, sys
for p in sorted(pathlib.Path(sys.argv[1]).glob('*.py')):
    spec = importlib.util.spec_from_file_location('r_' + p.stem, p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))
"""


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", CODE, str(HERE / "reference")], capture_output=True, text=True,
                         check=True).stdout.split()
    assert not {"jax", "jaxlib", "flax", "mpsfm_tpu", "mpsfm_tpu_torch"} & set(out)
    assert "torch" in out


def test_the_harness_guard_compares_whole_names(monkeypatch):
    from sfmb import bench

    monkeypatch.setitem(sys.modules, "mpsfm_tpu_torch_x", sys)
    assert "mpsfm_tpu" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in bench.forbidden_modules()
