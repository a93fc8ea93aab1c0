"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface and is compiled by nvcc for Hopper
(sm_90a) into its own shared library, loaded with ctypes. Nothing is
built when this module is imported: the first wrapper call on a CUDA
tensor builds what it needs, and `build_all()` builds every source at once
with one nvcc process per source, all started together. Libraries land in
`mpsfm_tpu_torch/_build/` (listed in .gitignore) under a name that hashes
the sources of csrc/ and the flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


class Kernel:
    """One csrc/<source> library: its ctypes signatures, its build, and the
    count of launches its wrapper made (the wrapper adds one each time it
    launches the kernel on the card)."""

    def __init__(self, name: str, source: str, signatures: dict):
        self.name = name
        self.source = CSRC / source
        self.signatures = signatures
        self.launches = 0
        self.build_log = ""  # nvcc's output of this process's build (ptxas: registers, spills)
        self._lib = None

    def _target(self) -> Path:
        # the source and every file of csrc/ (a .cu may include another)
        srcs = b"".join(p.read_bytes() for p in (self.source, *sorted(CSRC.glob("*.cu*"))))
        h = hashlib.sha256(srcs + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{h}.so"

    def _start_build(self):
        """Popen of nvcc for this source, or None when the library is built."""
        target = self._target()
        if target.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp, target

    def _finish_build(self, job):
        proc, tmp, target = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {target.name}:\n{out}")
        self.build_log = out
        os.replace(tmp, target)

    def lib(self):
        if self._lib is None:
            job = self._start_build()
            if job is not None:
                self._finish_build(job)
            lib = ctypes.CDLL(str(self._target()))
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args):
        """Call a C entry point; it returns cudaGetLastError() of its launches."""
        rc = getattr(self.lib(), fn)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn}: CUDA error {rc}")


class Launches:
    """The launch count of a kernel that shares another Kernel's library:
    its wrapper adds one where it launches that kernel."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def build_all(kernels) -> float:
    """Build every kernel's library in parallel (one nvcc each); returns
    the wall seconds it took."""
    t0 = time.perf_counter()
    jobs = [k._start_build() for k in kernels]
    try:
        for k, job in zip(kernels, jobs):
            if job is not None:
                k._finish_build(job)
    finally:  # a failed build leaves no other nvcc running
        for job in jobs:
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    for k in kernels:
        k.lib()
    return time.perf_counter() - t0


def stream_ptr(t) -> int:
    """The current CUDA stream of the tensor's device, as an int for ctypes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def all_kernels():
    from mpsfm_tpu_torch.ba.cholesky import KERNEL as k1
    from mpsfm_tpu_torch.ba.cholesky import KERNEL_MANY as k1_many
    from mpsfm_tpu_torch.extraction.matchers.attention import KERNEL as k4
    from mpsfm_tpu_torch.extraction.matchers.attention import KERNEL_TC as k4_tc
    from mpsfm_tpu_torch.integration.bini_diag import KERNEL as k3
    from mpsfm_tpu_torch.integration.bini_fused import KERNEL as k2

    return [k1, k1_many, k2, k3, k4, k4_tc]
