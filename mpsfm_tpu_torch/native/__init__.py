"""The native (C++) track store, built at first use and loaded with ctypes
(port of mpsfm_tpu/native/__init__.py).

`trackstore.cpp` is compiled by one g++ invocation into
`mpsfm_tpu_torch/_build/` (listed in .gitignore) under a name that hashes
the source and the flags, so an edited source is rebuilt; nothing is built
when this module is imported. Unlike the JAX package, a failed build
raises with g++'s output: the port has no silent fallback to the Python
store (`scene.reconstruction.PyTrackStore` stays as the plain version the
tests hold this one against).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from mpsfm_tpu_torch.kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "trackstore.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtrackstore-{h}.so"


def _build(target: Path):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native track store is built with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")  # parallel builds each write their own file
    r = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, target)


def load():
    """The track store's library, built first if it is not."""
    global _lib
    if _lib is not None:
        return _lib
    target = library_path()
    if not target.exists():
        _build(target)
    lib = ctypes.CDLL(str(target))
    c = ctypes
    P = c.c_void_p
    i64 = c.c_int64
    lib.ts_create.restype = P
    lib.ts_destroy.argtypes = [P]
    lib.ts_add_image.argtypes = [P, i64, i64]
    lib.ts_num_points.restype = i64
    lib.ts_num_points.argtypes = [P]
    lib.ts_num_slots.restype = i64
    lib.ts_num_slots.argtypes = [P]
    lib.ts_add_point.restype = i64
    lib.ts_add_point.argtypes = [P, c.POINTER(c.c_double), c.POINTER(i64), i64]
    lib.ts_delete_point.argtypes = [P, i64]
    lib.ts_add_observation.restype = c.c_int32
    lib.ts_add_observation.argtypes = [P, i64, i64, i64]
    lib.ts_remove_observation.restype = c.c_int32
    lib.ts_remove_observation.argtypes = [P, i64, i64, i64]
    lib.ts_track_len.restype = i64
    lib.ts_track_len.argtypes = [P, i64]
    lib.ts_alive.restype = c.c_int32
    lib.ts_alive.argtypes = [P, i64]
    lib.ts_get_xyz.argtypes = [P, i64, c.POINTER(c.c_double)]
    lib.ts_set_xyz.argtypes = [P, i64, c.POINTER(c.c_double)]
    lib.ts_copy_xyz_bulk.argtypes = [P, c.POINTER(i64), i64, c.POINTER(c.c_double)]
    lib.ts_set_xyz_bulk.argtypes = [P, c.POINTER(i64), i64, c.POINTER(c.c_double)]
    lib.ts_get_track.restype = i64
    lib.ts_get_track.argtypes = [P, i64, c.POINTER(i64), i64]
    lib.ts_alive_pids.restype = i64
    lib.ts_alive_pids.argtypes = [P, c.POINTER(i64), i64]
    lib.ts_observations.restype = i64
    lib.ts_observations.argtypes = [P, c.POINTER(i64), i64, c.POINTER(i64), c.POINTER(i64), c.POINTER(i64), i64]
    lib.ts_image_point_ids.argtypes = [P, i64, c.POINTER(i64), i64]
    lib.ts_track_lens.argtypes = [P, c.POINTER(i64), i64, c.POINTER(c.c_int32)]
    _lib = lib
    return lib


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeTrackStore:
    """ctypes wrapper mirroring the Python track-store semantics."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.ts_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ts_destroy(self._h)
            self._h = None

    def add_image(self, imid: int, num_kps: int):
        self._lib.ts_add_image(self._h, imid, num_kps)

    def add_point(self, xyz, track) -> int:
        xyz = np.ascontiguousarray(xyz, np.float64)
        tr = np.ascontiguousarray(np.asarray(track, np.int64).reshape(-1))
        return int(self._lib.ts_add_point(self._h, _pf64(xyz), _p64(tr), len(tr) // 2))

    def delete_point(self, pid: int):
        self._lib.ts_delete_point(self._h, pid)

    def add_observation(self, pid, imid, kp) -> bool:
        return bool(self._lib.ts_add_observation(self._h, pid, imid, kp))

    def remove_observation(self, pid, imid, kp) -> bool:
        """Returns True if the point was auto-deleted."""
        return bool(self._lib.ts_remove_observation(self._h, pid, imid, kp))

    def track_len(self, pid) -> int:
        return int(self._lib.ts_track_len(self._h, pid))

    def alive(self, pid) -> bool:
        return bool(self._lib.ts_alive(self._h, pid))

    def num_points(self) -> int:
        return int(self._lib.ts_num_points(self._h))

    def num_slots(self) -> int:
        return int(self._lib.ts_num_slots(self._h))

    def get_xyz(self, pid):
        out = np.zeros(3, np.float64)
        self._lib.ts_get_xyz(self._h, pid, _pf64(out))
        return out

    def set_xyz(self, pid, v):
        v = np.ascontiguousarray(v, np.float64)
        self._lib.ts_set_xyz(self._h, pid, _pf64(v))

    def xyz_bulk(self, pids):
        pids = np.ascontiguousarray(pids, np.int64)
        out = np.zeros((len(pids), 3), np.float64)
        self._lib.ts_copy_xyz_bulk(self._h, _p64(pids), len(pids), _pf64(out))
        return out

    def set_xyz_bulk(self, pids, vals):
        pids = np.ascontiguousarray(pids, np.int64)
        vals = np.ascontiguousarray(vals, np.float64)
        self._lib.ts_set_xyz_bulk(self._h, _p64(pids), len(pids), _pf64(vals))

    def get_track(self, pid):
        n = self.track_len(pid)
        out = np.zeros(2 * max(n, 1), np.int64)
        self._lib.ts_get_track(self._h, pid, _p64(out), n)
        return [(int(out[2 * i]), int(out[2 * i + 1])) for i in range(n)]

    def alive_pids(self):
        cap = self.num_slots()
        out = np.zeros(max(cap, 1), np.int64)
        n = self._lib.ts_alive_pids(self._h, _p64(out), cap)
        return out[:n]

    def observations(self, pids):
        pids = np.ascontiguousarray(pids, np.int64)
        lens = np.zeros(len(pids), np.int32)
        self._lib.ts_track_lens(self._h, _p64(pids), len(pids), lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        cap = int(lens.sum())
        o_pid = np.zeros(max(cap, 1), np.int64)
        o_im = np.zeros(max(cap, 1), np.int64)
        o_kp = np.zeros(max(cap, 1), np.int64)
        n = self._lib.ts_observations(self._h, _p64(pids), len(pids), _p64(o_pid), _p64(o_im), _p64(o_kp), cap)
        return o_pid[:n], o_im[:n], o_kp[:n]

    def image_point_ids(self, imid, n_kps):
        out = np.full(n_kps, -1, np.int64)
        self._lib.ts_image_point_ids(self._h, imid, _p64(out), n_kps)
        return out
