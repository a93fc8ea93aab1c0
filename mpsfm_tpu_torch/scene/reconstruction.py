"""Flat-array reconstruction container (host state driving device programs;
port of mpsfm_tpu/scene/reconstruction.py).

Replaces COLMAP's Reconstruction + ObservationManager (the reference's L0
scene container). COLMAP's pointer-heavy C++ graph becomes flat numpy
arrays on the host: points live in a growable pool with validity masks,
tracks are per-point observation lists kept by the native track store,
and every geometric filter is evaluated as one vectorized pass over a
flat observation table instead of per-point C++ loops. Device (torch)
programs consume padded snapshots of these arrays. The host math is the
JAX package's, line for line, so both give the same state bit for bit.

Conventions:
  - image poses are cam_from_world (quat wxyz, t), float64 on host;
  - a keypoint's ``point3D_ids[kp] == -1`` means untriangulated;
  - deleted points stay in the pool with ``alive=False`` (masked rewrite
    semantics per SURVEY.md §7.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mpsfm_tpu_torch import native, resolve_device

INVALID = -1


def quat_rotate_np(q, v):
    # explicit component cross products: np.cross's moveaxis/broadcast
    # machinery dominated the mapper's host time at ~70k small calls per
    # scene (profile: 9.9s cumulative on the 12-image bench)
    v = np.asarray(v)
    qx, qy, qz = q[..., 1], q[..., 2], q[..., 3]
    w = q[..., 0]
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    ux = qy * vz - qz * vy
    uy = qz * vx - qx * vz
    uz = qx * vy - qy * vx
    uux = qy * uz - qz * uy
    uuy = qz * ux - qx * uz
    uuz = qx * uy - qy * ux
    out = np.empty(np.broadcast(v[..., 0], w).shape + (3,), np.result_type(q, v))
    out[..., 0] = vx + 2.0 * (w * ux + uux)
    out[..., 1] = vy + 2.0 * (w * uy + uuy)
    out[..., 2] = vz + 2.0 * (w * uz + uuz)
    return out


def quat_conj_np(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def quat_to_matrix_np(q):
    w, x, y, z = np.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    R = np.stack(
        [
            np.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            np.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            np.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        axis=-2,
    )
    return R


@dataclass
class Pose:
    """cam_from_world on host (numpy float64)."""

    q: np.ndarray  # (4,) wxyz
    t: np.ndarray  # (3,)

    @staticmethod
    def identity():
        return Pose(np.array([1.0, 0, 0, 0]), np.zeros(3))

    def transform(self, pts):
        return quat_rotate_np(self.q, pts) + self.t

    def inverse(self):
        qi = quat_conj_np(self.q)
        return Pose(qi, -quat_rotate_np(qi, self.t))

    def rotation_matrix(self):
        return quat_to_matrix_np(self.q)

    def center(self):
        return -quat_rotate_np(quat_conj_np(self.q), self.t)

    def matrix(self):
        return np.concatenate([self.rotation_matrix(), self.t[:, None]], axis=1)

    def copy(self):
        return Pose(self.q.copy(), self.t.copy())


@dataclass
class HostCamera:
    """Host camera record; ``.device()`` yields the port's Camera of tensors."""

    camera_id: int
    params: np.ndarray  # (fx, fy, cx, cy)
    width: int
    height: int
    # Integration-grid geometry (prior working resolution, SURVEY.md:
    # normscale 387, scene/reconstruction/base.py:27):
    int_width: int = 0
    int_height: int = 0

    @property
    def fx(self):
        return float(self.params[0])

    @property
    def fy(self):
        return float(self.params[1])

    @property
    def cx(self):
        return float(self.params[2])

    @property
    def cy(self):
        return float(self.params[3])

    @property
    def sx(self):
        """Image->integration-grid x scale."""
        return self.int_width / self.width if self.int_width else 1.0

    @property
    def sy(self):
        return self.int_height / self.height if self.int_height else 1.0

    def set_integration_grid(self, normscale: float):
        long_side = max(self.width, self.height)
        scale = normscale / long_side if long_side > normscale else 1.0
        self.int_width = int(round(self.width * scale))
        self.int_height = int(round(self.height * scale))

    def calibration_matrix(self):
        fx, fy, cx, cy = self.params[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    def cam_from_img(self, xy):
        xy = np.asarray(xy, dtype=np.float64)
        return (xy - np.array([self.cx, self.cy])) / np.array([self.fx, self.fy])

    def img_from_cam(self, xyn):
        return np.asarray(xyn) * np.array([self.fx, self.fy]) + np.array([self.cx, self.cy])

    def device(self, device="cuda"):
        """geometry.projection.Camera with float32 scalar tensors on `device`
        (the card unless the caller asks for the CPU)."""
        from mpsfm_tpu_torch.geometry.projection import Camera

        dev = resolve_device(device)
        return Camera(
            *(torch.tensor(np.float32(v), device=dev) for v in self.params[:4]),
            self.width,
            self.height,
        )

    def mean_focal(self):
        return 0.5 * (self.fx + self.fy)


@dataclass
class ImageRecord:
    """Per-image registration + keypoint state (priors attach separately)."""

    imid: int
    name: str
    camera_id: int
    keypoints: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float64))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))
    pose: Pose | None = None
    registered: bool = False
    kp_std: float = 1.0
    # MP-SfM failure-ladder state (reference: scene/image/base.py:71-77):
    ignore_matches_AP: dict = field(default_factory=dict)
    dc_times_inliers_resampled: int = 0
    last_dc_score: float | None = None
    failed_dc_check: bool = False
    failed_normal_registration: bool = False

    def num_points3D(self):
        return int((self.point3D_ids >= 0).sum())

    def observed_kp_ids(self):
        return np.where(self.point3D_ids >= 0)[0]

    @property
    def has_pose(self):
        return self.registered


class LazyCovDict(dict):
    """Point-covariance store with a deferred device fetch.

    The covariance program is dispatched asynchronously and parks
    (device tensor, pt_ids) here via ``set_pending``; the device->host
    read happens on the FIRST host access instead of at dispatch,
    overlapping the device compute with the mapper's host work in between
    (bundle finds, anchor building).

    Device consumers (the integration anchor path) read the covariances
    WITHOUT any host fetch through ``device_view()`` — the dispatched
    (P,3,3) tensor plus a pid->slot map, kept valid across host flushes
    and invalidated per-pid on pop/overwrite.
    """

    __slots__ = ("_pendings", "_dev", "_slot", "_dead", "_slot_arr")

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._pendings = []  # [(dev, pt_ids)], oldest first
        self._dev = None
        self._slot = {}
        self._dead = set()
        self._slot_arr = None  # lazy vectorized pid->slot lookup

    def set_pending(self, dev, pt_ids):
        # accumulate: flushing the previous dispatch here would be a
        # blocking device read per covs call even when nothing on the
        # host ever consumes it (device consumers use device_view)
        self._pendings.append((dev, pt_ids))
        self._dev = dev
        self._slot = {int(p): i for i, p in enumerate(pt_ids)}
        self._slot_arr = None
        # a fresh dispatch supersedes earlier deletions of these pids
        # (point ids are free-list-reused); deletions of OTHER pids keep
        # masking every older pending at flush time
        self._dead.difference_update(int(p) for p in pt_ids)

    def device_view(self):
        """(dev (P,3,3), {pid: slot}) of the most recent covariance
        dispatch, or None. No host transfer."""
        if self._dev is None:
            return None
        return self._dev, self._slot

    def slots_for(self, pids):
        """Vectorized pid -> device slot lookup (-1 where absent). No
        host transfer; replaces the anchor construction's per-point dict loop
        (profile: ~0.5s/scene at hundreds of anchors per call)."""
        pids = np.asarray(pids, np.int64)
        if self._dev is None or len(pids) == 0:
            return np.full(len(pids), -1, np.int64)
        if self._slot_arr is None:
            if self._slot:
                keys = np.fromiter(self._slot.keys(), np.int64, len(self._slot))
                vals = np.fromiter(self._slot.values(), np.int64, len(self._slot))
                arr = np.full(int(keys.max()) + 1, -1, np.int64)
                arr[keys] = vals
            else:
                arr = np.full(1, -1, np.int64)
            self._slot_arr = arr
        arr = self._slot_arr
        out = np.full(len(pids), -1, np.int64)
        inb = (pids >= 0) & (pids < len(arr))
        out[inb] = arr[pids[inb]]
        return out

    def _flush(self):
        if not self._pendings:
            return
        pendings, self._pendings = self._pendings, []
        for dev, pt_ids in pendings:  # oldest first: newer values win
            cov = dev.double().cpu().numpy()  # one read of the tensor
            for i, pid in enumerate(pt_ids):
                if int(pid) not in self._dead:
                    super().__setitem__(int(pid), cov[i])

    def get(self, *a):
        self._flush()
        return super().get(*a)

    def __getitem__(self, k):
        self._flush()
        return super().__getitem__(k)

    def __setitem__(self, k, v):
        self._flush()
        if self._slot.pop(int(k), None) is not None:  # host overwrite supersedes
            self._slot_arr = None
        super().__setitem__(k, v)

    def __contains__(self, k):
        self._flush()
        return super().__contains__(k)

    def __len__(self):
        self._flush()
        return super().__len__()

    def __iter__(self):
        self._flush()
        return super().__iter__()

    def pop(self, *a):
        # flush-free: deleting one entry must not force the device read
        # (filters pop hundreds of points right after a covs dispatch)
        if a:
            pid = int(a[0])
            if self._slot.pop(pid, None) is not None:
                self._slot_arr = None
            self._dead.add(pid)
            return super().pop(*a)
        self._flush()
        return super().pop(*a)

    def items(self):
        self._flush()
        return super().items()

    def keys(self):
        self._flush()
        return super().keys()

    def values(self):
        self._flush()
        return super().values()


class PyTrackStore:
    """Pure-Python track store with the NativeTrackStore interface and
    identical allocation semantics (LIFO free list, duplicate-observation
    skip, auto-delete below track length 2): the plain version the native
    store is held against. ``Reconstruction`` never falls back to it."""

    def __init__(self):
        self._p3d: dict[int, np.ndarray] = {}
        self._tracks: list[list[tuple[int, int]] | None] = []
        self._free: list[int] = []

    def add_image(self, imid: int, num_kps: int):
        self._p3d[imid] = np.full(num_kps, -1, np.int64)

    def num_slots(self):
        return len(self._tracks)

    def add_point(self, xyz, track) -> int:
        if self._free:
            pid = self._free.pop()
        else:
            pid = len(self._tracks)
            self._tracks.append(None)
        tr = []
        for imid, kp in track:
            if self._p3d[imid][kp] >= 0:
                continue
            tr.append((int(imid), int(kp)))
            self._p3d[imid][kp] = pid
        if not tr:
            self._free.append(pid)
            return -1
        self._tracks[pid] = tr
        return pid

    def add_observation(self, pid, imid, kp) -> bool:
        if self._p3d[imid][kp] >= 0:
            return False
        self._tracks[pid].append((int(imid), int(kp)))
        self._p3d[imid][kp] = pid
        return True

    def remove_observation(self, pid, imid, kp) -> bool:
        tr = self._tracks[pid]
        tr.remove((int(imid), int(kp)))
        self._p3d[imid][kp] = -1
        if len(tr) < 2:
            self.delete_point(pid)
            return True
        return False

    def delete_point(self, pid):
        for imid, kp in self._tracks[pid]:
            self._p3d[imid][kp] = -1
        self._tracks[pid] = None
        self._free.append(pid)

    def get_track(self, pid):
        tr = self._tracks[pid]
        return list(tr) if tr is not None else []

    def observations(self, pids):
        o_pid, o_im, o_kp = [], [], []
        for pid in np.asarray(pids, np.int64):
            tr = self._tracks[pid] if 0 <= pid < len(self._tracks) else None
            if tr is None:
                continue
            for imid, kp in tr:
                o_pid.append(pid)
                o_im.append(imid)
                o_kp.append(kp)
        return (
            np.asarray(o_pid, np.int64),
            np.asarray(o_im, np.int64),
            np.asarray(o_kp, np.int64),
        )


class _TracksView:
    """Read view with the legacy ``rec.tracks[pid] -> list | None`` shape."""

    def __init__(self, rec: "Reconstruction"):
        self._rec = rec

    def __getitem__(self, pid):
        pid = int(pid)
        if pid >= len(self._rec.alive) or not self._rec.alive[pid]:
            return None
        return self._rec._store.get_track(pid)


class Reconstruction:
    """The scene: cameras, images, point pool, tracks, and filter passes.

    Track adjacency (the pointer-chasing part of COLMAP's C++
    Reconstruction/ObservationManager) lives in the native C++ track store
    (mpsfm_tpu_torch/native/trackstore.cpp, built with g++ at the first
    Reconstruction; a failed build raises). The numpy pools
    (xyz/alive/track_len + per-image point3D_ids) remain the canonical
    device-feed layout and are kept in lockstep by the mutation methods.
    """

    def __init__(self):
        self.cameras: dict[int, HostCamera] = {}
        self.images: dict[int, ImageRecord] = {}
        self._name_to_imid: dict[str, int] = {}
        # Point pool (grow-only, masked deletes).
        cap = 1024
        self.xyz = np.zeros((cap, 3), np.float64)
        self.alive = np.zeros((cap,), bool)
        self.track_len = np.zeros((cap,), np.int32)
        self._store = native.NativeTrackStore()  # a failed g++ build raises
        self._store_synced: dict[int, int] = {}  # imid -> synced #kps
        self.tracks = _TracksView(self)
        self._num_points = 0
        # MP-SfM extras
        self.point_covs: dict[int, np.ndarray] = LazyCovDict()
        self.best_next_ref_imid: int | None = None
        self.last_ap_inlier_masks: dict = {}

    # --- images/cameras ---
    def add_camera(self, cam: HostCamera):
        self.cameras[cam.camera_id] = cam

    def add_image(self, im: ImageRecord):
        self.images[im.imid] = im
        self._name_to_imid[im.name] = im.imid

    def imid(self, name: str) -> int:
        return self._name_to_imid[name]

    def camera(self, imid: int) -> HostCamera:
        return self.cameras[self.images[imid].camera_id]

    def register_image(self, imid: int):
        self.images[imid].registered = True

    def deregister_image(self, imid: int):
        """Remove all observations of an image, then unregister it."""
        im = self.images[imid]
        for kp in np.where(im.point3D_ids >= 0)[0]:
            self.remove_observation(int(im.point3D_ids[kp]), imid, int(kp))
        im.registered = False
        im.pose = None

    @property
    def registered_images(self):
        return {i: im for i, im in self.images.items() if im.registered}

    def reg_image_ids(self):
        return [i for i, im in self.images.items() if im.registered]

    def num_reg_images(self):
        return len(self.reg_image_ids())

    def num_images(self):
        return len(self.images)

    # --- point pool ---
    def _grow_to(self, pid):
        cap = len(self.alive)
        new_cap = cap
        while new_cap <= pid:
            new_cap *= 2
        if new_cap == cap:
            return
        ext = new_cap - cap
        self.xyz = np.concatenate([self.xyz, np.zeros((ext, 3))])
        self.alive = np.concatenate([self.alive, np.zeros(ext, bool)])
        self.track_len = np.concatenate([self.track_len, np.zeros(ext, np.int32)])

    def _ensure_store_image(self, imid: int):
        n = len(self.images[imid].point3D_ids)
        prev = self._store_synced.get(imid)
        if prev is None:
            self._store.add_image(imid, n)
            self._store_synced[imid] = n
        elif prev != n:
            raise RuntimeError(
                f"image {imid} keypoint count changed after observations "
                f"were added ({prev} -> {n})"
            )

    def add_point3D(self, xyz, track: list[tuple[int, int]]) -> int:
        """track: list of (imid, kp_idx). Observations already holding a
        point are skipped (parity with ObservationManager.add_point3D)."""
        acc = []
        seen = set()
        for imid, kp in track:
            self._ensure_store_image(imid)
            o = (int(imid), int(kp))
            if o in seen or self.images[imid].point3D_ids[kp] >= 0:
                continue
            seen.add(o)
            acc.append(o)
        if not acc:
            return INVALID
        pid = int(self._store.add_point(np.asarray(xyz, np.float64), acc))
        self._grow_to(pid)
        self.xyz[pid] = xyz
        self.alive[pid] = True
        self.track_len[pid] = len(acc)
        for imid, kp in acc:
            self.images[imid].point3D_ids[kp] = pid
        self._num_points = max(self._num_points, pid + 1)
        return pid

    def add_observation(self, pid: int, imid: int, kp: int):
        if self.images[imid].point3D_ids[kp] >= 0:
            return
        self._ensure_store_image(imid)
        self._store.add_observation(pid, imid, kp)
        self.track_len[pid] += 1
        self.images[imid].point3D_ids[kp] = pid

    def remove_observation(self, pid: int, imid: int, kp: int):
        if self.track_len[pid] - 1 < 2:
            # the store auto-deletes: clear the survivors' kp slots first
            rem = [o for o in self._store.get_track(pid) if o != (int(imid), int(kp))]
            self._store.remove_observation(pid, imid, kp)
            self.images[imid].point3D_ids[kp] = INVALID
            for i2, k2 in rem:
                self.images[i2].point3D_ids[k2] = INVALID
            self._clear_slot(pid)
        else:
            self._store.remove_observation(pid, imid, kp)
            self.track_len[pid] -= 1
            self.images[imid].point3D_ids[kp] = INVALID

    def delete_point3D(self, pid: int):
        for imid, kp in self._store.get_track(pid):
            self.images[imid].point3D_ids[kp] = INVALID
        self._store.delete_point(pid)
        self._clear_slot(pid)

    def _clear_slot(self, pid: int):
        self.alive[pid] = False
        self.track_len[pid] = 0
        self.point_covs.pop(pid, None)

    def point_ids(self):
        return np.where(self.alive[: self._num_points])[0]

    def num_points3D(self):
        return int(self.alive.sum())

    def point_xyz(self, pids):
        return self.xyz[np.asarray(pids, dtype=np.int64)]

    # --- flat observation table ---
    def observations(self, pids=None):
        """Flat (obs_pid, obs_imid, obs_kp) arrays for given (or all) points
        — one bulk store call (C++ when available) instead of a per-point
        Python loop."""
        if pids is None:
            pids = self.point_ids()
        pids = np.asarray(pids, np.int64)
        if len(pids) == 0:
            z = np.zeros(0, np.int64)
            return z, z.copy(), z.copy()
        return self._store.observations(pids)

    # --- geometry helpers (vectorized host math) ---
    def project_points_into_image(self, imid: int, pids):
        """Returns (px (N,2), depth (N,))."""
        im = self.images[imid]
        cam = self.camera(imid)
        pts = self.xyz[np.asarray(pids, np.int64)]
        p_cam = im.pose.transform(pts)
        z = p_cam[:, 2]
        zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
        px = cam.img_from_cam(p_cam[:, :2] / zs[:, None])
        return px, z

    def project_image_3d_points(self, imid: int, pids=None):
        """Reference-parity helper (mixins/points3D_utils.py:9-29):
        returns (pts2dids, pids, kps_px, depth, success)."""
        im = self.images[imid]
        if pids is None:
            kp_ids = im.observed_kp_ids()
            if len(kp_ids) == 0:
                return None, None, None, None, False
            pids = im.point3D_ids[kp_ids]
        else:
            kp_ids = None
            pids = np.asarray(pids, np.int64)
        px, z = self.project_points_into_image(imid, pids)
        return kp_ids, pids, px, z, True

    def triangulation_angles(self, pids):
        """Max pairwise triangulation angle per point (degrees). Replaces the
        COLMAP fork's find_small_angle_points_mask (SURVEY.md §2.3 item (3)).

        One bulk observation pass + padded (chunk, K, K) pairwise reduction:
        max pairwise angle = arccos of the min pairwise |cos|, evaluated in
        chunks of points grouped by track length (bounded temp memory)."""
        pids = np.asarray(pids, np.int64)
        out = np.zeros(len(pids))
        if len(pids) == 0:
            return out
        o_pid, o_im, _ = self.observations(pids)
        if len(o_pid) == 0:
            return out
        max_im = max(self.images.keys())
        centers = np.zeros((max_im + 1, 3))
        reg = np.zeros(max_im + 1, bool)
        for imid, im in self.images.items():
            if im.registered:
                centers[imid] = im.pose.center()
                reg[imid] = True
        keep = reg[o_im]
        o_pid, o_im = o_pid[keep], o_im[keep]
        if len(o_pid) == 0:
            return out
        lookup = np.full(int(pids.max()) + 1, -1, np.int64)
        lookup[pids] = np.arange(len(pids))
        li = lookup[o_pid]
        rays = self.xyz[o_pid] - centers[o_im]
        rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
        counts = np.bincount(li, minlength=len(pids))
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        # observations are grouped by point in pids order already (store
        # iteration order); rays/starts/counts index that grouped stream.
        by_len = np.argsort(counts, kind="stable")
        sorted_counts = counts[by_len]
        i = int(np.searchsorted(sorted_counts, 2))  # skip tracks with <2 registered obs
        budget = 40_000_000  # floats of (n, K, K) temp
        while i < len(pids):
            K = int(sorted_counts[i])
            j = int(np.searchsorted(sorted_counts, K, side="right"))
            step = max(int(budget // (K * K)), 1)
            for a in range(i, j, step):
                sel = by_len[a : min(a + step, j)]
                idx = starts[sel][:, None] + np.arange(K)[None, :]
                R = rays[idx].astype(np.float32)  # (n, K, 3)
                dots = np.abs(np.einsum("nkd,nld->nkl", R, R))
                iu = np.triu_indices(K, 1)
                mind = dots[:, iu[0], iu[1]].min(axis=1)
                out[sel] = np.rad2deg(np.arccos(np.clip(mind, -1, 1)))
            i = j
        return out

    def tri_angle_cache(self):
        """Context manager: memoize per-point triangulation angles while
        geometry is frozen (e.g. across the per-image anchor builds of
        one bundle dispatch — the angles were recomputed per image,
        ~1.3s/scene of host time on the 12-image bench)."""
        from contextlib import contextmanager

        @contextmanager
        def _ctx():
            self._tri_cache = {}
            try:
                yield
            finally:
                self._tri_cache = None

        return _ctx()

    def find_points3D_with_small_triangulation_angle(self, min_angle, point3D_ids):
        if len(point3D_ids) == 0:
            return np.zeros(0, bool)
        cache = getattr(self, "_tri_cache", None)
        if cache is None:
            return self.triangulation_angles(point3D_ids) < min_angle
        pids = np.asarray(point3D_ids, np.int64)
        angles = np.array([cache.get(int(p), np.nan) for p in pids])
        miss = np.isnan(angles)
        if miss.any():
            fresh = self.triangulation_angles(pids[miss])
            angles[miss] = fresh
            for p, a in zip(pids[miss], fresh):
                cache[int(p)] = float(a)
        return angles < min_angle

    # --- filters (reference: mapper/base.py:686-797 via ObservationManager) ---
    def filter_observations_with_negative_depth(self):
        n = 0
        for imid, im in self.registered_images.items():
            kp_ids = im.observed_kp_ids()
            if len(kp_ids) == 0:
                continue
            pids = im.point3D_ids[kp_ids]
            _, z = self.project_points_into_image(imid, pids)
            bad = z < np.finfo(np.float64).eps
            for kp, pid in zip(kp_ids[bad], pids[bad]):
                self.remove_observation(int(pid), imid, int(kp))
                n += 1
        return n

    def _point_reproj_errors(self, pids):
        """Per-observation squared reprojection errors for given points.

        Returns (obs arrays, err_sq (n_obs,)). kp_std-normalized errors are
        applied by the caller via its threshold.
        """
        o_pid, o_im, o_kp = self.observations(pids)
        if len(o_pid) == 0:
            return (o_pid, o_im, o_kp), np.zeros(0)
        err = np.zeros(len(o_pid))
        for imid in np.unique(o_im):
            sel = o_im == imid
            im = self.images[imid]
            px, z = self.project_points_into_image(imid, o_pid[sel])
            kps = im.keypoints[o_kp[sel]]
            e = ((px - kps) ** 2).sum(-1)
            e = np.where(z > 0, e, np.inf)
            err[sel] = e
        return (o_pid, o_im, o_kp), err

    def filter_points3D(self, max_reproj_error, min_tri_angle, pids):
        """Delete bad observations / low-angle points. Returns #changed obs."""
        pids = np.asarray(sorted(set(int(p) for p in pids if self.alive[p])), np.int64)
        if len(pids) == 0:
            return 0
        changed = 0
        (o_pid, o_im, o_kp), err = self._point_reproj_errors(pids)
        bad = err > max_reproj_error**2
        for pid, imid, kp in zip(o_pid[bad], o_im[bad], o_kp[bad]):
            if self.alive[pid] and self.images[imid].point3D_ids[kp] == pid:
                self.remove_observation(int(pid), int(imid), int(kp))
                changed += 1
        still = [p for p in pids if self.alive[p]]
        if still:
            small = self.find_points3D_with_small_triangulation_angle(min_tri_angle, still)
            for pid, s in zip(still, small):
                if s:
                    changed += self.track_len[pid]
                    self.delete_point3D(int(pid))
        return changed

    def filter_all_points3D(self, max_reproj_error, min_tri_angle):
        return self.filter_points3D(max_reproj_error, min_tri_angle, self.point_ids())

    def filter_images(self):
        """Deregister images with no 3D points. Returns set of filtered ids."""
        before = set(self.reg_image_ids())
        for imid in list(before):
            if self.images[imid].num_points3D() == 0:
                self.deregister_image(imid)
        return before - set(self.reg_image_ids())

    # --- covisibility / local bundles ---
    def shared_point_counts(self, refimid: int):
        """#3D points shared with each other registered image (vectorized
        membership via a pool-sized mark array)."""
        ref = self.images[refimid]
        ref_pids = ref.point3D_ids[ref.point3D_ids >= 0]
        mark = np.zeros(len(self.alive), bool)
        mark[ref_pids] = True
        counts = {}
        for imid, im in self.registered_images.items():
            if imid == refimid:
                continue
            pids = im.point3D_ids[im.point3D_ids >= 0]
            counts[imid] = int(mark[pids].sum())
        return counts

    def find_local_bundle_ids(
        self, refimid: int, num_images: int | None = None, min_tri_angle: float = 6.0
    ):
        """COLMAP IncrementalMapper::FindLocalBundle analog (reference
        scene/reconstruction/base.py:147-156 delegates to pycolmap).

        Ranks covisible images by shared-point count, then — when there are
        more candidates than slots — prefers images whose shared points have
        good triangulation angles with refimid, relaxing the (angle,
        min-shared-count) requirement through COLMAP's 8-step ladder before
        falling back to plain covisibility order."""
        if num_images is None:
            num_images = 5
        counts = self.shared_point_counts(refimid)
        ranked = sorted(counts, key=lambda i: -counts[i])
        ranked = [i for i in ranked if counts[i] > 0]
        if len(ranked) <= num_images:
            return ranked

        ref = self.images[refimid]
        ref_pids = ref.point3D_ids[ref.point3D_ids >= 0]
        mark = np.zeros(len(self.alive), bool)
        mark[ref_pids] = True
        c_ref = ref.pose.center()
        max_shared = max(counts[i] for i in ranked)
        min_tri_rad = np.deg2rad(min_tri_angle)
        ladder = [
            (min_tri_rad / 1.0, 0.6 * max_shared),
            (min_tri_rad / 1.5, 0.6 * max_shared),
            (min_tri_rad / 2.0, 0.5 * max_shared),
            (min_tri_rad / 2.5, 0.4 * max_shared),
            (min_tri_rad / 3.0, 0.3 * max_shared),
            (min_tri_rad / 4.0, 0.2 * max_shared),
            (min_tri_rad / 5.0, 0.1 * max_shared),
            (min_tri_rad / 6.0, 0.1 * max_shared),
        ]

        tri_angles: dict[int, np.ndarray] = {}

        def angles_for(imid):
            if imid not in tri_angles:
                im = self.images[imid]
                pids = im.point3D_ids[im.point3D_ids >= 0]
                pids = pids[mark[pids]]
                X = self.xyz[pids]
                v1 = c_ref[None] - X
                v2 = im.pose.center()[None] - X
                n1 = np.linalg.norm(v1, axis=-1)
                n2 = np.linalg.norm(v2, axis=-1)
                cos = (v1 * v2).sum(-1) / np.maximum(n1 * n2, 1e-12)
                tri_angles[imid] = np.arccos(np.clip(cos, -1.0, 1.0))
            return tri_angles[imid]

        selected: list[int] = []
        used = set()
        for angle_thr, count_thr in ladder:
            for imid in ranked:
                if imid in used:
                    continue
                if counts[imid] < count_thr:
                    break  # ranked desc — the rest fail the count bar too
                if int((angles_for(imid) >= angle_thr).sum()) >= count_thr:
                    selected.append(imid)
                    used.add(imid)
                    if len(selected) >= num_images:
                        return selected
            if len(selected) >= num_images:
                break
        for imid in ranked:  # fill remaining slots by covisibility order
            if imid not in used:
                selected.append(imid)
                if len(selected) >= num_images:
                    break
        return selected

    def num_visible_points3D(self, imid: int):
        """#keypoints of imid whose correspondences see a triangulated point
        (approximated by current observation count for ranking)."""
        return self.images[imid].num_points3D()

    # --- normalization (reference scene/reconstruction/base.py:105-121) ---
    def normalize(self, fixed_scale=False, extent=5.0, p0=0.2, p1=0.8):
        """Center/scale the reconstruction using the percentile camera-center
        bounding box; rescales all depth state via the returned scale."""
        reg = self.reg_image_ids()
        if len(reg) < 2:
            return 1.0
        centers = np.stack([self.images[i].pose.center() for i in reg])
        sort = np.sort(centers, axis=0)
        n = len(reg)
        i0, i1 = int(p0 * n), max(int(np.ceil(p1 * n)) - 1, int(p0 * n))
        bbox_min, bbox_max = sort[i0], sort[i1]
        mean = 0.5 * (bbox_min + bbox_max)
        old_extent = np.linalg.norm(bbox_max - bbox_min)
        scale = 1.0 if (fixed_scale or old_extent < 1e-6) else extent / old_extent
        # world' = scale * (world - mean)
        for imid in reg:
            pose = self.images[imid].pose
            # With x' = scale (x - mean), requiring x_cam' = scale * x_cam
            # (pixels invariant, depths scaled): t' = scale * (t + R @ mean).
            t_new = scale * (pose.rotation_matrix() @ mean + pose.t)
            pose.t = t_new
        alive = self.point_ids()
        self.xyz[alive] = scale * (self.xyz[alive] - mean)
        return scale
