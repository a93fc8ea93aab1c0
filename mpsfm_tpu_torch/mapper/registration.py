"""Image registration: init-pair bootstrapping + depth-lifted PnP (port of
mpsfm_tpu/mapper/registration.py).

Port of the reference's MpsfmRegistration
(mpsfm/sfm/mapper/registration.py): the init pair arbitrates between
essential-matrix relative pose and absolute pose on depth-lifted 3D by
parallax count (:247-339); subsequent images register by RANSAC-PnP on
mixed triangulated/lifted 2D-3D pairs (:132-238) with the AP-inlier
halving failure ladder. Host code assembles flat numpy arrays (a copy of
the JAX package's); the RANSACs run on the registration's device (the
card unless the caller asks for the CPU) and their outputs come back in
one `.cpu()` read.

Each RANSAC draws its samples with `_draw`: `estimators.ransac.
sample_indices` from `torch.Generator().manual_seed(seed)` on the CPU, moved
to the device (the card and the CPU then register with the same samples),
over the inputs padded to a power-of-two bucket (`_bucket`, `_pad2`), so
that the JAX package's draws (jax.random.PRNGKey(seed) over the same
padded arrays) can be passed in unchanged where a test replaces `_draw`.
"""

from __future__ import annotations

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.config import BaseClass
from mpsfm_tpu_torch.estimators.homography import decompose_homography_np
from mpsfm_tpu_torch.estimators.ransac import ransac_essential, ransac_homography, ransac_pnp, sample_indices
from mpsfm_tpu_torch.scene.reconstruction import Pose, Reconstruction
from mpsfm_tpu_torch.utils.profiling import TIMERS

_BUCKET_MIN = 64


def _bucket(n):
    b = _BUCKET_MIN
    while b < n:
        b *= 2
    return b


def _pad2(a, n):
    out = np.zeros((n, *a.shape[1:]), a.dtype)
    out[: len(a)] = a
    return out


def _p3p_grunert_np(X, f):
    """Grunert's P3P: world points X (3,3), unit bearings f (3,3) ->
    list of (R, t) with x_cam = R x_world + t (COLMAP's P3P estimator
    analog; host numpy — used only for tiny problems)."""
    a2 = float(((X[1] - X[2]) ** 2).sum())
    b2 = float(((X[0] - X[2]) ** 2).sum())
    c2 = float(((X[0] - X[1]) ** 2).sum())
    if min(a2, b2, c2) < 1e-12:
        return []
    ca = float(f[1] @ f[2])  # alpha: angle at rays 2-3
    cb = float(f[0] @ f[2])  # beta: rays 1-3
    cg = float(f[0] @ f[1])  # gamma: rays 1-2
    q = (a2 - c2) / b2
    r = (a2 + c2) / b2
    s = (b2 - c2) / b2
    u = (b2 - a2) / b2
    A4 = (q - 1.0) ** 2 - 4.0 * c2 / b2 * ca * ca
    A3 = 4.0 * (q * (1.0 - q) * cb - (1.0 - r) * ca * cg + 2.0 * c2 / b2 * ca * ca * cb)
    A2 = 2.0 * (q * q - 1.0 + 2.0 * q * q * cb * cb + 2.0 * s * ca * ca - 4.0 * r * ca * cb * cg + 2.0 * u * cg * cg)
    A1 = 4.0 * (-q * (1.0 + q) * cb + 2.0 * a2 / b2 * cg * cg * cb - (1.0 - r) * ca * cg)
    A0 = (1.0 + q) ** 2 - 4.0 * a2 / b2 * cg * cg
    coeffs = np.array([A4, A3, A2, A1, A0])
    if not np.isfinite(coeffs).all() or abs(A4) < 1e-14:
        coeffs = coeffs[1:] if abs(A4) < 1e-14 else coeffs
    if len(coeffs) < 2:
        return []
    roots = np.roots(coeffs)
    poses = []
    for v in roots:
        if abs(v.imag) > 1e-6 or v.real <= 0:
            continue
        v = float(v.real)
        denom = 2.0 * (cg - v * ca)
        if abs(denom) < 1e-12:
            continue
        uu = ((-1.0 + q) * v * v - 2.0 * q * cb * v + 1.0 + q) / denom
        if uu <= 0:
            continue
        s1sq = b2 / (1.0 + v * v - 2.0 * v * cb)
        if s1sq <= 0:
            continue
        s1 = np.sqrt(s1sq)
        s2 = uu * s1
        s3 = v * s1
        Pc = np.stack([s1 * f[0], s2 * f[1], s3 * f[2]])  # camera-frame points
        # absolute orientation (Kabsch, no scale): Pc = R X + t
        muw = X.mean(0)
        muc = Pc.mean(0)
        H = (X - muw).T @ (Pc - muc)
        U, _, Vt = np.linalg.svd(H)
        D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ D @ U.T
        t = muc - R @ muw
        poses.append((R, t))
    return poses


def _gn_refine_pose_np(R, t, X, xyn, iters=10):
    """Small numpy Gauss-Newton on reprojection (normalized coords).
    Left-perturbation convention: R <- exp(w)R, so dPc/dw = -[R X]_x."""
    for _ in range(iters):
        Pc = X @ R.T + t
        z = np.maximum(Pc[:, 2], 1e-8)
        pred = Pc[:, :2] / z[:, None]
        res = (pred - xyn).reshape(-1)
        n = len(X)
        J = np.zeros((2 * n, 6))
        invz = 1.0 / z
        x, y = Pc[:, 0], Pc[:, 1]
        du = np.stack([invz, np.zeros(n), -x * invz * invz], -1)  # d(pred_u)/dPc
        dv = np.stack([np.zeros(n), invz, -y * invz * invz], -1)
        RX = Pc - t
        for i, drow in ((0, du), (1, dv)):
            # drow @ (-[RX]_x) == cross(RX, drow) row-wise
            J[i::2, :3] = np.cross(RX, drow)
            J[i::2, 3:] = drow
        JTJ = J.T @ J + 1e-9 * np.eye(6)
        delta = -np.linalg.solve(JTJ, J.T @ res)
        dR = _rodrigues_np(delta[:3])
        R = dR @ R
        t = t + delta[3:]
    return R, t


def _matrix_to_quat_np(R):
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-8:
        q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w)])
    else:  # fall back through the largest diagonal element
        i = int(np.argmax([R[0, 0], R[1, 1], R[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2.0
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = s / 4.0
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


def _rodrigues_np(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def run_pnp_small(xyz, xy_norm, thresh_norm_sq):
    """Exhaustive P3P over all 3-subsets for tiny 2D-3D sets (4..5 points
    — below the 6-point DLT minimal sample). Mirrors COLMAP's P3P-based
    absolute pose path down to its true minimum."""
    from itertools import combinations

    X = np.asarray(xyz, np.float64)
    xyn = np.asarray(xy_norm, np.float64)
    rays = np.concatenate([xyn, np.ones((len(xyn), 1))], -1)
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    best = None
    for idx in combinations(range(len(X)), 3):
        for R, t in _p3p_grunert_np(X[list(idx)], rays[list(idx)]):
            Pc = X @ R.T + t
            z = Pc[:, 2]
            pred = Pc[:, :2] / np.maximum(z, 1e-8)[:, None]
            err = ((pred - xyn) ** 2).sum(-1)
            inl = (err < thresh_norm_sq) & (z > 1e-8)
            n_inl = int(inl.sum())
            if best is None or n_inl > best[0]:
                best = (n_inl, R, t, inl)
    if best is None or best[0] < 3:
        return {"pose": Pose.identity(), "inlier_mask": np.zeros(len(X), bool), "num_inliers": 0}
    n_inl, R, t, inl = best
    R, t = _gn_refine_pose_np(R, t, X[inl], xyn[inl])
    Pc = X @ R.T + t
    z = Pc[:, 2]
    pred = Pc[:, :2] / np.maximum(z, 1e-8)[:, None]
    err = ((pred - xyn) ** 2).sum(-1)
    inl = (err < thresh_norm_sq) & (z > 1e-8)
    return {
        "pose": Pose(_matrix_to_quat_np(R), t),
        "inlier_mask": inl,
        "num_inliers": int(inl.sum()),
    }


def _draw(seed, num_hyp, sample_size, n):
    """(num_hyp, sample_size) samples of the first n of _bucket(n) padded
    rows, on the CPU. They are drawn from a CPU generator seeded with seed
    (a small draw), so a registration on the card and one on the CPU take
    the same samples."""
    gen = torch.Generator().manual_seed(int(seed))
    return sample_indices(gen, num_hyp, sample_size, torch.arange(_bucket(n)) < n)


def _padded(device, n, *arrays):
    """(valid (nb,), each array padded to nb rows as float32) on device."""
    nb = _bucket(n)
    valid = torch.zeros(nb, dtype=torch.bool, device=device)
    valid[:n] = True
    return valid, [torch.as_tensor(_pad2(np.asarray(a, np.float32), nb), device=device) for a in arrays]


def _read(pose, num_inliers, inlier_mask, n):
    """One read of a RANSAC's pose, inlier count and mask to the host."""
    flat = torch.cat([pose.quat.float(), pose.t.float(), num_inliers.float()[None], inlier_mask.float()]).cpu().numpy()
    return {
        "pose": Pose(np.asarray(flat[:4], np.float64), np.asarray(flat[4:7], np.float64)),
        "inlier_mask": flat[8:8 + n] > 0.5,
        "num_inliers": int(flat[7]),
    }


def run_ransac_pnp(xyz, xy_norm, thresh_norm_sq, num_hyp=512, seed=0, device="cuda"):
    """Padded host wrapper around the PnP RANSAC (6-pt DLT samples) on
    `device`; falls back to exhaustive host P3P below 6 points."""
    if len(xyz) < 6:
        return run_pnp_small(xyz, xy_norm, thresh_norm_sq)
    n = len(xyz)
    valid, (X, x) = _padded(resolve_device(device), n, xyz, xy_norm)
    idx = _draw(seed, num_hyp, 6, n).to(valid.device)
    out = ransac_pnp(idx, X, x, valid, float(np.float32(thresh_norm_sq)))
    return _read(out["pose"], out["num_inliers"], out["inlier_mask"], n)


def run_ransac_essential(xy1n, xy2n, thresh_norm_sq, num_hyp=512, seed=0, device="cuda"):
    n = len(xy1n)
    valid, (x1, x2) = _padded(resolve_device(device), n, xy1n, xy2n)
    idx = _draw(seed, num_hyp, 8, n).to(valid.device)
    out = ransac_essential(idx, x1, x2, valid, float(np.float32(thresh_norm_sq)))
    return _read(out["pose"], out["num_inliers"], out["inlier_mask"], n)


def run_ransac_homography_pose(xy1n, xy2n, thresh_norm_sq, num_hyp=512, seed=0, prior_normal=None,
                               device="cuda"):
    """H-RANSAC + decomposition -> relative pose for planar pairs
    (COLMAP's pose-from-homography path; the reference relies on depth
    lifting instead, which needs priors). Candidates are cheirality-voted;
    the two-fold planar ambiguity is broken by ``prior_normal`` (the
    image-1 surface-normal prior, camera frame) when available."""
    n = len(xy1n)
    valid, (x1, x2) = _padded(resolve_device(device), n, xy1n, xy2n)
    idx = _draw(seed, num_hyp, 4, n).to(valid.device)
    out = ransac_homography(idx, x1, x2, valid, float(np.float32(thresh_norm_sq)))
    flat = torch.cat([out["H"].reshape(-1).float(), out["num_inliers"].float()[None],
                      out["inlier_mask"].float()]).cpu().numpy()
    H = np.asarray(flat[:9], np.float64).reshape(3, 3)
    inl = flat[10:10 + n] > 0.5
    best_pose, best_score, best_votes = None, -np.inf, 0
    xy1_in = np.asarray(xy1n)[inl]
    xy2_in = np.asarray(xy2n)[inl]
    for R, t, nvec in decompose_homography_np(H):
        q = _matrix_to_quat_np(R)
        pose = Pose(q, t.astype(np.float64))
        if len(xy1_in) == 0:
            votes = 0
        else:
            X = _two_view_triangulate_np(Pose.identity(), pose, xy1_in, xy2_in)
            z1 = X[:, 2]
            z2 = pose.transform(X)[:, 2]
            votes = int(((z1 > 0) & (z2 > 0)).sum())
        score = float(votes)
        if prior_normal is not None:
            # surface normals point toward the camera (n_z < 0 in our
            # convention); the decomposition's n points away — compare with
            # flipped sign and weight the agreement strongly.
            np_unit = np.asarray(prior_normal, np.float64)
            np_unit = np_unit / max(np.linalg.norm(np_unit), 1e-12)
            nvec_unit = nvec / max(np.linalg.norm(nvec), 1e-12)
            score += float(-np.dot(nvec_unit, np_unit)) * max(len(xy1_in), 1)
        if score > best_score:
            best_score, best_votes, best_pose = score, votes, pose
    return {
        "pose": best_pose or Pose.identity(),
        "inlier_mask": inl,
        "num_inliers": int(flat[9]),
        "cheirality_votes": best_votes,
    }


def _tri_angles_np(c1, c2, xyz):
    r1 = xyz - c1
    r2 = xyz - c2
    n1 = np.linalg.norm(r1, axis=-1)
    n2 = np.linalg.norm(r2, axis=-1)
    baseline = np.linalg.norm(c1 - c2)
    denom = 2.0 * np.sqrt(n1 * n2)
    nom = n1 + n2 - baseline
    ang = np.abs(np.arccos(np.clip(np.where(denom > 0, nom / np.maximum(denom, 1e-12), 1.0), -1, 1)))
    return np.rad2deg(np.minimum(ang, np.pi - ang))


def _two_view_triangulate_np(pose1: Pose, pose2: Pose, xy1n, xy2n):
    """Batched two-view DLT in numpy (host-scale arrays)."""
    P1 = pose1.matrix()
    P2 = pose2.matrix()
    rows = np.stack(
        [
            xy1n[:, 0, None] * P1[2] - P1[0],
            xy1n[:, 1, None] * P1[2] - P1[1],
            xy2n[:, 0, None] * P2[2] - P2[0],
            xy2n[:, 1, None] * P2[2] - P2[1],
        ],
        axis=1,
    )  # (N,4,4)
    AtA = np.einsum("nij,nik->njk", rows, rows)
    _, v = np.linalg.eigh(AtA)
    X = v[..., :, 0]
    w = np.where(np.abs(X[:, 3]) < 1e-12, 1e-12, X[:, 3])
    return X[:, :3] / w[:, None]


class Registration(BaseClass):
    default_conf = {
        "lifted_registration": True,
        "reduce_min_inliers_at_failure": 6,
        "parallax_thresh": 1.5,
        "combined_triangle_thresh": 1.5,
        "robust_triangles": 1,
        # COLMAP operating points (reference imports the full option set):
        "init_min_tri_angle": 16.0,
        "init_min_num_points": 3,  # reference floor (registration.py:130); raise
        # for prior-less operation where lifting can't rescue a weak init
        "abs_pose_max_error": 12.0,
        "abs_pose_min_num_inliers": 30,
        "rel_pose_max_error": 4.0,
        "num_hyp": 512,
        # exploration: when the best-ref inlier ratio is weak (<0.1) while
        # another ref supports >0.2, blacklist the AP inliers and re-run the
        # absolute pose (reference registration.py:196-232, conf
        # "resample_bunlde" [sic]).
        "resample_bundle": False,
        "verbose": 0,
    }

    def _init(self, rec: Reconstruction, corr, triangulator, device="cuda"):
        """device: where the RANSACs run (the card unless the caller asks
        for the CPU; no GPU raises)."""
        self.device = resolve_device(device)
        self.rec = rec
        self.corr = corr  # Correspondences facade (matches(imid1,imid2))
        self.triangulator = triangulator
        self.half_ap_min_inliers = 0
        self._seed = 0

    def _next_seed(self):
        self._seed += 1
        return self._seed

    # ---------- init pair ----------
    def register_and_triangulate_init_pair(self, imid1, imid2):
        rec = self.rec
        matches = self.corr.matches(imid1, imid2)
        if len(matches) < 8:
            return False
        cam1, cam2 = rec.camera(imid1), rec.camera(imid2)
        kps1 = rec.images[imid1].keypoints
        kps2 = rec.images[imid2].keypoints

        tvg = self.corr.two_view_geom_by_ids(imid1, imid2) if hasattr(self.corr, "two_view_geom_by_ids") else None
        planar = tvg is not None and int(tvg.config) in (4, 5, 6)  # PLANAR/PANORAMIC classes
        candidates, pose2 = self._init_pair_points_and_pose(
            imid1, imid2, kps1, kps2, matches, cam1, cam2, planar=planar
        )
        rec.images[imid1].pose = Pose.identity()
        rec.images[imid2].pose = pose2
        rec.register_image(imid1)
        rec.register_image(imid2)
        if candidates is None or len(candidates["xyz"]) < 3:
            self.log(f"Init pair ({imid1},{imid2}): <3 candidate points")
            return False
        added = 0
        for i in range(len(candidates["xyz"])):
            kp1, kp2 = candidates["kp1"][i], candidates["kp2"][i]
            if rec.images[imid1].point3D_ids[kp1] >= 0 or rec.images[imid2].point3D_ids[kp2] >= 0:
                continue
            if (
                candidates["tri_angle"][i] > self.conf.init_min_tri_angle
                and candidates["posdepth1"][i]
                and candidates["posdepth2"][i]
            ):
                rec.add_point3D(candidates["xyz"][i], [(imid1, int(kp1)), (imid2, int(kp2))])
                added += 1
        return rec.num_points3D() >= max(3, self.conf.init_min_num_points)

    def _init_pair_points_and_pose(self, imid1, imid2, kps1, kps2, matches, cam1, cam2, planar=False):
        rec = self.rec
        xy1n_all = cam1.cam_from_img(kps1)
        xy2n_all = cam2.cam_from_img(kps2)
        m1, m2 = matches[:, 0], matches[:, 1]

        f1 = cam1.mean_focal()
        f2 = cam2.mean_focal()
        e_thr = (0.5 * (self.conf.rel_pose_max_error / f1 + self.conf.rel_pose_max_error / f2)) ** 2
        if planar:
            # Essential estimation degenerates on (near-)planar pairs; use
            # the H-decomposition pose for the relative-pose branch, with
            # the image-1 normal prior breaking the two-fold ambiguity.
            prior_normal = None
            normals = getattr(rec.images[imid1], "normals", None)
            if normals is not None:
                n = np.asarray(normals.data)
                prior_normal = np.median(n.reshape(-1, 3), axis=0)
            with TIMERS.phase("init.ransac_h"):
                E_info = run_ransac_homography_pose(
                    xy1n_all[m1], xy2n_all[m2], e_thr, self.conf.num_hyp, self._next_seed(),
                    prior_normal=prior_normal, device=self.device,
                )
        else:
            with TIMERS.phase("init.ransac_e"):
                E_info = run_ransac_essential(
                    xy1n_all[m1], xy2n_all[m2], e_thr, self.conf.num_hyp, self._next_seed(), device=self.device
                )
        inlier_matches = matches[E_info["inlier_mask"]]

        pose1 = Pose.identity()
        pose_e = E_info["pose"]
        # triangulate essential inliers, get angles
        tri_xyz = _two_view_triangulate_np(
            pose1, pose_e, xy1n_all[inlier_matches[:, 0]], xy2n_all[inlier_matches[:, 1]]
        )
        tri_ang = _tri_angles_np(pose1.center(), pose_e.center(), tri_xyz)

        # lift image1 kps by prior depth for absolute pose of image2
        depth1 = getattr(rec.images[imid1], "depth", None)
        AP_info = None
        lifted3d = None
        valid_lift = None
        if depth1 is not None and self.conf.lifted_registration:
            d = depth1.data_prior_at_kps(kps1)
            valid_lift = depth1.valid_at_kps(kps1) & (d > 0)
            lifted3d = np.concatenate([xy1n_all, np.ones((len(kps1), 1))], -1) * d[:, None]
            vm = matches[valid_lift[matches[:, 0]]]
            if len(vm) >= 6:
                ap_thr = (
                    0.5 * (self.conf.abs_pose_max_error / f1 + self.conf.abs_pose_max_error / f2)
                ) ** 2
                with TIMERS.phase("init.ransac_pnp"):
                    AP_info = run_ransac_pnp(
                        lifted3d[vm[:, 0]], xy2n_all[vm[:, 1]], ap_thr, self.conf.num_hyp, self._next_seed(),
                        device=self.device,
                    )

        if AP_info is None:
            high_parallax = True
        else:
            high_parallax = (tri_ang > self.conf.parallax_thresh).sum() > AP_info["num_inliers"]

        cand = {"kp1": [], "kp2": [], "xyz": [], "tri_angle": [], "posdepth1": [], "posdepth2": []}

        def add_cands(kp1s, kp2s, xyzs, pose2):
            angs = _tri_angles_np(pose1.center(), pose2.center(), xyzs)
            z1 = xyzs[:, 2]
            p2c = pose2.transform(xyzs)
            z2 = p2c[:, 2]
            for k in range(len(kp1s)):
                cand["kp1"].append(int(kp1s[k]))
                cand["kp2"].append(int(kp2s[k]))
                cand["xyz"].append(xyzs[k])
                cand["tri_angle"].append(float(angs[k]))
                cand["posdepth1"].append(bool(z1[k] > 0))
                cand["posdepth2"].append(bool(z2[k] > 0))

        if high_parallax:
            pose2 = pose_e
            # rescale lifted depth to the essential (unit-baseline) frame via
            # median(z_triangulated / d_prior) (reference :283-287)
            if lifted3d is not None and len(inlier_matches) > 0:
                d_prior = depth1.data_prior_at_kps(kps1[inlier_matches[:, 0]])
                ok = d_prior > 0
                rescale = np.median(tri_xyz[ok, 2] / d_prior[ok]) if ok.sum() else 1.0
                lifted_resc = lifted3d * rescale
                vm = inlier_matches[valid_lift[inlier_matches[:, 0]]]
                lift_x = lifted_resc[vm[:, 0]]
                ang_l = _tri_angles_np(pose1.center(), pose2.center(), lift_x)
                # combine: lifted where low angle, triangulated where high
                keep_l = ang_l < self.conf.combined_triangle_thresh
                add_cands(vm[keep_l, 0], vm[keep_l, 1], lift_x[keep_l], pose2)
            keep_t = tri_ang >= self.conf.combined_triangle_thresh
            add_cands(inlier_matches[keep_t, 0], inlier_matches[keep_t, 1], tri_xyz[keep_t], pose2)
        else:
            pose2 = AP_info["pose"]
            vm = matches[valid_lift[matches[:, 0]]]
            vin = vm[AP_info["inlier_mask"]]
            lift_x = lifted3d[vin[:, 0]]
            ang_l = _tri_angles_np(pose1.center(), pose2.center(), lift_x)
            tri_x = _two_view_triangulate_np(pose1, pose2, xy1n_all[vin[:, 0]], xy2n_all[vin[:, 1]])
            ang_t = _tri_angles_np(pose1.center(), pose2.center(), tri_x)
            use_tri = ang_t >= self.conf.combined_triangle_thresh
            add_cands(vin[~use_tri, 0], vin[~use_tri, 1], lift_x[~use_tri], pose2)
            add_cands(vin[use_tri, 0], vin[use_tri, 1], tri_x[use_tri], pose2)

        if len(cand["xyz"]):
            cand["xyz"] = np.stack(cand["xyz"])
        return cand, pose2

    # ---------- next image ----------
    def _find_2D3D_pairs(self, ref_id, imid):
        """2D (query px-normalized) / 3D pairs from one registered ref
        (reference _find_2D3D_pairs + _collect_pairs, :68-94,341-373)."""
        rec = self.rec
        corr = self.corr.matches(ref_id, imid)
        im = rec.images[imid]
        if ref_id in im.ignore_matches_AP:
            keep = ~im.ignore_matches_AP[ref_id]
            if len(keep) == len(corr):
                corr = corr[keep]
        out = {"2d_kp": np.zeros(0, np.int64), "3d": np.zeros((0, 3)), "lifted": np.zeros(0, bool), "3dids": np.zeros(0, np.int64)}
        if len(corr) == 0:
            return out
        ref_kps, qry_kps = corr[:, 0], corr[:, 1]
        ref_im = rec.images[ref_id]
        pids = ref_im.point3D_ids[ref_kps]
        use_3d = pids >= 0
        pids3 = pids[use_3d]
        # exclude risky (low-parallax) triangulated points from the hard set
        if self.conf.robust_triangles is not None and self.conf.lifted_registration and len(pids3):
            risky = rec.find_points3D_with_small_triangulation_angle(self.conf.robust_triangles, pids3)
            tmp = use_3d.copy()
            tmp[np.where(use_3d)[0][risky]] = False
            use_3d = tmp
            pids3 = pids[use_3d]
        xyz = np.full((len(corr), 3), -1.0)
        if use_3d.sum():
            xyz[use_3d] = rec.xyz[pids3]
        lifted = ~use_3d
        if self.conf.lifted_registration:
            # lift every untriangulated ref kp from depth (reference
            # registration.py:356-364 lifts unconditionally via data_at_kps;
            # refined-vs-prior arbitration happens below)
            depth = getattr(ref_im, "depth", None)
            if lifted.sum() and depth is not None:
                kl = ref_kps[lifted]
                xy = ref_im.keypoints[kl]
                d = (
                    depth.data_at_kps(xy)
                    if (depth.activated and depth.data is not None)
                    else depth.data_prior_at_kps(xy)
                )
                cam = rec.camera(ref_id)
                xyn = cam.cam_from_img(xy)
                p_cam = np.concatenate([xyn, np.ones((len(xy), 1))], -1) * d[:, None]
                xyz[lifted] = ref_im.pose.inverse().transform(p_cam)
            elif lifted.sum():
                # no depth: drop the lifted part
                keep = use_3d
                return {
                    "2d_kp": qry_kps[keep],
                    "3d": xyz[keep],
                    "lifted": np.zeros(int(keep.sum()), bool),
                    "3dids": pids3,
                }
        else:
            keep = use_3d
            return {
                "2d_kp": qry_kps[keep],
                "3d": xyz[keep],
                "lifted": np.zeros(int(keep.sum()), bool),
                "3dids": pids3,
            }
        return {"2d_kp": qry_kps, "3d": xyz, "lifted": lifted, "3dids": pids3}

    def register_next_image(self, imid, ref_imids=None):
        rec = self.rec
        im = rec.images[imid]
        cam = rec.camera(imid)
        if not ref_imids:  # None or empty: fall back to all registered
            ref_imids = list(rec.registered_images.keys())
        ref_imids = sorted(i for i in ref_imids if rec.images[i].registered)
        if not ref_imids:
            self.log(f"Image {imid}: no registered reference images")
            return False

        ap_min = self.conf.abs_pose_min_num_inliers
        if self.half_ap_min_inliers:
            ap_min = int(ap_min / (1.2**self.half_ap_min_inliers))
        force = self.half_ap_min_inliers >= self.conf.reduce_min_inliers_at_failure

        for _attempt in range(3 if self.conf.resample_bundle else 1):
            pair_data = {r: self._find_2D3D_pairs(r, imid) for r in ref_imids}
            pts2d_kp = np.concatenate([pair_data[r]["2d_kp"] for r in ref_imids])
            pts3d = np.concatenate([pair_data[r]["3d"] for r in ref_imids])
            lifted = np.concatenate([pair_data[r]["lifted"] for r in ref_imids])
            ids3d = np.concatenate([pair_data[r]["3dids"] for r in ref_imids])

            # dedup triangulated by point id (reference :155-163)
            # NOTE: ids3d concatenates each pair's pids3 (triangulated-only),
            # so it aligns with the ~lifted positions in order.
            if (~lifted).sum() > 0:
                uniq, uidx = np.unique(ids3d, return_index=True)
                tri_kp = pts2d_kp[~lifted][uidx]
                tri_3d = pts3d[~lifted][uidx]
            else:
                uniq = np.zeros(0, np.int64)
                tri_kp = np.zeros(0, np.int64)
                tri_3d = np.zeros((0, 3))
            lift_kp = pts2d_kp[lifted]
            lift_3d = pts3d[lifted]
            all_kp = np.concatenate([tri_kp, lift_kp])
            all_3d = np.concatenate([tri_3d, lift_3d])
            if len(all_kp) < 4:
                # reference gates at <3 (registration.py:165-167); our
                # exhaustive-P3P small path needs one extra for scoring
                self.log(f"Image {imid}: <4 2D-3D pairs")
                return False

            xy_norm = cam.cam_from_img(im.keypoints[all_kp])
            thr = (self.conf.abs_pose_max_error / cam.mean_focal()) ** 2
            AP = run_ransac_pnp(all_3d, xy_norm, thr, self.conf.num_hyp, self._next_seed(), device=self.device)
            if AP["num_inliers"] < max(ap_min, 6) and not force:
                self.log(f"Image {imid}: AP inliers {AP['num_inliers']} < {ap_min}")
                return False
            if AP["num_inliers"] < 3:
                return False

            # remap inlier mask back per-ref (reference :178-194)
            inl = AP["inlier_mask"]
            t_mask = inl[: len(tri_kp)]
            l_mask = inl[len(tri_kp) :]
            # per-point-id inlier lookup
            id_inl = dict(zip(uniq.tolist(), t_mask.tolist()))
            remapped = np.zeros(len(pts2d_kp), bool)
            tri_positions = np.where(~lifted)[0]
            for pos, pid in zip(tri_positions, ids3d):
                remapped[pos] = id_inl.get(int(pid), False)
            remapped[np.where(lifted)[0]] = l_mask
            sizes = [len(pair_data[r]["2d_kp"]) for r in ref_imids]
            split = np.split(remapped, np.cumsum(sizes)[:-1])
            masks = dict(zip(ref_imids, split))
            rec.last_ap_inlier_masks = masks

            # exploration: re-estimate with the dominant-but-weak ref's
            # inliers blacklisted (reference registration.py:196-232)
            if self.conf.resample_bundle and len(ref_imids) > 1:
                best_id = rec.best_next_ref_imid
                if best_id in masks and len(masks[best_id]) > 0:
                    best_ratio = masks[best_id].mean()
                    others = [masks[r].mean() for r in ref_imids if r != best_id and len(masks[r]) > 0]
                    if others and best_ratio < 0.1 and np.nanmax(others) > 0.2:
                        for ref_id, m in masks.items():
                            if len(m) == 0:
                                continue
                            prev = im.ignore_matches_AP.get(ref_id)
                            if prev is not None:
                                used = ~prev
                                prev[used] |= m
                            else:
                                im.ignore_matches_AP[ref_id] = m.copy()
                        self.log(f"Image {imid}: resampling AP inliers (best ref {best_id} ratio {best_ratio:.2f})")
                        continue
            break

        im.pose = AP["pose"]
        rec.register_image(imid)
        return True

    def register_and_triangulate_next_image(self, imid, ref_imids=None):

        with TIMERS.phase("reg.next_image"):
            ok = self.register_next_image(imid, ref_imids=ref_imids)
        if not ok:
            return False
        with TIMERS.phase("reg.triangulate"):
            return self.triangulator.triangulate_image(imid)
