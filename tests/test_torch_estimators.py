"""The estimators: the port against the JAX package on the cases of
tests/test_estimators.py, with the same draws.

The scenes are those of tests/test_estimators.py (`make_scene`: the same
rng draws, points and poses), projected with the port's float32 geometry.
The JAX package draws its RANSAC samples with jax.random inside each entry
point; the port takes them as an argument. Each test draws them with
`mpsfm_tpu.estimators.ransac._sample_indices` from the keys the JAX entry
point derives (its key; for two-view pairs, the bucket's fold_in of the
seed, split into the essential and homography keys) and gives them to the
port. The JAX functions the tests call outside the jitted entry points are
jitted here (one compilation each, not one per primitive).

Tolerances: the same TwoViewConfig; inlier masks equal, or each differing
entry within 1e-5 relative of the threshold; poses (unit quaternions with
w >= 0, translations) and E (up to sign, at unit norm) within 1e-4 of the
JAX package's where both pick the same hypothesis, and within the JAX
tests' own tolerances of the truth. On coplanar points the 8-point minimal
problem has a 3-D nullspace: its hypotheses are whichever null vector each
library's QR returns, so there only the TwoViewConfig is compared
(ROADMAP.md, queue 3).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.estimators import essential as je
from mpsfm_tpu.estimators import homography as jh
from mpsfm_tpu.estimators import pnp as jp
from mpsfm_tpu.estimators import ransac as jr
from mpsfm_tpu.estimators import two_view as jtv
from mpsfm_tpu_torch.estimators import essential as te
from mpsfm_tpu_torch.estimators import homography as th
from mpsfm_tpu_torch.estimators import pnp as tp
from mpsfm_tpu_torch.estimators import ransac as tr
from mpsfm_tpu_torch.estimators import two_view as ttv
from mpsfm_tpu_torch.geometry.projection import Camera, project_points
from mpsfm_tpu_torch.geometry.rotations import Rigid3d, quat_conj, quat_mul, so3_exp_quat

CAM = SimpleNamespace(fx=500.0, fy=500.0, cx=320.0, cy=240.0)  # both packages read floats of it
_CAM_T = Camera.from_params(torch.tensor([500.0, 500.0, 320.0, 240.0]), 640, 480)

_essential = jax.jit(je.essential_from_eight_points, static_argnames=("minimal",))
_decompose = jax.jit(je.decompose_essential)
_six_points = jax.jit(jp.pnp_from_six_points, static_argnames=("minimal",))
_plane = jax.jit(jp.pnp_from_plane)
_refine = jax.jit(jp.refine_pose_gn, static_argnames=("iters",))
_homography = jax.jit(jh.homography_from_four_points, static_argnames=("minimal",))
_draw = jax.jit(jr._sample_indices, static_argnums=(1, 2, 3))


def make_scene(rng, n=100, planar=False):
    """tests/test_estimators.make_scene on the port: (pose2, points (n, 3),
    normalized coords in views 1 and 2), numpy float32."""
    if planar:
        xy = rng.uniform(-2, 2, size=(n, 2))
        pts = np.stack([xy[:, 0], xy[:, 1], 4.0 + 0.3 * xy[:, 0]], -1)
    else:
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 9, n)], -1)
    pose1 = Rigid3d.identity(device="cpu")
    pose2 = Rigid3d(so3_exp_quat(torch.tensor([0.03, -0.25, 0.01])), torch.tensor([-1.0, 0.1, 0.15]))
    pts = torch.tensor(pts, dtype=torch.float32)
    px1, _ = project_points(pose1, _CAM_T, pts)
    px2, _ = project_points(pose2, _CAM_T, pts)
    xy1, xy2 = ((px - torch.tensor([320.0, 240.0])) / 500.0 for px in (px1, px2))
    return Rigid3d(pose2.quat.numpy(), pose2.t.numpy()), pts.numpy(), xy1.numpy(), xy2.numpy()


def rot_angle_deg(q1, q2):
    dq = quat_mul(quat_conj(torch.as_tensor(np.asarray(q1))), torch.as_tensor(np.asarray(q2)))
    return float(np.rad2deg(2 * np.arccos(np.clip(abs(float(dq[0])), -1, 1))))


def _px(xy):
    return xy * 500.0 + np.array([320.0, 240.0], np.float32)


THRESH = (4.0 / 500.0) ** 2
TOL = 1e-4


def _t(a):
    return torch.tensor(np.asarray(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close_pose(pt, pj, atol=TOL):
    np.testing.assert_allclose(_np(pt.quat), np.asarray(pj.quat), atol=atol)
    np.testing.assert_allclose(_np(pt.t), np.asarray(pj.t), atol=atol)


def _close_up_to_sign(a, b, atol=TOL):
    a, b = _np(a) / np.linalg.norm(_np(a)), np.asarray(b) / np.linalg.norm(np.asarray(b))
    np.testing.assert_allclose(a * np.sign((a * b).sum()), b, atol=atol)


def _masks_agree(mt, mj, err, thresh):
    """Inlier masks equal, or each differing entry's error (the port's)
    within 1e-5 relative of the threshold."""
    diff = _np(mt) != np.asarray(mj)
    assert (np.abs(_np(err)[diff] - thresh) <= 1e-5 * thresh).all(), np.nonzero(diff)


def _idx(key, num_hyp, k, valid):
    return np.array(_draw(key, num_hyp, k, valid.shape[0], jnp.asarray(valid)))


def _corrupt(rng, xy, n_out):
    xy = np.array(xy)
    xy[:n_out] = rng.uniform(-0.5, 0.5, size=(n_out, 2))
    return xy


def test_eight_point_exact(rng):
    _, _, xy1, xy2 = make_scene(rng, n=60)
    Ej = _essential(xy1, xy2)
    Et = te.essential_from_eight_points(_t(xy1), _t(xy2))
    assert float(te.sampson_error_sq(Et, _t(xy1), _t(xy2)).max()) < 1e-8
    _close_up_to_sign(Et, Ej)
    np.testing.assert_allclose(te.sampson_error_sq(_t(Ej), _t(xy1), _t(xy2)).numpy(),
                               np.asarray(jax.jit(je.sampson_error_sq)(Ej, xy1, xy2)), rtol=1e-5, atol=1e-12)
    # the minimal (QR) path on exactly 8 points
    Ej8 = _essential(xy1[:8], xy2[:8], minimal=True)
    Et8 = te.essential_from_eight_points(_t(xy1[:8]), _t(xy2[:8]), minimal=True)
    _close_up_to_sign(Et8, Ej8, atol=1e-3)
    assert float(te.sampson_error_sq(Et8, _t(xy1), _t(xy2)).max()) < 1e-6


def test_decompose_essential_recovers_pose(rng):
    pose2, _, xy1, xy2 = make_scene(rng, n=60)
    E = _essential(xy1, xy2)
    pj, vj, _ = _decompose(E, xy1, xy2, jnp.ones(60, bool))
    pt, vt, _ = te.decompose_essential(_t(E), _t(xy1), _t(xy2), torch.ones(60, dtype=torch.bool))
    _close_pose(pt, pj)
    # the candidates' order follows V's sign, which the port makes proper: the votes as a set
    np.testing.assert_array_equal(np.sort(vt.numpy()), np.sort(np.asarray(vj)))
    assert rot_angle_deg(pt.quat, pose2.quat) < 0.5
    t_est, t_gt = pt.t.numpy() / np.linalg.norm(pt.t.numpy()), pose2.t / np.linalg.norm(pose2.t)
    assert np.abs(t_est - t_gt).max() < 0.01
    assert int(vt.max()) == 60


def test_ransac_essential_with_outliers(rng):
    pose2, _, xy1, xy2 = make_scene(rng, n=200)
    xy2 = _corrupt(rng, xy2, 80)
    valid = np.ones(200, bool)
    out_j = jr.ransac_essential(jax.random.PRNGKey(0), jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid), THRESH)
    idx = _idx(jax.random.PRNGKey(0), 512, 8, valid)
    out_t = tr.ransac_essential(_t(idx), _t(xy1), _t(xy2), _t(valid), THRESH)
    err = te.sampson_error_sq(out_t["E"], _t(xy1), _t(xy2))
    _masks_agree(out_t["inlier_mask"], out_j["inlier_mask"], err, np.float32(THRESH))
    assert int(out_t["num_inliers"]) == int(out_j["num_inliers"]) >= 115
    _close_up_to_sign(out_t["E"], out_j["E"])
    _close_pose(out_t["pose"], out_j["pose"])
    mask = out_t["inlier_mask"].numpy()
    assert mask[80:].mean() > 0.95 and mask[:80].mean() < 0.1
    assert rot_angle_deg(out_t["pose"].quat, pose2.quat) < 1.0


def test_pnp_six_points_exact(rng):
    pose2, pts, _, xy2 = make_scene(rng, n=50)
    pj = _six_points(pts, xy2)
    pt = tp.pnp_from_six_points(_t(pts), _t(xy2))
    _close_pose(pt, pj)
    assert rot_angle_deg(pt.quat, pose2.quat) < 0.1
    np.testing.assert_allclose(pt.t.numpy(), pose2.t, atol=5e-3)
    # the minimal (QR) path on exactly 6 points
    pj6 = _six_points(pts[:6], xy2[:6], minimal=True)
    pt6 = tp.pnp_from_six_points(_t(pts[:6]), _t(xy2[:6]), minimal=True)
    _close_pose(pt6, pj6, atol=1e-3)


def _ransac_pnp_case(rng, key, planar, n, n_out, min_inliers):
    pose2, pts, _, xy2 = make_scene(rng, n=n, planar=planar)
    xy2 = xy2 + rng.normal(scale=0.5 / 500.0, size=xy2.shape)
    xy2 = _corrupt(rng, xy2, n_out).astype(np.float32)
    valid = np.ones(n, bool)
    out_j = jr.ransac_pnp(jax.random.PRNGKey(key), jnp.asarray(pts), jnp.asarray(xy2), jnp.asarray(valid), THRESH)
    out_t = tr.ransac_pnp(_t(_idx(jax.random.PRNGKey(key), 512, 6, valid)), _t(pts), _t(xy2), _t(valid), THRESH)
    err = tr._pnp_errs(out_t["pose"], _t(pts), _t(xy2))
    _masks_agree(out_t["inlier_mask"], out_j["inlier_mask"], err, np.float32(THRESH))
    assert int(out_t["num_inliers"]) >= min_inliers
    _close_pose(out_t["pose"], out_j["pose"])
    assert rot_angle_deg(out_t["pose"].quat, pose2.quat) < 0.5
    np.testing.assert_allclose(out_t["pose"].t.numpy(), pose2.t, atol=0.02)


def test_ransac_pnp_with_outliers_and_refinement(rng):
    _ransac_pnp_case(rng, 1, planar=False, n=300, n_out=90, min_inliers=200)


def test_ransac_pnp_on_coplanar_points(rng):
    _ransac_pnp_case(rng, 3, planar=True, n=200, n_out=0, min_inliers=160)


def test_pnp_from_plane_exact(rng):
    pose2, pts, _, xy2 = make_scene(rng, n=12, planar=True)
    pj = _plane(pts, xy2)
    pt = tp.pnp_from_plane(_t(pts), _t(xy2))
    _close_pose(pt, pj)
    assert rot_angle_deg(pt.quat, pose2.quat) < 0.2
    np.testing.assert_allclose(pt.t.numpy(), pose2.t, atol=1e-2)


def test_refine_pose_gn_matches_jax(rng):
    """The Gauss-Newton refinement alone, from a perturbed pose over weighted
    noisy matches (the port's Jacobian is analytic, the JAX package's jacfwd)."""
    pose2, pts, _, xy2 = make_scene(rng, n=80)
    xy2 = (xy2 + rng.normal(scale=0.5 / 500.0, size=(80, 2))).astype(np.float32)
    w = (rng.uniform(size=80) > 0.2).astype(np.float32)
    q0 = pose2.quat + np.array([0.0, 0.01, -0.02, 0.01], np.float32)
    q0 /= np.linalg.norm(q0)
    t0 = pose2.t + np.array([0.05, -0.03, 0.04], np.float32)
    pj = _refine(jp.Rigid3d(jnp.asarray(q0), jnp.asarray(t0)), pts, xy2, w, iters=5)
    pt = tp.refine_pose_gn(Rigid3d(_t(q0), _t(t0)), _t(pts), _t(xy2), _t(w), iters=5)
    _close_pose(pt, pj, atol=1e-5)
    assert rot_angle_deg(pt.quat, pose2.quat) < 0.1


def _two_view_indices(pairs, seed=0, num_hyp=512):
    """The samples the JAX batch entry point draws for each pair: per bucket,
    fold_in(PRNGKey(seed), position in the bucket), split into the essential's
    and the homography's keys."""
    buckets = {}
    for i, p in enumerate(pairs):
        buckets.setdefault(jtv._next_bucket(len(p[4])), []).append(i)
    out = [None] * len(pairs)
    for bucket, idxs in buckets.items():
        for j, i in enumerate(idxs):
            valid = np.arange(bucket) < len(pairs[i][4])
            kE, kH = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), j))
            out[i] = (_idx(kE, num_hyp, 8, valid), _idx(kH, num_hyp, 4, valid))
    return out


def _two_view_both(pairs, well_posed=True):
    """Both packages' two-view results with the same draws; beyond the
    config, compared only where the essential's hypotheses are well posed."""
    out_j = jtv.estimate_two_view_geometry_batch(pairs)
    out_t = ttv.estimate_two_view_geometry_batch(pairs, indices=_two_view_indices(pairs), device="cpu")
    for tj, tt in zip(out_j, out_t):
        assert tt.config == tj.config
        if well_posed:
            assert tt.num_inliers == tj.num_inliers
            np.testing.assert_array_equal(tt.inlier_matches, tj.inlier_matches)
            _close_pose(tt.pose, tj.pose)
            np.testing.assert_allclose(tt.tri_angle, tj.tri_angle, rtol=1e-4)
            _close_up_to_sign(tt.E, tj.E)
    return out_t


def _pair(xy1, xy2):
    return (CAM, CAM, _px(xy1), _px(xy2), np.stack([np.arange(len(xy1))] * 2, -1))


def test_two_view_geometry_classification(rng):
    _, _, xy1, xy2 = make_scene(rng, n=150)
    (tvg,) = _two_view_both([_pair(xy1, xy2)])
    assert tvg.config == ttv.TwoViewConfig.CALIBRATED and tvg.num_inliers > 130 and tvg.tri_angle > 3.0
    _, _, xy1, xy2 = make_scene(rng, n=150, planar=True)
    (tvg,) = _two_view_both([_pair(xy1, xy2)], well_posed=False)
    assert tvg.config == ttv.TwoViewConfig.PLANAR_OR_PANORAMIC
    # the port's own cameras and draws (a seeded torch.Generator)
    out = ttv.estimate_two_view_geometry(_CAM_T, _CAM_T, *_pair(xy1, xy2)[2:], device="cpu")
    assert out.config == ttv.TwoViewConfig.PLANAR_OR_PANORAMIC


def test_two_view_geometry_batch_and_invert(rng):
    pairs = [_pair(*make_scene(rng, n=n)[2:]) for n in (50, 120, 120)]
    out = _two_view_both(pairs)
    assert all(tvg.config == ttv.TwoViewConfig.CALIBRATED for tvg in out)
    inv = out[0].invert()
    inv_j = jtv.TwoViewGeometry(out[0].config, out[0].inlier_matches, jtv.Rigid3d(out[0].pose.quat, out[0].pose.t),
                                out[0].tri_angle, out[0].E, out[0].num_inliers).invert()
    np.testing.assert_array_equal(inv.pose.quat, inv_j.pose.quat)
    np.testing.assert_allclose(inv.pose.t, inv_j.pose.t, atol=1e-6)
    np.testing.assert_array_equal(inv.inlier_matches, out[0].inlier_matches[:, ::-1])
    q = quat_mul(torch.as_tensor(inv.pose.quat, dtype=torch.float32), torch.as_tensor(out[0].pose.quat))
    assert abs(float(q[0])) > 0.9999


def test_two_view_geometry_too_few_matches():
    matches = np.zeros((3, 2), int)
    tvg = ttv.estimate_two_view_geometry(CAM, CAM, np.zeros((5, 2)), np.zeros((5, 2)), matches, device="cpu")
    tj = jtv.estimate_two_view_geometry(CAM, CAM, np.zeros((5, 2)), np.zeros((5, 2)), matches)
    assert tvg.config == tj.config == ttv.TwoViewConfig.DEGENERATE
    assert tvg.num_inliers == tj.num_inliers == 0


def test_ransac_homography_planar(rng):
    """The homography RANSAC of test_homography_pose_recovery_planar (its
    decomposition, decompose_homography_np, comes with the mapper's port)."""
    _, _, xy1, xy2 = make_scene(rng, n=150, planar=True)
    valid = np.ones(150, bool)
    out_j = jr.ransac_homography(jax.random.PRNGKey(0), jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid),
                                 THRESH, num_hyp=256)
    out_t = tr.ransac_homography(_t(_idx(jax.random.PRNGKey(0), 256, 4, valid)), _t(xy1), _t(xy2), _t(valid), THRESH)
    err = th.homography_transfer_error_sq(out_t["H"], _t(xy1), _t(xy2))
    _masks_agree(out_t["inlier_mask"], out_j["inlier_mask"], err, np.float32(THRESH))
    assert int(out_t["num_inliers"]) == int(out_j["num_inliers"]) > 120
    np.testing.assert_allclose(out_t["H"].numpy(), np.asarray(out_j["H"]), atol=TOL)
    # the minimal solver alone, on four exact points (H[2, 2] = 1 fixes the scale)
    Hj = _homography(xy1[:4], xy2[:4], minimal=True)
    Ht = th.homography_from_four_points(_t(xy1[:4]), _t(xy2[:4]), minimal=True)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-3, atol=1e-4)


def test_sample_indices_draw_valid_entries_without_replacement():
    valid = torch.zeros(40, dtype=torch.bool)
    valid[:25] = True
    g = torch.Generator().manual_seed(0)
    idx = tr.sample_indices(g, 300, 8, valid)
    assert idx.shape == (300, 8) and int(idx.max()) < 25
    assert all(len(set(r)) == 8 for r in idx.tolist())
    again = tr.sample_indices(torch.Generator().manual_seed(0), 300, 8, valid)
    assert torch.equal(idx, again)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_estimators_on_card_match_cpu(rng, cuda):
    """The port on the card against the port on the CPU with the same
    samples: two-view estimation of three pairs and PnP, at the tests' size.
    The same config, inlier counts within 1%, poses within 1e-3 where the
    winning hypothesis is the same."""
    scenes = [make_scene(rng, n=120) for _ in range(3)]
    xy1 = torch.tensor(np.stack([s[2] for s in scenes]))
    xy2 = torch.tensor(np.stack([_corrupt(rng, s[3], 30) for s in scenes]))
    valid = torch.ones(3, 120, dtype=torch.bool)
    g = torch.Generator().manual_seed(0)
    idx_e = torch.stack([tr.sample_indices(g, 512, 8, v) for v in valid])
    idx_h = torch.stack([tr.sample_indices(g, 512, 4, v) for v in valid])
    thr = torch.full((3,), THRESH)
    outs = [ttv._estimate_pair(*(a.to(d) for a in (idx_e, idx_h, xy1, xy2, valid, thr, thr))) for d in (cuda, "cpu")]
    gpu, cpu = outs
    assert torch.equal(gpu["config"].cpu(), cpu["config"])
    assert ((gpu["num_inliers"].cpu() - cpu["num_inliers"]).abs() <= 0.01 * cpu["num_inliers"]).all()
    same = gpu["best"].cpu() == cpu["best"]
    assert same.any()
    for k in (0, 1):
        assert float((gpu["pose"][k].cpu() - cpu["pose"][k])[same].abs().max()) <= 1e-3
    pose2, pts, _, xy = make_scene(rng, n=300)
    xy = _corrupt(rng, xy + rng.normal(scale=0.5 / 500.0, size=xy.shape), 90).astype(np.float32)
    v = torch.ones(300, dtype=torch.bool)
    idx = tr.sample_indices(torch.Generator().manual_seed(1), 512, 6, v)
    pg, pc = (tr.ransac_pnp(*(a.to(d) for a in (idx, _t(pts), _t(xy), v)), THRESH) for d in (cuda, "cpu"))
    assert abs(int(pg["num_inliers"]) - int(pc["num_inliers"])) <= 0.01 * int(pc["num_inliers"])
    if int(pg["best"]) == int(pc["best"]):
        _close_pose(Rigid3d(pg["pose"].quat.cpu(), pg["pose"].t.cpu()), pc["pose"], atol=1e-3)
    assert rot_angle_deg(pg["pose"].quat.cpu(), pose2.quat) < 0.5
