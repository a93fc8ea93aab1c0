"""The depth-consistency checker with its ladder: the port's
DepthConsistencyChecker against the JAX package's on the cases of
tests/test_mapper_units.py (two views of the analytic plane with exact
depth, view 2 shifted by 0, 0.3 or 1.5), carried across with
`convert.reconstruction` and `convert.image_priors`.

Tolerances: bundle scores within 1e-6 of the JAX checker's (both count the
same float32 pixels, tests/test_torch_depth_consistency.py); the per-pair
classification of `check_depth_consistency` equal; the ladder state equal.
On the two-grid bundle one query pixel lands 2e-6 px from the top edge of
a ref's canvas, inside it for the port and outside for the JAX package
(XLA contracts a·b + c into an FMA, the port does not): there the counts
may differ only by the pixels within 1e-4 px of a canvas edge, and the
score by 1e-5.

A bundle whose refs lie on two integration grids (a second camera with a
smaller grid, its depth 0.3 too far) is scored over the counts of both
groups, as the JAX checker adds them before it takes the score; its score
differs from either group's alone, so a checker that scores one group does
not pass.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu.mapper.depth_consistency import DepthConsistencyChecker as JChecker
from mpsfm_tpu.scene.image_priors import ImagePriors as JPriors
from mpsfm_tpu.scene.reconstruction import HostCamera as JCamera
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.mapper import depth_consistency as tdc
from mpsfm_tpu_torch.mapper.depth_consistency import DepthConsistencyChecker as TChecker

from synthetic import PlaneScene
from test_mapper_units import make_dc_rec
from test_torch_depth_consistency import _bundle_args, _jax_counts, _port_counts

SCORE_TOL = 1e-6


def port_rec(rj):
    """The JAX reconstruction and its priors carried to the port (CPU)."""
    rt = convert.reconstruction(rj)
    for imid, im in rj.images.items():
        if getattr(im, "priors", None) is not None:
            convert.image_priors(im.priors, rt, device="cpu")
    return rt


def both(rj, conf=None):
    rt = port_rec(rj)
    return (JChecker(conf or {}, rj), rj), (TChecker(conf or {}, rt, device="cpu"), rt)


SHIFTS = [0.0, 0.3, 1.5]


@pytest.mark.parametrize("shift", SHIFTS)
def test_bundle_score_matches_jax(rng, shift):
    (dj, _), (dt, _) = both(make_dc_rec(rng, shift=shift))
    sj = dj.check_bundle_depth_consistency(0, {"optim_ids": {0, 1}})
    st = dt.check_bundle_depth_consistency(0, {"optim_ids": {0, 1}})
    assert abs(st - sj) <= SCORE_TOL, (st, sj)
    # the mapper's verdicts of tests/test_mapper_units.py
    assert (st < 0.15) if shift == 0.0 else True
    assert (st > 0.15) if shift == 1.5 else True
    # check_image records the score and runs the ladder as the JAX checker
    assert dt.check_image(1, {"optim_ids": {0, 1}}) == dj.check_image(1, {"optim_ids": {0, 1}})
    assert abs(dt.rec.images[1].last_dc_score - dj.rec.images[1].last_dc_score) <= SCORE_TOL
    assert dt.reg_batch_dc_times_failed == dj.reg_batch_dc_times_failed
    assert dt.rec.images[1].failed_dc_check == dj.rec.images[1].failed_dc_check
    assert dt.check_init_pair((0, 1)) == dj.check_init_pair((0, 1))


@pytest.mark.parametrize("shift", SHIFTS)
def test_per_pair_classification_matches_jax(rng, shift):
    """check_depth_consistency (the per-pair chain with host whitening), and
    the batched score against the per-pair chain as the JAX package's own
    test holds it (abs 0.02)."""
    (dj, _), (dt, _) = both(make_dc_rec(rng, shift=shift))
    oj, ot = dj.check_depth_consistency(0, 1), dt.check_depth_consistency(0, 1)
    assert set(oj) == set(ot)
    for k in oj:
        np.testing.assert_array_equal(ot[k], oj[k], err_msg=k)
    ref_nv = int((~ot["valid2"] & ot["valid2_mask"]).sum())
    ref_v = int((ot["valid2_mask"] & ~ot["occl2"]).sum())
    qry_nv = int((~ot["valid1"] & ot["valid1_mask"]).sum())
    qry_v = int((ot["valid1_mask"] & ~ot["occl1"]).sum())
    legacy = max(ref_nv / max(ref_v, 0.1), qry_nv / max(qry_v, 0.1))
    assert dt.check_bundle_depth_consistency(0, {"optim_ids": {0, 1}}) == pytest.approx(legacy, abs=0.02)


def test_relax_ladder_matches_jax(rng):
    (dj, rj), (dt, rt) = both(make_dc_rec(rng))
    for d in (dj, dt):
        t0 = d.depth_cons_thresh
        d.relax_thresholds()
        d.relax_thresholds()
        assert d.depth_cons_thresh == pytest.approx(t0 * 1.3 * 1.3)
    assert (dt.depth_cons_thresh, dt.cons_thresh_times_increased) == (dj.depth_cons_thresh,
                                                                      dj.cons_thresh_times_increased)
    for d, r in ((dj, rj), (dt, rt)):
        r.images[1].ignore_matches_AP = {0: np.ones(3, bool)}
        r.images[1].failed_dc_check = True
        d.at_registration_success()
        assert d.depth_cons_thresh == d.conf.depth_cons_thresh and d.cons_thresh_times_increased == 0
        assert r.images[1].ignore_matches_AP == {} and not r.images[1].failed_dc_check


def test_pre_fail_matches_jax(rng):
    """The sequence of tests/test_mapper_units.py::test_dc_pre_fail_logic on
    both checkers."""
    rj = make_dc_rec(rng)
    rt = port_rec(rj)
    verdicts = []
    for Checker, rec, kw in ((JChecker, rj, {}), (TChecker, rt, {"device": "cpu"})):
        out = []
        dc = Checker({}, rec, **kw)
        im = rec.images[1]
        out.append(dc.pre_fail(1))
        im.last_dc_score = 0.5
        out += [dc.pre_fail(1), dc.reg_batch_dc_times_failed]
        dc2 = Checker({"depth_consistency_resample": True}, rec, **kw)
        im.dc_times_inliers_resampled = 0
        out.append(dc2.pre_fail(1))
        im.dc_times_inliers_resampled = 1
        out.append(dc2.pre_fail(1))
        dc2.skip_dc_check = True
        out.append(dc2.pre_fail(1))
        im.last_dc_score = 0.05
        dc2.skip_dc_check = False
        out.append(dc2.pre_fail(1))
        verdicts.append(out)
    assert verdicts[0] == verdicts[1] == [False, True, 1, False, True, False, False]


def test_resample_blacklists_ap_inliers_as_jax(rng):
    rj = make_dc_rec(rng)
    rt = port_rec(rj)
    for Checker, rec, kw in ((JChecker, rj, {}), (TChecker, rt, {"device": "cpu"})):
        dc = Checker({"depth_consistency_resample": True}, rec, **kw)
        rec.last_ap_inlier_masks = {0: np.array([True, False, True, False])}
        dc.at_failure(1)
        rec.last_ap_inlier_masks = {0: np.array([True, False])}
        dc.at_failure(1)
        assert dc.reg_batch_dc_times_failed == 2
    assert rt.images[1].dc_times_inliers_resampled == rj.images[1].dc_times_inliers_resampled == 2
    np.testing.assert_array_equal(rt.images[1].ignore_matches_AP[0], rj.images[1].ignore_matches_AP[0])
    np.testing.assert_array_equal(rt.images[1].ignore_matches_AP[0], [True, True, True, False])


def two_grid_rec(seed=4):
    """Four views of the analytic plane at 64×48 (focal 60); image 3 on a
    second camera with the same intrinsics and a 48×36 integration grid, its
    priors built there."""
    scene = PlaneScene(rng=np.random.default_rng(seed), n_images=4, n_points=10, img_wh=(64, 48), focal=60.0)
    rec, _, _, gt = scene.build(with_priors=True, depth_scale_err_range=(1.0, 1.0))
    for i in range(4):
        rec.images[i].registered = True
        rec.images[i].pose = gt["poses"][i]
    cam = JCamera(2, np.array([60.0, 60.0, 32.0, 24.0]), 64, 48)
    cam.int_width, cam.int_height = 48, 36
    rec.add_camera(cam)
    rec.images[3].camera_id = 2
    pose = gt["poses"][3]
    depth = 0.3 + scene.plane_depth(pose) * np.exp(np.random.default_rng(seed).normal(scale=0.05, size=(48, 64)))
    pri = JPriors(rec.images[0].priors.conf, rec, 3, depth_dict={"depth": depth},
                  normals_dict={"normals": scene.cam_normals(pose)})
    rec.images[3].priors, rec.images[3].depth, rec.images[3].normals = pri, pri.depth, pri.normals
    return rec


def _edge_pixels(args, tol=1e-4):
    """Per pair (B, 2): the in-canvas source pixels of each direction whose
    target lies within tol px of a canvas edge."""
    q, r, M_qr, M_rq, r2_qr, r2_rq = tdc._pair_args(*[torch.tensor(np.asarray(a)) for a in args])
    out = []
    for src, dst, M, r2 in ((q, r, M_qr, r2_qr), (r, q, M_rq, r2_rq)):
        p, _, m, _, _ = tdc._dir_maps(*src, *dst, M, r2, 15.0, 0.6)
        H2, W2 = dst[0].shape[-2:]
        u, v = p[..., 0], p[..., 1]
        near = (u.abs() < tol) | (v.abs() < tol) | ((u + 0.5 - W2).abs() < tol) | ((v + 0.5 - H2).abs() < tol)
        out.append((near & m).sum((-2, -1)))
    return torch.stack(out, -1).numpy()


def test_refs_on_two_grids_score_as_jax():
    rj = two_grid_rec()
    (dj, _), (dt, rt) = both(rj)
    assert rt.images[3].depth.data_prior.shape == (36, 48) and rt.images[1].depth.data_prior.shape == (48, 64)
    bundle = {"optim_ids": {0, 1, 2, 3}}
    sj = dj.check_bundle_depth_consistency(0, bundle)
    st = dt.check_bundle_depth_consistency(0, bundle)
    assert abs(st - sj) <= 1e-5, (st, sj)
    for refs in ([1, 2], [3]):  # each group's counts: JAX's but at canvas-edge pixels
        _, args = _bundle_args(rj, 0, refs)
        gap = np.abs(_port_counts(args) - _jax_counts(args))
        edge = _edge_pixels(args)
        assert (gap[:, :2] <= edge[:, :1]).all() and (gap[:, 2:] <= edge[:, 1:]).all(), (gap, edge)
    # the groups' counts alone score differently: the score needs both
    counts = []
    for refs in ([1, 2], [3]):
        (d_q, fq), (v_q, vq), K_q = dt._dc_dev(0)
        items = [dt._dc_dev(r) for r in refs]
        rows = tdc.pair_rows((rt.images[0].pose.q, rt.images[0].pose.t),
                             [(rt.images[r].pose.q, rt.images[r].pose.t) for r in refs])
        counts.append(tdc._bundle_counts(
            d_q, v_q, K_q, torch.tensor([fq, vq], dtype=torch.float32), torch.stack([it[0][0] for it in items]),
            torch.stack([it[1][0] for it in items]), torch.stack([it[2] for it in items]), torch.tensor(rows),
            15.0, 0.6))
    assert tdc.bundle_score(counts) == st
    assert all(tdc.bundle_score(c) != st for c in counts)
