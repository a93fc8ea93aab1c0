"""The BA problem, the point covariances' store, shift/scale and the
Optimizer's dense path: the port against the JAX package on the CPU.

Scenes: tests/test_ba.make_synthetic_rec (6 cameras × 200 points, every
point seen by every camera, FakeDepth rows where depth is wanted) and the
PlaneScene of tests/test_torch_image_priors.py (5 images × 200 points,
real Depth/Normals priors), carried across with `convert`.

Tolerances:
  - build_ba_data: every array equal (the host passes are the same numpy
    code; the port's index fields are int64); apply_ba_result and the
    host numpy of shift/scale, the truncation multiplier and the fallback
    covariances to 1e-12 (in practice equal);
  - point covariances: max |Δ| ≤ 1e-3·max |cov| (tests/test_torch_covariance.py)
    on make_synthetic_rec; on the PlaneScene the reduced system is worse
    conditioned and both packages' float32 covariances sit ~2.6e-3 of
    max |cov| from a float64 solve, on opposite sides, so there each is
    held to its distance from the float64 solve, the port no further than
    the JAX package;
  - Optimizer: cost within 1e-3 relative, quat and t within 1e-4, xyz
    within 1e-3, the truncation multiplier within 1e-4 relative
    (tests/test_torch_dense_ba.py, tests/test_torch_slice.py); the accepted
    counts by the LM's latch rule (tests/test_torch_dense_ba.py): equal
    where no step moved the cost by less than float32 resolution;
  - the refinement chain from the same state before each entry point
    (each step starts from the JAX package's state, so a float32 flip in
    one step does not carry into the next): integration and int_covs as
    tests/test_torch_image_priors.py holds them.
The dense-path cases of tests/test_ba.py run on the port's build_ba_data
and Optimizer with their own bounds.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.ba import shift_scale as jss
from mpsfm_tpu.ba.covariance import calculate_point_covs as jcovs
from mpsfm_tpu.ba.problem import apply_ba_result as japply
from mpsfm_tpu.ba.problem import build_ba_data as jbuild
from mpsfm_tpu.integration.bini import take_z as jtake
from mpsfm_tpu.mapper.optimizer import Optimizer as JOptimizer
from mpsfm_tpu.scene import image_priors as jip
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.ba import covariance as tcov
from mpsfm_tpu_torch.ba import problem as tproblem
from mpsfm_tpu_torch.ba import shift_scale as tss
from mpsfm_tpu_torch.mapper import optimizer as topt
from mpsfm_tpu_torch.scene import image_priors as tip
from mpsfm_tpu_torch.scene.reconstruction import LazyCovDict

sys.path.insert(0, os.path.dirname(__file__))
from test_ba import FakeDepth, make_synthetic_rec, pose_errors  # noqa: E402
from test_torch_image_priors import MEAN_TOL, VAR_RTOL, global_bundle, one_torch_thread, plane_pair  # noqa: E402,F401

FTOL = 1e-12
COV_REL = 1e-3
COST_RTOL, QUAT_TOL, T_TOL, XYZ_TOL, TRUNC_RTOL = 1e-3, 1e-4, 1e-4, 1e-3, 1e-4


def synthetic_pair(rng, depth=False, **kw):
    """make_synthetic_rec in both packages (FakeDepth rows on every image
    when `depth`)."""
    rj, gt = make_synthetic_rec(rng, **kw)
    rt = convert.reconstruction(rj)
    if depth:
        for i in rj.images:
            rj.images[i].depth = FakeDepth(rj, i)
            rt.images[i].depth = FakeDepth(rt, i)
    return rj, rt, gt


def local_bundle(rec, ref, others):
    """The mapper's local bundle shape: the ref's points variable, the
    other optimized images' points constant."""
    optim = {ref, *others}
    pts = set()
    for i in optim:
        ids = rec.images[i].point3D_ids
        pts.update(ids[ids >= 0].tolist())
    ids = rec.images[ref].point3D_ids
    own = set(ids[ids >= 0].tolist())
    return {"ref_id": ref, "optim_ids": optim, "pts3D": own, "constpoints": pts - own}


def assert_problem_equal(pj, pt):
    assert pt.cam_ids == pj.cam_ids and (pt.n_cams, pt.n_pts) == (pj.n_cams, pj.n_pts)
    np.testing.assert_array_equal(pt.pt_ids, pj.pt_ids)
    for name in ("data", "dense"):
        a, b = getattr(pj, name), getattr(pt, name)
        assert (a is None) == (b is None), name
        if b is None:
            continue
        if name == "data":
            assert getattr(a, "bs", None) is None
        for f in b._fields:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if y is not None:
                x = np.asarray(x)
                assert y.dtype == (torch.int64 if np.issubdtype(x.dtype, np.integer) else torch.float32), f
                assert x.shape == tuple(y.shape) and np.array_equal(x, y.numpy()), f"{name}.{f}"
    if pj.depth_specs is None:
        assert pt.depth_specs is None
    else:
        assert pt.depth_specs.keys() == pj.depth_specs.keys()
        for k, v in pj.depth_specs.items():
            assert np.array_equal(np.asarray(v), np.asarray(pt.depth_specs[k])), k


BUILDS = {
    "default": {},
    "solve": {"representation": "solve"},
    "sparse_covs": {"representation": "sparse", "use_depth": False},
    "local": {"mode": "local", "local": True},
    "fix_pose_prior": {"fix_pose": True, "depth_type": "prior", "allow_scale_filter": True},
    "device_depth": {"representation": "solve", "device_depth": True},
    "device_depth_local": {"representation": "solve", "device_depth": True, "mode": "local", "local": True},
    "weights": {"param_multiplier": 1.7, "truncation_multiplier": 2.5, "depth_rob_scale": 1.5,
                "reproj_loss_scale_mult": 2.0, "allow_scale_filter": True, "scale_filter_factor": 1.2},
}


# FakeDepth has no grid: the device-depth builds run on the PlaneScene only
@pytest.mark.parametrize("scene,name", [(s, n) for s in ("synthetic", "plane") for n in sorted(BUILDS)
                                        if s == "plane" or not BUILDS[n].get("device_depth")])
def test_build_ba_data_matches_jax(rng, scene, name):
    kw = dict(BUILDS[name])
    if scene == "synthetic":
        rj, rt, _ = synthetic_pair(rng, depth=True, n_cams=4, n_pts=60)
    else:
        rj, rt, _, _ = plane_pair()
    bundle = local_bundle(rj, 1, (0, 2)) if kw.pop("local", False) else global_bundle(rj)
    pj, pt = jbuild(rj, bundle, **kw), tproblem.build_ba_data(rt, bundle, device="cpu", **kw)
    assert_problem_equal(pj, pt)
    assert pt.dense is not None or kw.get("representation") == "sparse"
    if kw.get("use_depth", True) and not kw.get("device_depth"):
        assert pt.data is None or int(pt.data.d_valid.sum()) > 0


def test_apply_ba_result_matches_jax(rng):
    rj, rt, _ = synthetic_pair(rng, n_cams=4, n_pts=60)
    bundle = global_bundle(rj)
    pj, pt = jbuild(rj, bundle), tproblem.build_ba_data(rt, bundle, device="cpu")
    C, P = pt.dense.quat.shape[0], pt.dense.xyz.shape[0]
    quat = rng.normal(size=(C, 4)).astype(np.float32)
    t, xyz = rng.normal(size=(C, 3)).astype(np.float32), rng.normal(size=(P, 3)).astype(np.float32)
    japply(rj, pj, quat, t, xyz)
    tproblem.apply_ba_result(rt, pt, torch.as_tensor(quat), torch.as_tensor(t), xyz)
    for i in rj.images:
        np.testing.assert_allclose(rt.images[i].pose.q, rj.images[i].pose.q, rtol=0, atol=FTOL)
        np.testing.assert_allclose(rt.images[i].pose.t, rj.images[i].pose.t, rtol=0, atol=FTOL)
    np.testing.assert_array_equal(rt.xyz, rj.xyz)


def test_block_schur_branch_raises(rng, monkeypatch):
    """A problem above the dense layout (Pb·Cb > DENSE_MAX) is refused
    unless only the sparse tables are asked for (the covariance path)."""
    rj, rt, _ = synthetic_pair(rng, n_cams=4, n_pts=60)
    monkeypatch.setattr(tproblem, "DENSE_MAX", 16)
    for rep in ("both", "solve"):
        with pytest.raises(NotImplementedError, match="slice 6a"):
            tproblem.build_ba_data(rt, global_bundle(rt), representation=rep, device="cpu")
    p = tproblem.build_ba_data(rt, global_bundle(rt), representation="sparse", device="cpu")
    assert p.dense is None and p.data is not None and p.data.pc_r_slot is None


def test_entry_points_refuse_the_cpu_without_a_card(rng, monkeypatch):
    rj, rt, _ = synthetic_pair(rng, n_cams=3, n_pts=30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tproblem.build_ba_data(rt, global_bundle(rt)), lambda: topt.Optimizer({}, rt)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_point_covs_into_lazy_dict_match_jax(rng):
    """Optimizer.calculate_point_covs parks the covariances on the device
    (LazyCovDict: a view and the slots, no host read) in the JAX package's
    layout; the host reads equal the view's rows; a plain dict store gets
    host arrays; above max_cams_dense a ValueError."""
    rj, rt, _ = synthetic_pair(rng, noise_px=0.5)
    bundle = global_bundle(rj)
    JOptimizer({}, rj).calculate_point_covs(bundle)
    topt.Optimizer({}, rt, device="cpu").calculate_point_covs(bundle)
    cj = np.asarray(rj.point_covs.device_view()[0])
    ct, slots = rt.point_covs.device_view()
    assert slots == rj.point_covs.device_view()[1] and rt.point_covs._pendings
    assert np.abs(ct.numpy() - cj).max() <= COV_REL * np.abs(cj).max()
    pids = rt.point_ids()
    np.testing.assert_array_equal(rt.point_covs.slots_for(pids), rj.point_covs.slots_for(pids))
    host = np.stack([rt.point_covs[int(p)] for p in pids])  # the first host access reads the tensor once
    np.testing.assert_array_equal(host, ct.double().numpy()[slots_of(slots, pids)])
    prob = tproblem.build_ba_data(rt, bundle, use_depth=False, representation="sparse", device="cpu")
    rt.point_covs = {}
    cov = tcov.calculate_point_covs(rt, prob)
    assert isinstance(cov, np.ndarray) and len(rt.point_covs) == len(pids)
    np.testing.assert_array_equal(rt.point_covs[int(pids[0])], cov[0])
    with pytest.raises(ValueError, match="dense covariance"):
        tcov.calculate_point_covs(rt, prob, max_cams_dense=2)
    with pytest.raises(ValueError, match="dense covariance"):
        jcovs(rj, jbuild(rj, bundle, use_depth=False, representation="sparse"), max_cams_dense=2)


def slots_of(slot_map, pids):
    return np.array([slot_map[int(p)] for p in pids])


def test_point_covs_on_the_plane_scene_as_close_to_float64_as_jax():
    rj, rt, _, _ = plane_pair()
    bundle = global_bundle(rj)
    pj = jbuild(rj, bundle, use_depth=False, representation="sparse")
    pt = tproblem.build_ba_data(rt, bundle, use_depth=False, representation="sparse", device="cpu")
    cj = np.asarray(jcovs(rj, pj))
    ct = tcov.calculate_point_covs(rt, pt).numpy()
    d64 = type(pt.data)(*[None if f is None else (f.double() if f.is_floating_point() else f) for f in pt.data])
    ref = cov64(d64).numpy()
    n, scale = pt.n_pts, np.abs(ref[: pt.n_pts]).max()
    ej, et = (np.abs(c[:n] - ref[:n]).max() / scale for c in (cj, ct))
    assert et <= max(ej, COV_REL), (et, ej)


def cov64(data):
    """point_covariances in float64 with a float64 Cholesky solve."""
    solve = tcov.cholesky_solve
    tcov.cholesky_solve = lambda S, b: torch.cholesky_solve(b, torch.linalg.cholesky(S))
    try:
        return tcov.point_covariances(data)
    finally:
        tcov.cholesky_solve = solve


def test_fallback_point_covs_match_jax(rng, monkeypatch):
    """The per-point Hpp⁻¹ fallback, also taken by calculate_point_covs
    when the dense system is refused."""
    rj, rt, _ = synthetic_pair(rng, n_cams=4, n_pts=60)
    bundle = global_bundle(rj)
    rj.point_covs, rt.point_covs = {}, {}
    JOptimizer({}, rj)._fallback_point_covs(bundle)
    topt.Optimizer({}, rt, device="cpu")._fallback_point_covs(bundle)
    assert rt.point_covs.keys() == rj.point_covs.keys()
    for pid, c in rj.point_covs.items():
        np.testing.assert_allclose(rt.point_covs[pid], c, rtol=0, atol=FTOL)
    rt.point_covs = LazyCovDict()
    monkeypatch.setattr(topt, "MAX_CAMS_DENSE", 2)
    topt.Optimizer({}, rt, device="cpu").calculate_point_covs(bundle)
    assert rt.point_covs.device_view() is None and len(rt.point_covs) == len(rj.point_covs)


def test_shift_scale_and_truncation_match_jax(rng):
    """tests/test_ba.py:194-219 on both packages: a prior 2x too small
    gives scale ~2; perfect depths a multiplier below 0.1; the MAD fit."""
    rj, rt, _ = synthetic_pair(rng, n_cams=3, n_pts=80, noise_px=0.0, pose_noise=0.0)
    for rec in (rj, rt):
        for i in range(3):
            fd = FakeDepth(rec, i, scale_err=0.5)
            fd.activated = False
            rec.images[i].depth = fd
    bundle = {"optim_ids": {0, 1, 2}, "pts3D": set(rj.point_ids().tolist())}
    (sj, okj), (st, okt) = jss.optimize_prior_shiftscale(rj, bundle), tss.optimize_prior_shiftscale(rt, bundle)
    assert okj and okt and st.keys() == sj.keys() and len(st) == 3
    for imid, (shift, scale) in st.items():
        assert shift == 0.0 and abs(scale - 2.0) < 0.05 and scale == pytest.approx(sj[imid][1], rel=0, abs=FTOL)
    for rec in (rj, rt):
        for i in range(3):
            rec.images[i].depth = FakeDepth(rec, i, sigma=0.1)
    mj, mt = jss.update_truncation_multiplier(rj, [0, 1, 2]), tss.update_truncation_multiplier(rt, [0, 1, 2])
    assert mt < 0.1 and mt == pytest.approx(mj, rel=0, abs=FTOL)
    data = np.array([0.0, 1, 2, 3, 4, 100.0])
    assert tss.fit_robust_gaussian_mad(data) == jss.fit_robust_gaussian_mad(data)


@pytest.mark.parametrize("metric", [False, True])
def test_shift_scale_on_priors_matches_jax(metric):
    """Real priors: optimize_prior_shiftscale (with the metric-scale filter
    on a local bundle), Depth.rescale, update_truncation_multiplier."""
    rj, rt, _, _ = plane_pair()
    bundle = local_bundle(rj, 2, (1, 3)) if metric else global_bundle(rj)
    oj, ot = JOptimizer({}, rj), topt.Optimizer({}, rt, device="cpu")
    (sj, okj), (st, okt) = (o.optimize_prior_shiftscale(bundle, allow_metric_scale_filter=metric,
                                                         allow_scale_filter=True) for o in (oj, ot))
    assert okj == okt and st == sj and st
    for rec, ss in ((rj, sj), (rt, st)):
        for imid, (shift, scale) in ss.items():
            rec.images[imid].depth.rescale(shift, scale)
    oj.update_truncation_multiplier(rj.reg_image_ids())
    ot.update_truncation_multiplier(rt.reg_image_ids())
    assert ot.truncation_multiplier == pytest.approx(oj.truncation_multiplier, rel=0, abs=FTOL)


def assert_ba_close(info_j, info_t, rj, rt):
    assert info_t["cost0"] == pytest.approx(info_j["cost0"], rel=COST_RTOL)
    assert info_t["cost"] == pytest.approx(info_j["cost"], rel=COST_RTOL) and info_t["cost"] < info_t["cost0"]
    for i in rj.images:
        np.testing.assert_allclose(rt.images[i].pose.q, rj.images[i].pose.q, rtol=0, atol=QUAT_TOL)
        np.testing.assert_allclose(rt.images[i].pose.t, rj.images[i].pose.t, rtol=0, atol=T_TOL)
    pids = rj.point_ids()
    np.testing.assert_allclose(rt.xyz[pids], rj.xyz[pids], rtol=0, atol=XYZ_TOL)


@pytest.mark.parametrize("depth", [False, True])
def test_optimizer_ba_matches_jax(rng, depth):
    """Optimizer.ba (dense, host depth rows): cost, poses and points. The
    accepted counts are not held (the latch rule): without depth rows the
    bundle converges within a few steps and the rel_tol latch fires at an
    iteration that float32 order decides (measured: 5 accepted steps in
    the port, 6 in the JAX package, in 8 iterations)."""
    rj, rt, _ = synthetic_pair(rng, depth=depth, noise_px=0.5)
    bundle = global_bundle(rj)
    (ij, okj), (it, okt) = (o.ba(bundle) for o in (JOptimizer({}, rj), topt.Optimizer({}, rt, device="cpu")))
    assert okj and okt and it["accepted"] >= 3
    assert_ba_close(ij, it, rj, rt)


def port_rec(rng, depth=False, **kw):
    rj, rt, gt = synthetic_pair(rng, depth=depth, **kw)
    return rt, gt


def test_port_ba_converges_to_gt(rng):
    rec, gt = port_rec(rng, noise_px=0.5)
    info, ok = topt.Optimizer({"max_iters": 25}, rec, device="cpu").ba(global_bundle(rec))
    assert ok and info["cost"] < info["cost0"] * 0.2
    rot, trans = pose_errors(rec, gt)
    assert rot.max() < 0.2 and trans.max() < 0.05, (rot, trans)
    assert np.median(np.linalg.norm(rec.xyz[rec.point_ids()] - gt["pts"], axis=1)) < 0.1


def test_port_ba_gauge_fixed(rng):
    rec, _ = port_rec(rng)
    q0, t0, tx1 = rec.images[0].pose.q.copy(), rec.images[0].pose.t.copy(), rec.images[1].pose.t[0]
    topt.Optimizer({"max_iters": 10}, rec, device="cpu").ba(global_bundle(rec))
    np.testing.assert_allclose(rec.images[0].pose.q, q0, atol=1e-6)
    np.testing.assert_allclose(rec.images[0].pose.t, t0, atol=1e-6)
    np.testing.assert_allclose(rec.images[1].pose.t[0], tx1, atol=1e-5)


def test_port_fix_pose_refines_points_only(rng):
    rec, gt = port_rec(rng, pose_noise=0.0, noise_px=0.5)
    before = {i: rec.images[i].pose.q.copy() for i in rec.images}
    info, ok = topt.Optimizer({"max_iters": 15}, rec, device="cpu").refine_3d_points(global_bundle(rec), depth_type="prior")
    assert ok and info["cost"] < info["cost0"]
    for i in rec.images:
        np.testing.assert_allclose(rec.images[i].pose.q, before[i], atol=1e-6)
    assert np.median(np.linalg.norm(rec.xyz[rec.point_ids()] - gt["pts"], axis=1)) < 0.1


def test_port_robust_loss_rejects_outliers(rng):
    rec, gt = port_rec(rng, noise_px=0.5, pose_noise=0.01)
    rec.images[3].keypoints[:20] += 80.0
    topt.Optimizer({"max_iters": 25}, rec, device="cpu").ba(global_bundle(rec))
    rot, trans = pose_errors(rec, gt)
    assert rot.max() < 0.5 and trans.max() < 0.05


def test_port_depth_priors_fix_scale_drift(rng):
    rec, _ = port_rec(rng, depth=True, noise_px=0.3, pose_noise=0.0)
    for pid in rec.point_ids():
        rec.xyz[pid] *= 1.1
    for i in rec.images:
        rec.images[i].pose.t = rec.images[i].pose.t * 1.1
    opt = topt.Optimizer({"max_iters": 30}, rec, device="cpu")
    assert int(opt._build(global_bundle(rec), "global", False, 1.0, False, "update").dense.d_w.gt(0).sum()) > 0
    info, ok = opt.ba(global_bundle(rec))
    assert ok and info["cost"] < 0.1 * info["cost0"]


def test_unported_solvers_raise(rng, monkeypatch):
    """A bundle above the dense layout (solve_ba, slice 6a) and a sharded
    solve (ROADMAP queue 1 item 5) raise from every BA entry point before
    the reconstruction changes; neither falls back."""
    _, rt, _ = synthetic_pair(rng, n_cams=3, n_pts=30)
    opt = topt.Optimizer({}, rt, device="cpu")
    bundle = global_bundle(rt)
    before = rt.xyz.copy()
    calls = (lambda: opt.ba(bundle), lambda: opt.ba_fused(bundle, "global", None),
             lambda: opt.refine_3d_points(bundle))
    with monkeypatch.context() as m:
        m.setattr(tproblem, "DENSE_MAX", 16)
        for call in calls:
            with pytest.raises(NotImplementedError, match="slice 6a"):
                call()
    assert opt._use_dist_ba(bundle, "global") == 0  # one device
    assert topt.Optimizer({"dist_ba": "on"}, rt, device="cpu")._use_dist_ba(bundle, "global") == 0
    monkeypatch.setattr(topt.Optimizer, "_use_dist_ba", lambda self, bundle, mode: 2)
    monkeypatch.setattr(topt, "build_ba_data", lambda *a, **k: pytest.fail("built before the refusal"))
    for call in calls[:2]:  # refine_3d_points fixes the poses: never sharded
        with pytest.raises(NotImplementedError, match="item 5"):
            call()
    np.testing.assert_array_equal(rt.xyz, before)


def sync(rj, rt, pj, pt, oj, ot):
    """The port's state set to the JAX package's: poses, points, working
    depth maps, uncertainty_update, the gate's energies, the parked
    covariances and the truncation multiplier."""
    for i, im in rj.images.items():
        rt.images[i].pose.q, rt.images[i].pose.t = im.pose.q.copy(), im.pose.t.copy()
    n = min(len(rt.xyz), len(rj.xyz))
    rt.xyz[:n] = rj.xyz[:n]
    for a, b in zip(pj, pt):
        dev = getattr(a.depth, "_data_dev", None)
        if dev is not None:
            z = torch.tensor(np.asarray(dev))
            b.depth.set_data_from_device(z)
            b.depth.data_log_shift = a.depth.data_log_shift
            b.seed_z0(z)
        elif a.depth._data is not None:
            b.depth.data = a.depth._data.copy()
        b.depth.uncertainty_update = np.array(a.depth.uncertainty_update)
        b.integrator.energy_old, b.integrator.integrated = a.integrator.energy_old, a.integrator.integrated
    view = rj.point_covs.device_view()
    if view is not None:
        rt.point_covs = LazyCovDict()
        rt.point_covs.set_pending(torch.tensor(np.asarray(view[0])), [p for p, _ in sorted(view[1].items(), key=lambda kv: kv[1])])
    ot.truncation_multiplier = oj.truncation_multiplier


def z_getter(handles, pris, take):
    """The mapper's z_getter: a handle's fresh lane, else the cached z0."""
    return lambda i: (take(*handles[i]), 0.0) if i in handles else pris[i]._z0_shift_dev()


def lanes(pending):
    return {p.imid: (info, k) for g, _z, info in pending for k, p in enumerate(g)}


def assert_priors_close(pj, pt, cj, ct):
    assert cj == ct
    for a, b in zip(pj, pt):
        if ct.get(b.imid):
            assert np.abs(np.log(b.depth.data) - np.log(a.depth.data)).mean() < MEAN_TOL
        np.testing.assert_allclose(b.depth.uncertainty_update, a.depth.uncertainty_update, rtol=VAR_RTOL)


@pytest.mark.parametrize("fused_refine", ["1", "0"])
def test_optimizer_refinement_chain_matches_jax(monkeypatch, fused_refine):
    """The refinement steps in the JAX Mapper's order, each from the JAX
    package's state: calculate_point_covs; a global step (integrate all
    lanes deferred; finalize; int_covs_bundle_batched on the changed;
    ba_fused with update_trunc); a local step of one image
    (integrate_bundle_deferred, int_covs_bundle_deferred, ba_fused with
    pending, unc_overrides and pending_covs); optimize_prior_shiftscale,
    rescale and refine_3d_points (MPSFM_FUSED_REFINE 1: fused on the
    device rows, 0: host depth rows)."""
    monkeypatch.setenv("MPSFM_FUSED_REFINE", fused_refine)
    rj, rt, pj, pt = plane_pair()
    oj, ot = JOptimizer({}, rj), topt.Optimizer({}, rt, device="cpu")
    bundle = global_bundle(rj)

    oj.calculate_point_covs(bundle)
    ot.calculate_point_covs(bundle)
    cj, ct = np.asarray(rj.point_covs.device_view()[0]), rt.point_covs.device_view()[0].numpy()
    assert ct.shape == cj.shape and rt.point_covs.device_view()[1] == rj.point_covs.device_view()[1]
    sync(rj, rt, pj, pt, oj, ot)

    (hj, pendj), (ht, pendt) = jip.integrate_bundle_deferred(pj), tip.integrate_bundle_deferred(pt)
    chj, cht = jip.finalize_integration(pendj), tip.finalize_integration(pendt)
    jip.int_covs_bundle_batched([p for p in pj if chj[p.imid]])
    tip.int_covs_bundle_batched([p for p in pt if cht[p.imid]])
    assert_priors_close(pj, pt, chj, cht)
    sync(rj, rt, pj, pt, oj, ot)
    ht = {i: (torch.tensor(np.asarray(jtake(z, jnp.int32(k)))), 0) for i, (z, k) in hj.items()}
    ij, okj = oj.ba_fused(bundle, "global", lambda i: (jtake(hj[i][0], jnp.int32(hj[i][1])), 0.0),
                          allow_scale_filter=True, update_trunc=True)
    it, okt = ot.ba_fused(bundle, "global", lambda i: (ht[i][0], 0.0), allow_scale_filter=True, update_trunc=True)
    assert okj and okt
    assert ot.truncation_multiplier == pytest.approx(oj.truncation_multiplier, rel=TRUNC_RTOL)
    assert_ba_close(ij, it, rj, rt)
    assert all(b.depth._data is None for b in pt if cht[b.imid])  # the BA read no working map
    sync(rj, rt, pj, pt, oj, ot)

    ref = 2
    lb = local_bundle(rj, ref, (1, 3))
    (hj, pendj), (ht, pendt) = jip.integrate_bundle_deferred([pj[ref]]), tip.integrate_bundle_deferred([pt[ref]])
    uj, covj = jip.int_covs_bundle_deferred([pj[ref]], hj, lanes(pendj))
    ut, covt = tip.int_covs_bundle_deferred([pt[ref]], ht, lanes(pendt))
    K = len(pt[ref].depth.uncertainty_update)
    np.testing.assert_allclose(ut[ref].numpy()[:K], np.asarray(uj[ref])[:K], rtol=VAR_RTOL)
    ij, okj = oj.ba_fused(lb, "local", z_getter(hj, pj, lambda z, k: jtake(z, jnp.int32(k))), pending=pendj,
                          allow_scale_filter=True, unc_overrides=uj, pending_covs=covj)
    it, okt = ot.ba_fused(lb, "local", z_getter(ht, pt, lambda z, k: z[k]), pending=pendt,
                          allow_scale_filter=True, unc_overrides=ut, pending_covs=covt)
    assert okj and okt
    assert_ba_close(ij, it, rj, rt)
    assert pt[ref].integrator.integrated and pt[ref].integrator.energy_old == pytest.approx(
        pj[ref].integrator.energy_old, rel=1e-5)
    np.testing.assert_allclose(pt[ref].depth.uncertainty_update, pj[ref].depth.uncertainty_update, rtol=VAR_RTOL)
    sync(rj, rt, pj, pt, oj, ot)

    (sj, _), (st, _) = oj.optimize_prior_shiftscale(bundle), ot.optimize_prior_shiftscale(bundle)
    assert st == sj
    for rec, ss in ((rj, sj), (rt, st)):
        for imid, (shift, scale) in ss.items():
            rec.images[imid].depth.rescale(shift, scale)
    (ij, okj), (it, okt) = oj.refine_3d_points(bundle), ot.refine_3d_points(bundle)
    assert okj and okt
    assert_ba_close(ij, it, rj, rt)


def test_ba_fused_falls_back_through_finalize(monkeypatch):
    """A sharded decision makes ba_fused raise before it finalizes
    anything: the deferred integration and int_covs stay pending and the
    truncation multiplier stays. The JAX package's fallback, which
    finalizes them on the host (finalize_deferred_all) and takes the host
    truncation multiplier, then gives the same on both packages."""
    rj, rt, pj, pt = plane_pair()
    ot = topt.Optimizer({}, rt, device="cpu")
    hj, pendj = jip.integrate_bundle_deferred(pj[:2])
    ht, pendt = tip.integrate_bundle_deferred(pt[:2])
    uj, covj = jip.int_covs_bundle_deferred(pj[:2], hj, lanes(pendj))
    ut, covt = tip.int_covs_bundle_deferred(pt[:2], ht, lanes(pendt))
    unc0 = {b.imid: b.depth.uncertainty_update.copy() for b in pt[:2]}
    monkeypatch.setattr(topt.Optimizer, "_use_dist_ba", lambda self, bundle, mode: 2)
    with pytest.raises(NotImplementedError, match="item 5"):
        ot.ba_fused(global_bundle(rt), "global", None, pending=pendt, update_trunc=True, unc_overrides=ut,
                    pending_covs=covt)
    assert not any(b.integrator.integrated for b in pt[:2]) and ot.truncation_multiplier == 1.0
    for b in pt[:2]:
        np.testing.assert_array_equal(b.depth.uncertainty_update, unc0[b.imid])
    chj = jip.finalize_deferred_all(pendj, covj)
    cht = tip.finalize_deferred_all(pendt, covt)
    assert cht == chj and all(chj.values())
    assert all(b.integrator.integrated for b in pt[:2])
    assert_priors_close(pj[:2], pt[:2], chj, {b.imid: True for b in pt[:2]})
    mj = JOptimizer({}, rj)
    mj.update_truncation_multiplier(rj.reg_image_ids())
    ot.update_truncation_multiplier(rt.reg_image_ids())
    assert ot.truncation_multiplier == pytest.approx(mj.truncation_multiplier, rel=TRUNC_RTOL)


def test_chip_smoke_scene_refinement_on_the_cpu():
    """chip_smoke.py's scene refinement phase at the small size on the
    CPU: its entry points in the mapper's order and its checks."""
    import chip_smoke

    b = chip_smoke.synthetic_bundle(8, 256)
    rec, pris, truth = chip_smoke.refine_scene(b, 2, 48, 64, "cpu")
    prior_kps = {p.imid: p.depth.data_prior_at_kps(rec.images[p.imid].keypoints) for p in pris}
    times = {}
    out = chip_smoke.run_scene_refinement(rec, pris, "cpu", times)
    out["prior_kps"] = prior_kps
    q = chip_smoke.check_scene_refinement(out, rec, pris, truth, b)
    assert set(q["gaps"]) == {p.imid for p in pris}
    assert {"calculate_point_covs", "int_covs_bundle_batched", "ba_fused_local", "refine_3d_points"} <= times.keys()


@pytest.mark.cuda
def test_scene_refinement_card_vs_cpu():
    """chip_smoke.py's small scene refinement on the card against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    chip_smoke.scene_refinement_card_vs_cpu(torch.device("cuda"))
