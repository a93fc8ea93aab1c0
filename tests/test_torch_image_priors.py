"""ImagePriors and the bundle-level functions of scene/image_priors.py: the port
against the JAX package on the CPU.

The scene is tests/synthetic.PlaneScene (with_priors=True, 5 images × 200
points) with every image registered at its true pose (the last three
moved by 1 cm), a point for every true point seen by at least two images,
and every depth activated; `convert.reconstruction` and
`convert.image_priors` carry the JAX state across, so both packages start
from the same state. The port runs its kernels' plain versions (K2's PCG,
K3's deflated PCG) on the CPU.

Tolerances, as the existing files hold the same functions:
  - host-built rows (anchor payloads, static and prior rows, BiniInputs,
    host z0): equal; a z0 resized on the device within 1e-6
    (tests/test_torch_diag_inverse.py's resize_log_dev bound);
  - integration: the same changed maps, mean |Δz| < 1e-4 per lane and
    energies within 1e-5 relative (tests/test_torch_bini.py);
  - int_covs (diag(H⁻¹) to uncertainty_update), batched, deferred and over
    the whole image: within 1e-3 relative (tests/test_torch_diag_inverse.py).
The int_covs cases run with int_cov_rel_floor 0, so K3's values, not the
floor, reach uncertainty_update.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.ba.covariance import calculate_point_covs as jcovs
from mpsfm_tpu.ba.problem import build_ba_data as jbuild
from mpsfm_tpu.integration import bini as jbini
from mpsfm_tpu.scene import image_priors as jip
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.ba.covariance import calculate_point_covs as tcovs
from mpsfm_tpu_torch.ba.problem import build_ba_data as tbuild
from mpsfm_tpu_torch.integration import bini as tbini
from mpsfm_tpu_torch.scene import image_priors as tip

sys.path.insert(0, os.path.dirname(__file__))
from synthetic import PlaneScene  # noqa: E402

MEAN_TOL = 1e-4  # mean |Δz| in log-depth (tests/test_torch_bini.py)
E_RTOL = 1e-5  # energies
VAR_RTOL = 1e-3  # diag(H⁻¹) and the variances made of it
RESIZE_TOL = 1e-6  # resize_log_dev


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one intra-op thread: the tier-1 run's six workers, each with
    a thread per core by default, oversubscribe the cores (a six-file run
    under six workers took twice as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plane_scene(seed=0, n_images=5, n_points=200, pose_noise=0.01):
    """A JAX Reconstruction of a PlaneScene with priors, registered at the
    true poses (the last images moved by pose_noise), a point (the true
    one moved by 2 cm) for every true point seen by two or more images,
    every depth activated. Returns (rec, gt)."""
    scene = PlaneScene(rng=np.random.default_rng(seed), n_images=n_images, n_points=n_points, point_jitter=0.3)
    rec, _, _, gt = scene.build(with_priors=True)
    rng = np.random.default_rng(seed + 100)
    tracks = {}
    for i, pose in enumerate(gt["poses"]):
        im = rec.images[i]
        p = pose.transform(gt["points"])
        px = p[:, :2] / p[:, 2:] * scene.focal + np.array([scene.W / 2, scene.H / 2])
        d = np.linalg.norm(im.keypoints[:, None] - px[None], axis=-1)
        for kp, pt in enumerate(d.argmin(1)):  # the keypoint's true point, where it is one
            if d[kp, pt] < 2.0:
                tracks.setdefault(int(pt), []).append((i, kp))
        t = pose.t + (rng.normal(scale=pose_noise, size=3) if i >= 2 else 0.0)
        im.pose = type(pose)(pose.q.copy(), t)
        im.registered = True
    for pt, tr in sorted(tracks.items()):
        if len(tr) >= 2 and len({i for i, _ in tr}) == len(tr):
            rec.add_point3D(gt["points"][pt] + rng.normal(scale=0.02, size=3), tr)
    for im in rec.images.values():
        im.depth.activate()
    return rec, gt


def plane_pair(seed=0, floor=None, **kw):
    """(JAX rec, port rec, JAX priors, port priors) of plane_scene: the port
    side converted on the CPU; int_cov_rel_floor set to `floor` on both
    when given."""
    rj, _ = plane_scene(seed, **kw)
    rt = convert.reconstruction(rj)
    pj = [rj.images[i].priors for i in sorted(rj.images)]
    pt = [convert.image_priors(p, rt, device="cpu") for p in pj]
    if floor is not None:
        for p in pj + pt:
            p.conf.int_cov_rel_floor = floor
    return rj, rt, pj, pt


def global_bundle(rec):
    return {"optim_ids": set(rec.reg_image_ids()), "pts3D": set(rec.point_ids().tolist()), "constpoints": set()}


def park_covs(rj, rt):
    """Point covariances of the global bundle parked in both packages'
    LazyCovDict (the JAX and the port's calculate_point_covs)."""
    b = global_bundle(rj)
    jcovs(rj, jbuild(rj, b, use_depth=False, representation="sparse"))
    tcovs(rt, tbuild(rt, b, use_depth=False, representation="sparse", device="cpu"))


def _same(x, y):
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return np.array_equal(np.asarray(x), np.asarray(y))
    return x == y


def test_converter_carries_image_priors():
    rj, rt, pj, pt = plane_pair()
    for a, b in zip(pj, pt):
        assert b.rec is rt and b.imid == a.imid and b.device.type == "cpu" and b.conf == a.conf
        for x, y in ((a.depth, b.depth), (a.normals, b.normals)):
            assert vars(x).keys() == vars(y).keys()
            assert all(_same(v, vars(y)[k]) for k, v in vars(x).items()), type(x)
        assert b.integrator.params._asdict() == a.integrator.params._asdict()
        assert (b.integrator.energy_old, b.integrator.integrated) == (a.integrator.energy_old, a.integrator.integrated)
        im = rt.images[a.imid]
        assert im.priors is b and im.depth is b.depth and im.normals is b.normals
    # a device working map crosses as a tensor, its host copy unread
    z = np.log(pj[0].depth.data_prior).astype(np.float32)
    pj[0].depth.set_data_from_device(jnp.asarray(z))
    pj[0].integrator.energy_old, pj[0].integrator.integrated = 12.5, True
    b = convert.image_priors(pj[0], rt, device="cpu")
    assert b.depth._data is None and torch.equal(b.depth._data_dev, torch.as_tensor(z))
    assert (b.integrator.energy_old, b.integrator.integrated) == (12.5, True)
    np.testing.assert_array_equal(b.depth.data, pj[0].depth.data)


def test_converter_refuses_the_cpu_without_a_card(monkeypatch):
    rj, rt, pj, _ = plane_pair()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.image_priors(pj[0], rt)


@pytest.mark.parametrize("covs", ["default", "host", "parked"])
@pytest.mark.parametrize("ds", [1, 2])
def test_anchor_payload_matches_jax(covs, ds):
    """Slot codes -2 (a host precision: no covariance, or a host one), >= 0
    (a parked device view) and the view's fallback to a raw host
    covariance (-2 again): equal rows."""
    rj, rt, pj, pt = plane_pair()
    if covs == "host":
        rng = np.random.default_rng(1)
        for pid in rj.point_ids():
            a = rng.normal(scale=0.03, size=(3, 3))
            rj.point_covs[int(pid)] = rt.point_covs[int(pid)] = a @ a.T + 1e-4 * np.eye(3)
    elif covs == "parked":
        park_covs(rj, rt)
        pid = int(rj.point_ids()[3])
        rj.point_covs[pid] = rt.point_covs[pid] = np.eye(3) * 2e-3  # overrides the view's slot
    for a, b in zip(pj, pt):
        pa, pb = a._anchor_payload(ds), b._anchor_payload(ds)
        assert pa.shape == pb.shape and len(pa) > 20
        np.testing.assert_array_equal(pb, pa)
        codes = set(np.unique(pb[:, 4]).tolist())
        assert codes == {-2.0} if covs != "parked" else max(codes) > 0
    if covs == "parked":
        assert any(-2.0 in b._anchor_payload(ds)[:, 4] for b in pt)


@pytest.mark.parametrize("ds", [1, 2])
def test_static_prior_rows_and_inputs_match_jax(ds):
    rj, rt, pj, pt = plane_pair()
    for a, b in zip(pj, pt):
        for d in (a.depth, b.depth):
            d.rescale(0.0, 1.25)  # multiplicative: the cache keeps its rows, z_prior moves by log(1.25)
        s8a, sha = a.static_prior_dev(ds)
        s8b, shb = b.static_prior_dev(ds)
        np.testing.assert_array_equal(s8b.numpy(), np.asarray(s8a))
        assert shb == sha == 0.0
        ia, ib = a.build_inputs(ds), b.build_inputs(ds)
        for f in tbini.BiniInputs._fields:
            np.testing.assert_array_equal(getattr(ib, f), np.asarray(getattr(ia, f)), err_msg=f)
        np.testing.assert_array_equal(b._grid_K(), a._grid_K())
        np.testing.assert_array_equal(b._R2(), a._R2())


@pytest.mark.parametrize("mode", ["prior", "host", "device"])
@pytest.mark.parametrize("ds", [1, 2])
def test_z0_shift_dev_matches_jax(mode, ds):
    """The working log-depth z0 and its scalar shift: from the prior rows
    (not activated), from the host map, and from a device map after a
    multiplicative rescale; a second call after another rescale hits the
    cache and moves only the shift."""
    rj, rt, pj, pt = plane_pair()
    a, b = pj[1], pt[1]
    for p in (a, b):
        if mode == "prior":
            p.depth.reset()
            p.static_prior_dev(ds)
            p.depth.rescale(0.0, 1.2)
        elif mode == "device":
            z = np.log(p.depth.data_prior * 1.1).astype(np.float32)
            p.depth.set_data_from_device(jnp.asarray(z) if p is a else torch.as_tensor(z))
            p.depth.rescale(0.0, 0.9, rescale_working=True)
    for step in range(2):
        za, sa = a._z0_shift_dev(ds)
        zb, sb = b._z0_shift_dev(ds)
        tol = RESIZE_TOL if (mode == "device" and ds > 1) else 0.0
        np.testing.assert_allclose(zb.numpy(), np.asarray(za), rtol=0, atol=tol)
        assert sb == sa
        for p in (a, b):
            p.depth.rescale(0.0, 1.05, rescale_working=True)
    assert sb == pytest.approx(np.log(1.05) + (np.log(1.2) if mode == "prior" else 0.0))


def colliding_anchors(rng):
    """Anchor rows of two lanes whose 50 anchors fall on 16 pixels, every
    slot code; a covariance tensor; the lanes' (z0, stat8) pairs."""
    H, W, Ka = 12, 16, 64
    anch = np.zeros((2, 6, Ka), np.float32)
    anch[:, 0], anch[:, 4] = H, -1
    L = 50
    anch[:, 0, :L] = rng.integers(0, 4, (2, L))
    anch[:, 1, :L] = rng.integers(0, 4, (2, L))
    anch[:, 2, :L] = rng.uniform(3, 6, (2, L))
    anch[:, 3, :L] = rng.normal(size=(2, L))
    anch[:, 4, :L] = rng.choice([-1, -2, 0, 1], (2, L))
    anch[:, 5, 2:5] = [0, 0, 1]
    cov = (np.eye(3)[None] * rng.uniform(1e-3, 1e-2, (3, 1, 1))).astype(np.float32)
    pairs = [(rng.normal(size=(H, W)).astype(np.float32), rng.normal(size=(8, H, W)).astype(np.float32))
             for _ in range(2)]
    return anch, cov, pairs


def test_colliding_anchors_keep_the_last_as_jax(rng):
    """Two anchors on one pixel: prec_sparse the max, z_sparse the last
    anchor's, as XLA's scatter on the CPU keeps it."""
    anch, cov, pairs = colliding_anchors(rng)
    ref = jbini._assemble_batch_anchors(jnp.asarray(anch), jnp.asarray(cov),
                                        [tuple(map(jnp.asarray, p)) for p in pairs])
    got = tbini._assemble_batch_anchors(torch.as_tensor(anch), torch.as_tensor(cov),
                                        [tuple(map(torch.as_tensor, p)) for p in pairs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _changed_equal_and_z_close(pj, pt, cj, ct):
    assert cj == ct
    for a, b in zip(pj, pt):
        assert b.integrator.integrated == a.integrator.integrated
        np.testing.assert_allclose(b.integrator.energy_old, a.integrator.energy_old, rtol=E_RTOL)
        if ct[b.imid]:
            assert b.depth._data is None  # device-resident until read
            dz = np.abs(np.log(b.depth.data) - np.log(a.depth.data))
            assert dz.mean() < MEAN_TOL, (b.imid, dz.mean())


def test_integrate_bundle_batched_matches_jax():
    rj, rt, pj, pt = plane_pair()
    cj, ct = jip.integrate_bundle_batched(pj), tip.integrate_bundle_batched(pt)
    assert all(ct.values())
    _changed_equal_and_z_close(pj, pt, cj, ct)
    # the working maps are read to the host by materialize_depths with the lazy getter's math
    _, rt2, _, pt2 = plane_pair()
    tip.integrate_bundle_batched(pt2)
    tip.materialize_depths(rt2, sorted(rt2.images))
    for b, b2 in zip(pt, pt2):
        assert b2.depth._data is not None
        np.testing.assert_array_equal(b2.depth._data, b.depth.data)
    assert pt[0].integrate() == pj[0].integrate()  # the gate now skips or refines lane 0 alone, as in JAX


def test_integrate_deferred_then_rescale_matches_jax():
    """integrate_bundle_deferred + finalize_integration, a multiplicative
    rescale of every working map (the z0 caches keep their epoch and move
    by a scalar), and a second deferred integration: the same changed
    maps, the handles' z and the info rows within bounds. The second
    integration starts from the JAX package's first result in both
    packages: its warm-started PCG exits after 1-3 iterations, and on
    this scene a z0 that differs by 2e-5 sends lane 3 to another IRLS
    solution (energy 1069.3 against 1096.2); from the same z0 the two
    packages agree to 1e-5 (measured on the CPU)."""
    rj, rt, pj, pt = plane_pair()
    for step in range(2):
        hj, pendj = jip.integrate_bundle_deferred(pj)
        ht, pendt = tip.integrate_bundle_deferred(pt)
        assert len(pendj) == len(pendt) == 1 and ht.keys() == hj.keys()
        ij, it = np.asarray(pendj[0][2])[: len(pj)], pendt[0][2].numpy()
        np.testing.assert_array_equal(it[:, 2:], ij[:, 2:])  # refine, aborted
        np.testing.assert_allclose(it[:, :2], ij[:, :2], rtol=E_RTOL)
        zj = {i: np.asarray(jbini.take_z(hj[i][0], jnp.int32(hj[i][1]))) for i in hj}
        for imid in hj:
            assert np.abs(tbini.take_z(*ht[imid]).numpy() - zj[imid]).mean() < MEAN_TOL
        ct = tip.finalize_integration(pendt)
        assert step or all(ct.values())
        _changed_equal_and_z_close(pj, pt, jip.finalize_integration(pendj), ct)
        for a, b in zip(pj, pt):
            if ct[b.imid]:  # the same working map and gate state in both
                z = torch.tensor(zj[b.imid])
                b.depth.set_data_from_device(z)
                b.seed_z0(z)
                b.integrator.energy_old = a.integrator.energy_old
        for p in pj + pt:
            p.depth.rescale(0.0, 1.08, rescale_working=True)
        for a, b in zip(pj, pt):
            (za, sa), (zb, sb) = a._z0_shift_dev(), b._z0_shift_dev()
            np.testing.assert_array_equal(zb.numpy(), np.asarray(za))
            assert sb == sa == pytest.approx(np.log(1.08))


def test_int_covs_bundle_batched_matches_jax():
    rj, rt, pj, pt = plane_pair(floor=0.0)
    park_covs(rj, rt)
    jip.integrate_bundle_batched(pj)
    tip.integrate_bundle_batched(pt)
    before = [np.array(b.depth.uncertainty_update) for b in pt]
    jip.int_covs_bundle_batched(pj)
    tip.int_covs_bundle_batched(pt)
    for a, b, u0 in zip(pj, pt, before):
        ua, ub = np.asarray(a.depth.uncertainty_update), np.asarray(b.depth.uncertainty_update)
        np.testing.assert_allclose(ub, ua, rtol=VAR_RTOL)
        assert (ub != u0).all() and b.int_covs_applied


def test_int_covs_deferred_matches_jax():
    """int_covs_bundle_deferred chained off a deferred integration of two
    images (the mapper's local path): the device rows of the updated
    variances, then finalize_integration + finalize_int_covs on the host;
    and the same through finalize_deferred_all."""
    for finalize in ("pair", "all"):
        rj, rt, pj, pt = plane_pair(floor=0.0)
        park_covs(rj, rt)
        pj, pt = pj[1:3], pt[1:3]
        hj, pendj = jip.integrate_bundle_deferred(pj)
        ht, pendt = tip.integrate_bundle_deferred(pt)
        mj = {p.imid: (info, k) for g, _z, info in pendj for k, p in enumerate(g)}
        mt = {p.imid: (info, k) for g, _z, info in pendt for k, p in enumerate(g)}
        uj, cj = jip.int_covs_bundle_deferred(pj, hj, mj)
        ut, ct = tip.int_covs_bundle_deferred(pt, ht, mt)
        for b in pt:
            K = len(b.depth.uncertainty_update)
            np.testing.assert_allclose(ut[b.imid].numpy()[:K], np.asarray(uj[b.imid])[:K], rtol=VAR_RTOL)
        if finalize == "pair":
            chj, cht = jip.finalize_integration(pendj), tip.finalize_integration(pendt)
            jip.finalize_int_covs(cj, [np.asarray(e[1]) for e in cj], chj)
            tip.finalize_int_covs(ct, [e[1].numpy() for e in ct], cht)
        else:
            chj, cht = jip.finalize_deferred_all(pendj, cj), tip.finalize_deferred_all(pendt, ct)
        assert chj == cht and all(cht.values())
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b.depth.uncertainty_update, a.depth.uncertainty_update, rtol=VAR_RTOL)
            np.testing.assert_allclose(b.depth.uncertainty_update, ut[b.imid].numpy()[: len(b.depth.uncertainty_update)],
                                       rtol=1e-6)


def test_int_covs_at_kps_and_entire_image_match_jax():
    rj, rt, pj, pt = plane_pair(floor=0.0)
    park_covs(rj, rt)
    a, b = pj[0], pt[0]
    sel = np.arange(0, len(rt.images[0].keypoints), 3)
    np.testing.assert_allclose(b.calculate_int_covs_at_kps(sel), a.calculate_int_covs_at_kps(sel), rtol=VAR_RTOL)
    np.testing.assert_allclose(b.depth.uncertainty_update, a.depth.uncertainty_update, rtol=VAR_RTOL)
    # the main path's downscaled grid; at the full grid (downscaled=False) 16 iterations leave anchored
    # pixels far from converged (3.6x at one pixel) and float32 order moves them by up to 1.7% in either
    # package (ROADMAP queue 3)
    for kw in ({"stride": 8}, {"stride": 8, "ignore_depths": True}):
        va, vb = a.calculate_int_covs_for_entire_image(**kw), b.calculate_int_covs_for_entire_image(**kw)
        assert vb.shape == va.shape == a.depth.data_prior.shape and (vb > 0).all()
        np.testing.assert_allclose(vb, va, rtol=VAR_RTOL)


@pytest.mark.cuda
def test_colliding_anchors_on_card(rng):
    """The card keeps the same anchor per pixel as the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    anch, cov, pairs = colliding_anchors(rng)
    args = [(torch.as_tensor(anch), torch.as_tensor(cov), [tuple(map(torch.as_tensor, p)) for p in pairs])]
    args.append((args[0][0].cuda(), args[0][1].cuda(), [tuple(t.cuda() for t in p) for p in args[0][2]]))
    cpu, card = (tbini._assemble_batch_anchors(*a) for a in args)
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_image_priors_chain_on_card():
    """integrate_bundle_batched then int_covs_bundle_batched on the card
    (K2, K3) against the CPU from the same converted state: the same
    changed maps, z within 1e-3 max, variances within 1e-3 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rj, _ = plane_scene()
    runs = []
    for dev in ("cuda", "cpu"):
        rt = convert.reconstruction(rj)
        pt = [convert.image_priors(rj.images[i].priors, rt, device=dev) for i in sorted(rj.images)]
        for p in pt:
            p.conf.int_cov_rel_floor = 0.0
        changed = tip.integrate_bundle_batched(pt)
        tip.int_covs_bundle_batched([p for p in pt if changed[p.imid]])
        runs.append((changed, pt))
    (cg, pg), (cc, pc) = runs
    assert cg == cc
    for g, c in zip(pg, pc):
        assert np.abs(np.log(g.depth.data) - np.log(c.depth.data)).max() <= 1e-3
        np.testing.assert_allclose(g.depth.uncertainty_update, c.depth.uncertainty_update, rtol=VAR_RTOL)
