"""Image registration: the port's Registration against the JAX package's.

- `decompose_homography_np` (numpy, Malis-Vargas) against the JAX
  package's (OpenCV's decomposeHomographyMat) on random homographies and
  on those of the scene's plane: the same candidates (R, t, n) as a set,
  within 1e-6.
- The exhaustive P3P of tiny 2D-3D sets (the cases of
  tests/test_mapper_units.py:250, :272): the same pose and inliers.
- The init pair and the next image on two populated PlaneScenes of 5
  images × 200 points with depth priors: the plane of
  __graft_entry__.dryrun_pipeline (seed 3) from its first ranked init
  pair, PLANAR_OR_PANORAMIC, so the homography branch runs; and the plane
  with 0.3 of off-plane jitter (seed 0, the scene of
  tests/test_image_selection.py) from its first CALIBRATED pair, so the
  essential branch runs. Carried across with `convert.reconstruction`,
  `convert.image_priors` and `convert.correspondences`.

torch cannot reproduce jax.random, so the port's `_draw` is replaced by
JAX's draws from the key each JAX entry point takes
(jax.random.PRNGKey(seed), registration.py:216, :232, :256) over the same
padded arrays. Then the poses agree within 1e-5 (both are float32 RANSACs
read to float64), the inlier masks and the points' tracks are equal, and
xyz within 1e-4 (triangulated from those poses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.estimators import ransac as jr
from mpsfm_tpu.estimators.homography import decompose_homography_np as jax_decompose
from mpsfm_tpu.mapper import registration as jreg
from mpsfm_tpu.mapper.image_selection import ImageSelection as JSelection
from mpsfm_tpu.mapper.triangulator import Triangulator as JTriangulator
from mpsfm_tpu.scene.correspondences import Correspondences as JCorr
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.estimators.homography import decompose_homography_np
from mpsfm_tpu_torch.mapper import registration as treg
from mpsfm_tpu_torch.mapper.triangulator import Triangulator as TTriangulator

from synthetic import PlaneScene

POSE_TOL, XYZ_TOL, H_TOL = 1e-5, 1e-4, 1e-6

_sample = jax.jit(jr._sample_indices, static_argnums=(1, 2, 3))


def jax_draws(seed, num_hyp, sample_size, n):
    """The samples the JAX RANSAC entry points draw from PRNGKey(seed) over
    the padded arrays, as the port's _draw returns them."""
    nb = treg._bucket(n)
    idx = _sample(jax.random.PRNGKey(int(seed)), num_hyp, sample_size, nb, jnp.arange(nb) < n)
    return torch.tensor(np.array(idx))


@pytest.fixture
def with_jax_draws(monkeypatch):
    monkeypatch.setattr(treg, "_draw", jax_draws)


def port_state(rj, cj, device="cpu"):
    """The JAX reconstruction, its priors and correspondences on the port."""
    rt = convert.reconstruction(rj)
    for im in rj.images.values():
        if getattr(im, "priors", None) is not None:
            convert.image_priors(im.priors, rt, device=device)
    return rt, convert.correspondences(cj, rt, device=device)


SCENES = {"planar": (3, 0.0), "calibrated": (0, 0.3)}


def populated(kind, cache, num_hyp=128):
    """A fresh JAX scene of SCENES[kind] (rec with priors, populated
    correspondences, truth); the verification is read from `cache` once it
    holds it."""
    seed, jitter = SCENES[kind]
    scene = PlaneScene(rng=np.random.default_rng(seed), n_images=5, n_points=200, point_jitter=jitter)
    rj, keypoints, matches, gt = scene.build()
    cj = JCorr({"num_hyp": num_hyp}, rj)
    cj.populate(keypoints, matches, cache_path=cache / f"{kind}.h5")
    return rj, cj, gt


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A TVG cache that holds both scenes' verification (run once)."""
    path = tmp_path_factory.mktemp("tvg")
    for kind in SCENES:
        populated(kind, path)
    return path


# ---- the homography decomposition ----

def _match_sets(a, b, tol):
    """Each candidate of a has one of b within tol (and the counts agree)."""
    assert len(a) == len(b)
    flat = lambda c: np.concatenate([np.ravel(c[0]), c[1], c[2]])  # noqa: E731
    B = np.stack([flat(c) for c in b])
    for c in a:
        gap = np.abs(B - flat(c)).max(1)
        assert gap.min() <= tol, gap.min()


def _rodrigues(w):
    return jreg._rodrigues_np(np.asarray(w, np.float64))


def test_decompose_homography_matches_opencv(rng):
    cases = []
    for _ in range(40):
        R = _rodrigues(rng.normal(scale=0.3, size=3))
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        cases.append((R + np.outer(rng.normal(size=3), n) / rng.uniform(1, 5)) * rng.uniform(0.3, 3))
    cases += [rng.normal(size=(3, 3)) for _ in range(20)]
    cases.append(_rodrigues([0.1, -0.2, 0.05]) * 2.0)  # a rotation: one candidate, t = n = 0
    for H in cases:
        _match_sets(decompose_homography_np(H), jax_decompose(H), H_TOL)
    assert len(decompose_homography_np(cases[-1])) == 1


def test_decompose_homography_of_the_scene_plane():
    """H = R + t nᵀ / d of the planar scene's cameras 0 and k: the same
    candidates as OpenCV's, and one of them the true motion."""
    scene = PlaneScene(rng=np.random.default_rng(3), n_images=5, n_points=200)
    n0, d = scene.n, scene.n[2] * scene.d0  # the plane n·X = d in camera 0's frame (the world)
    for k in range(1, 5):
        pose = scene.poses[k]
        R = pose.rotation_matrix()
        H = R + np.outer(pose.t, n0) / d
        out = decompose_homography_np(H)
        _match_sets(out, jax_decompose(H), H_TOL)
        t_unit = pose.t / np.linalg.norm(pose.t)
        # within the float32 square root that the decomposition takes, as OpenCV's does
        assert min(np.abs(np.concatenate([Ro.ravel() - R.ravel(), to - t_unit])).max() for Ro, to, _ in out) < 1e-6


# ---- the exhaustive P3P ----

def test_p3p_small_pnp_exact_recovery_as_jax():
    rng = np.random.default_rng(3)
    for n in (4, 5):
        R_gt = treg._rodrigues_np(rng.normal(scale=0.3, size=3))
        X = rng.uniform(-1, 1, (n, 3)) + np.array([0, 0, 6.0])
        Pc = X @ R_gt.T + np.array([0.2, -0.1, 0.3])
        xyn = Pc[:, :2] / Pc[:, 2:]
        out, ref = treg.run_pnp_small(X, xyn, 1e-8), jreg.run_pnp_small(X, xyn, 1e-8)
        assert out["num_inliers"] == ref["num_inliers"] == n
        np.testing.assert_array_equal(out["inlier_mask"], ref["inlier_mask"])
        np.testing.assert_allclose(out["pose"].q, ref["pose"].q, rtol=0, atol=1e-12)
        np.testing.assert_allclose(out["pose"].t, ref["pose"].t, rtol=0, atol=1e-12)
        Pc2 = X @ out["pose"].rotation_matrix().T + out["pose"].t
        np.testing.assert_allclose(Pc2[:, :2] / Pc2[:, 2:], xyn, atol=1e-6)


def test_p3p_small_pnp_with_outlier_as_jax():
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 1, (5, 3)) + np.array([0, 0, 5.0])
    Pc = X + np.array([0.0, 0.0, 0.2])
    xyn = Pc[:, :2] / Pc[:, 2:]
    xyn[4] += 0.1
    out, ref = treg.run_pnp_small(X, xyn, 1e-6), jreg.run_pnp_small(X, xyn, 1e-6)
    assert out["num_inliers"] == ref["num_inliers"] == 4 and not out["inlier_mask"][4]
    np.testing.assert_allclose(out["pose"].t, ref["pose"].t, rtol=0, atol=1e-12)


# ---- the init pair and the next image ----

def _close_pose(pt, pj, tol=POSE_TOL):
    np.testing.assert_allclose(pt.q, pj.q, rtol=0, atol=tol)
    np.testing.assert_allclose(pt.t, pj.t, rtol=0, atol=tol)


def assert_same_map(rj, rt):
    """Same registered images and poses, same tracks and point3D_ids, xyz close."""
    assert rt.reg_image_ids() == rj.reg_image_ids()
    for imid in rj.reg_image_ids():
        _close_pose(rt.images[imid].pose, rj.images[imid].pose)
        np.testing.assert_array_equal(rt.images[imid].point3D_ids, rj.images[imid].point3D_ids)
    np.testing.assert_array_equal(rt.point_ids(), rj.point_ids())
    for pid in rj.point_ids():
        assert rt.tracks[pid] == rj.tracks[pid]
    xyz_j = rj.xyz[rj.point_ids()]
    np.testing.assert_allclose(rt.xyz[rt.point_ids()], xyz_j, rtol=0, atol=XYZ_TOL * np.abs(xyz_j).max())


def registrations(rj, cj, conf):
    rt, ct = port_state(rj, cj)
    reg_j = jreg.Registration(conf, rj, cj, JTriangulator({}, rj, cj.cg))
    reg_t = treg.Registration(conf, rt, ct, TTriangulator({}, rt, ct.cg), device="cpu")
    return reg_j, reg_t


def init_pair(kind, rj, cj):
    """The planar scene's first ranked init pair; the calibrated scene's
    first CALIBRATED pair."""
    if kind == "planar":
        pair = JSelection({}, rj, cj).find_init_pairs()[0]
        assert int(cj.two_view_geom_by_ids(*pair).config) in (4, 5, 6)
        return pair
    return next(p for p in cj.image_pairs() if int(cj.two_view_geom_by_ids(*p).config) == 2)


@pytest.mark.parametrize("kind", list(SCENES))
def test_init_pair_matches_jax(cache, with_jax_draws, kind):
    rj, cj, _ = populated(kind, cache)
    pair = init_pair(kind, rj, cj)
    reg_j, reg_t = registrations(rj, cj, {"num_hyp": 128})
    ok_t = reg_t.register_and_triangulate_init_pair(*pair)
    ok_j = reg_j.register_and_triangulate_init_pair(*pair)
    assert ok_t == ok_j is True
    assert_same_map(reg_j.rec, reg_t.rec)
    assert reg_t.rec.num_points3D() >= 10


@pytest.mark.parametrize("lifted", [True, False], ids=["lifted", "triangulated_only"])
@pytest.mark.parametrize("kind", list(SCENES))
def test_register_next_image_matches_jax(cache, with_jax_draws, kind, lifted):
    """After the init pair, the next image (the JAX ImageSelection's pick)
    registers from the triangulated points of its refs and, with lifting,
    the untriangulated keypoints lifted by the refs' depth priors: the same
    pose, AP inlier masks per ref, and triangulated map. The init pairs
    triangulate a few dozen points, so the AP inlier floor is 8 (the
    ladder's reduced floor) for the triangulated-only case to register."""
    rj, cj, _ = populated(kind, cache)
    pair = init_pair(kind, rj, cj)
    conf = {"num_hyp": 128, "lifted_registration": lifted, "abs_pose_min_num_inliers": 8}
    reg_j, reg_t = registrations(rj, cj, conf)
    assert reg_j.register_and_triangulate_init_pair(*pair) and reg_t.register_and_triangulate_init_pair(*pair)
    sel = JSelection({}, rj, cj)
    assert sel.next_image()
    cand = sel.candid
    ok_t = reg_t.register_and_triangulate_next_image(cand)
    ok_j = reg_j.register_and_triangulate_next_image(cand)
    assert ok_t == ok_j is True
    mj, mt = reg_j.rec.last_ap_inlier_masks, reg_t.rec.last_ap_inlier_masks
    assert mt.keys() == mj.keys()
    for ref in mj:
        np.testing.assert_array_equal(mt[ref], mj[ref])
    assert sum(int(m.sum()) for m in mt.values()) >= 8
    assert_same_map(reg_j.rec, reg_t.rec)
