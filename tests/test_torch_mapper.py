"""The mapper's control loop: the port's MpsfmMapper against the JAX
package's on the scene of __graft_entry__.dryrun_pipeline
(PlaneScene(n_images=5, n_points=200), seed 3, priors on every image),
both on the CPU.

The JAX package maps its own scene (verification with 128 hypotheses,
int_covs on, dist_ba off, 128 hypotheses a registration, 8 LM
iterations; the fused refinement and, with MPSFM_FUSED_REFINE=0, the
unfused one); the port maps the same state carried across with
`convert.reconstruction`, `convert.image_priors` and
`convert.correspondences`, its registration RANSACs given JAX's draws
(tests/test_torch_registration.jax_draws). Parity is by decisions, as
ROADMAP.md's rules of the port ask: the same registered images in the same
order, point counts within 5%, ATE below 0.05 in both (the bound of
tests/test_mapper_e2e.py), and the uncertainty chain run in both (int_covs
applied on some image, point covariances parked). The port maps the same
state a second time with every BA on the sparse path (DENSE_MAX at 0:
solve_ba over the block-sparse Schur tables), held to the JAX package's
dense run by the same decisions with points within 2%.

Also: chip_smoke.py's numpy copy of PlaneScene builds the same scene as
tests/synthetic.py; its mapping helpers map the small scene on the CPU;
the three cases of tests/test_mapper_e2e.py on the port, from the JAX
package's verification and with JAX's draws (slow: each verifies and maps a
5- or 6-image scene, ~40 s on two cores, most of it the JAX package's
verification); and, on a card, the small scene on the card against the CPU
with chip_smoke.py's bounds.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu.mapper import MpsfmMapper as JMapper
from mpsfm_tpu.scene.correspondences import Correspondences as JCorr
from mpsfm_tpu_torch.ba import problem as tproblem
from mpsfm_tpu_torch.config import Config
from mpsfm_tpu_torch.mapper import MpsfmMapper as TMapper
from mpsfm_tpu_torch.mapper import optimizer as topt
from mpsfm_tpu_torch.mapper import registration as treg
from mpsfm_tpu_torch.scene.correspondences import Correspondences as TCorr

from synthetic import PlaneScene, ate_rmse
from test_torch_registration import jax_draws, port_state

ATE, POINTS_REL = 0.05, 0.05
SPARSE_POINTS_REL = 0.02  # the sparse mapping's points against the JAX package's
CONF = {"verbose": 0, "int_covs": True, "ba": {"max_iters": 8, "dist_ba": "off"}, "registration": {"num_hyp": 128}}


def chain_ran(rec):
    return (any(getattr(getattr(im, "priors", None), "int_covs_applied", False) for im in rec.images.values())
            and len(rec.point_covs) > 0)


def summary(rec, mapper, gt):
    return dict(registered=rec.num_reg_images(), order=list(mapper.nextview.registration_order),
                points=rec.num_points3D(), ate=ate_rmse(rec, gt["poses"]), chain=chain_ran(rec))


@pytest.fixture(scope="module", params=["1", "0"], ids=["fused", "unfused"])
def mapped(request):
    """Both packages' runs on the dryrun scene, with the fused refinement
    (the default) and without (MPSFM_FUSED_REFINE=0: Optimizer.ba over
    integrate_bundle_batched), and the port's run from the same state with
    DENSE_MAX at 0, so that every BA takes the sparse path (solve_ba on
    the block-sparse Schur tables; ba_fused's fallback): (JAX summary,
    port summary, sparse port summary)."""
    scene = PlaneScene(rng=np.random.default_rng(3), n_images=5, n_points=200)
    rj, keypoints, matches, gt = scene.build()
    cj = JCorr({"num_hyp": 128}, rj)
    cj.populate(keypoints, matches)
    rt, ct = port_state(rj, cj)
    rs, cs = port_state(rj, cj)
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPSFM_FUSED_REFINE", request.param)
        mp.setattr(treg, "_draw", jax_draws)
        # the port on one intra-op thread (test_torch_image_priors.one_torch_thread)
        torch.set_num_threads(1)
        try:
            mt = TMapper(CONF, rt, ct, device="cpu")
            rt, ok_t = mt()
            with pytest.MonkeyPatch.context() as sparse:
                sparse.setattr(tproblem, "DENSE_MAX", 0)
                sparse.setattr(topt, "solve_ba_dense", lambda *a, **k: pytest.fail("a dense BA in the sparse mapping"))
                ms = TMapper(CONF, rs, cs, device="cpu")
                rs, ok_s = ms()
        finally:
            torch.set_num_threads(threads)
        mj = JMapper(CONF, rj, cj)
        rj, ok_j = mj()
    assert ok_t and ok_j and ok_s
    return summary(rj, mj, gt), summary(rt, mt, gt), summary(rs, ms, gt)


def test_mapper_matches_jax(mapped):
    sj, st, _ = mapped
    assert st["registered"] == sj["registered"] == 5
    assert st["order"] == sj["order"]
    assert abs(st["points"] - sj["points"]) <= POINTS_REL * sj["points"], (st["points"], sj["points"])
    assert st["ate"] < ATE and sj["ate"] < ATE, (st["ate"], sj["ate"])
    assert st["chain"] and sj["chain"]


def test_sparse_mapping_matches_jax(mapped):
    """The mapping with every BA above the (patched) dense layout against
    the JAX package's dense one: the same registered images in the same
    order, points within 2%, ATE below the bound, the chain run."""
    sj, _, ss = mapped
    assert ss["registered"] == sj["registered"] == 5
    assert ss["order"] == sj["order"]
    assert abs(ss["points"] - sj["points"]) <= SPARSE_POINTS_REL * sj["points"], (ss["points"], sj["points"])
    assert ss["ate"] < ATE and sj["ate"] < ATE, (ss["ate"], sj["ate"])
    assert ss["chain"]


def test_mapper_refuses_priors_on_another_device():
    scene = chip_smoke.MappingScene(rng=np.random.default_rng(3), n_images=2, n_points=60)
    rec, _, _, _ = scene.build("cpu")
    corr = TCorr({}, rec, device="cpu")
    rec.images[1].priors.device = torch.device("meta")
    with pytest.raises(ValueError, match="ImagePriors of image 1"):
        TMapper({}, rec, corr, device="cpu")


@pytest.mark.parametrize("wedge", [False, True], ids=["plane", "wedge"])
def test_chip_smoke_scene_is_plane_scene(wedge):
    """chip_smoke.MappingScene (no JAX) builds what tests/synthetic.PlaneScene
    builds from the same seed: keypoints, matches, truth and the priors'
    grids, on an integration grid other than the image too."""
    kw = dict(n_images=4, n_points=150, wedge=wedge)
    rj, kj, mj, gj = PlaneScene(rng=np.random.default_rng(5), **kw).build()
    rt, kt, mt, gt = chip_smoke.MappingScene(rng=np.random.default_rng(5), **kw).build("cpu")
    assert kt.keys() == kj.keys() and mt.keys() == mj.keys()
    for name in kj:
        np.testing.assert_array_equal(kt[name], kj[name])
    for pair in mj:
        np.testing.assert_array_equal(mt[pair], mj[pair])
    np.testing.assert_array_equal(gt["points"], gj["points"])
    for a, b in zip(gt["poses"], gj["poses"]):
        np.testing.assert_array_equal(a.q, b.q)
        np.testing.assert_array_equal(a.t, b.t)
    for imid, im in rj.images.items():
        dj, dt = im.priors.depth, rt.images[imid].priors.depth
        for k in ("data_prior", "uncertainty", "valid"):
            np.testing.assert_array_equal(getattr(dt, k), getattr(dj, k))
        nj, nt = im.priors.normals, rt.images[imid].priors.normals
        for k in vars(nj):
            if isinstance(getattr(nj, k), np.ndarray):
                np.testing.assert_array_equal(getattr(nt, k), getattr(nj, k), err_msg=k)
    rt2, _, _, _ = chip_smoke.MappingScene(rng=np.random.default_rng(5), **kw).build("cpu", int_wh=(80, 60))
    assert rt2.cameras[1].int_width == 80 and rt2.images[0].priors.depth.data_prior.shape == (60, 80)


def test_chip_smoke_mapping_on_the_cpu():
    """chip_smoke.py's mapping helpers on the small scene, on the CPU (the
    port's own draws): every image registered within the bounds, one
    registration wall per next image."""
    cfg = dict(chip_smoke.MAPPING_SMALL)
    num_hyp = cfg.pop("num_hyp")
    rec, corr, truth, _, _ = chip_smoke.mapping_state("cpu", num_hyp=num_hyp, **cfg)
    rec, ok, mapper, wall, walls = chip_smoke.run_mapping(rec, corr, "cpu", num_hyp,
                                                          {"ba": {"max_iters": 8, "dist_ba": "off"}})
    out = chip_smoke.mapping_summary(rec, ok, mapper, truth, 0)
    assert out["registered"] == 5 and len(walls) >= 3 and all(s > 0 for _, s, _ in walls)
    assert abs(out["ate"] - ate_rmse(rec, truth["poses"])) < 1e-12
    with pytest.raises(AssertionError, match="mapping"):
        chip_smoke.mapping_summary(rec, ok, mapper, truth, 10 * rec.num_points3D())


@pytest.mark.parametrize("fault", [None, "reordered", "block", "noise"])
def test_chip_smoke_k1_many_check_on_an_ill_conditioned_system(monkeypatch, fault):
    """chip_smoke.k1_many_check with the float64 reference, on a system
    scaled as the mapping phase's point covariances' (diagonal 1 .. 1e9),
    with the plain solve in the kernel's place: it passes as it is and as
    another float32 order of the same solve (the plain solve on a copy of S
    at float32's rounding, about 0.5 from the plain version at max |X| 2e6,
    far past K1_TOL), and fails with one block of rows 5% off (a missed
    tile) or with a 1e-4 relative noise (a kernel less accurate than its
    plain version)."""
    from mpsfm_tpu_torch.ba import cholesky

    rng = np.random.default_rng(0)
    K, N = 96, 300
    A = rng.normal(size=(K, K))
    D = np.logspace(0, 4.5, K)
    S = torch.tensor(D[:, None] * (A @ A.T / K + np.eye(K)) * D[None], dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(K, N)) * 1e6, dtype=torch.float32)

    def solve(S_, B_):
        monkeypatch.setattr(cholesky.KERNEL_MANY, "launches", cholesky.KERNEL_MANY.launches + 1)
        if fault == "reordered":
            S_ = chip_smoke.rounding_ensemble(S_, 2, seed=1)[1]
        X = cholesky.cholesky_solve_plain(S_, B_).clone()
        if fault == "block":
            X[40:72] *= 1.05
        elif fault == "noise":
            X *= 1 + 1e-4 * torch.as_tensor(rng.normal(size=X.shape), dtype=X.dtype)
        return X

    monkeypatch.setattr(cholesky, "cholesky_solve", solve)
    if fault is None:
        err, line = chip_smoke.k1_many_check(S, B, chip_smoke.K1_ILL_REL, "sound", f64=True)
        assert err == 0.0 and "against the float64 solve" in line
    elif fault == "reordered":
        err, line = chip_smoke.k1_many_check(S, B, chip_smoke.K1_ILL_REL, fault, f64=True)
        assert err > 1e3 * chip_smoke.K1_TOL and "against the float64 solve" in line
    else:
        with pytest.raises(AssertionError, match="K1 many disagrees"):
            chip_smoke.k1_many_check(S, B, chip_smoke.K1_ILL_REL, fault, f64=True)


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_small_mapping_card_vs_cpu():
    chip_smoke.mapping_card_vs_cpu("cuda")


# ---- tests/test_mapper_e2e.py on the port ----

def port_pipeline(rng, mapper_conf=None, with_priors=True, **scene_kw):
    """tests/test_mapper_e2e.run_pipeline on the port: the JAX scene and its
    verification (256 hypotheses) carried across, mapped by the port on the
    CPU with JAX's registration draws. With the port's own draws the
    no-prior scene flips a decision: its first init pair (1, 4), ill-posed
    for the essential matrix on the jittered plane, passes the 16° init gate
    on a wrong pose from one torch draw and the map ends at ATE 0.47, where
    JAX's draws reject that pair and init on (0, 4) (ROADMAP.md queue 3)."""
    scene = PlaneScene(rng=rng, **scene_kw)
    rj, keypoints, matches, gt = scene.build(with_priors=with_priors)
    cj = JCorr({"num_hyp": 256}, rj)
    cj.populate(keypoints, matches)
    rt, ct = port_state(rj, cj)
    conf = {"verbose": 0, "int_covs": False, "ba": {"max_iters": 12}, "registration": {"num_hyp": 256}}
    conf = Config.create(conf).merged(mapper_conf or {}).to_dict()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(treg, "_draw", jax_draws)
        mapper = TMapper(conf, rt, ct, device="cpu")
        rec, ok = mapper()
    return rec, ok, gt, mapper


@pytest.mark.slow
def test_port_mapper_registers_all_images(rng):
    rec, ok, gt, _ = port_pipeline(rng, n_images=6, n_points=300)
    assert ok and rec.num_reg_images() == 6, f"registered {rec.num_reg_images()}/6"
    assert rec.num_points3D() > 100
    assert ate_rmse(rec, gt["poses"]) < 0.05


@pytest.mark.slow
def test_port_mapper_without_priors(rng):
    rec, ok, gt, _ = port_pipeline(
        rng, with_priors=False, n_images=5, n_points=300, point_jitter=0.4,
        mapper_conf={"integrate": False, "depth_consistency": False,
                     "ba": {"use_depth": False}, "registration": {"init_min_num_points": 20}})
    assert ok and rec.num_reg_images() >= 4
    assert ate_rmse(rec, gt["poses"]) < 0.05


@pytest.mark.slow
def test_port_mapper_exploration_flags(rng):
    rec, ok, gt, _ = port_pipeline(
        rng, n_images=6, n_points=300,
        mapper_conf={"pre_fail": True, "depth_consistency_checker": {"depth_consistency_resample": True},
                     "registration": {"resample_bundle": True}})
    assert ok and rec.num_reg_images() == 6, f"registered {rec.num_reg_images()}/6"
    assert ate_rmse(rec, gt["poses"]) < 0.05
