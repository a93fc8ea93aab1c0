"""Geometric verification through Correspondences.populate: the port against
the JAX package on tests/synthetic.PlaneScene(n_images=5, n_points=200).

The JAX package draws its RANSAC samples with jax.random inside
estimate_two_view_geometry_batch; the port draws from a torch.Generator.
For parity the port's estimator, as the port's scene.correspondences
module calls it, is wrapped to take JAX's draws (derived from the keys the
JAX entry point uses, tests/test_torch_estimators._two_view_indices), with
the default 512 hypotheses (the JAX batched call always takes 512). The
JAX package verifies once per module; its result with match scores is read
back from the TVG cache that run wrote. Compared: the image pairs, each
pair's config and inlier matches (equal) and, where the pair is
CALIBRATED, its pose (within 1e-4; on the scene's near-planar pairs,
PLANAR_OR_PANORAMIC, the essential's pose is ill-posed and the two
libraries' QRs pick different ones, ROADMAP.md queue 3), the
correspondence graph's pairs and adjacency, num_correspondences_for_image,
inlier_match_scores (equal) and the reconstruction's state; and TVG caches
written by one package and read by the other.
"""

import shutil

import numpy as np
import pytest
import torch

import mpsfm_tpu.scene.correspondences as jcorr
import mpsfm_tpu_torch.scene.correspondences as tcorr
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.estimators import two_view as ttv

from synthetic import PlaneScene
from test_torch_estimators import _close_pose, _two_view_indices
from test_torch_scene import assert_same_graph, assert_same_state


def _scene():
    rec, kps, matches, _ = PlaneScene(rng=np.random.default_rng(0), n_images=5, n_points=200,
                                      point_jitter=0.3).build(with_priors=False)
    return rec, kps, matches


def _with_jax_draws(pairs, **kw):
    return ttv.estimate_two_view_geometry_batch(pairs, indices=_two_view_indices(pairs), **kw)


def _no_estimation(pairs, **kw):
    assert not pairs, "a cached pair was verified again"
    return []


def _port_populate(kps, matches, scores=None, cache_path=None, estimator=_with_jax_draws, device="cpu"):
    rj, _, _ = _scene()
    corr = tcorr.Correspondences({}, convert.reconstruction(rj), device=device)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcorr, "estimate_two_view_geometry_batch", estimator)
        corr.populate(kps, matches, scores, cache_path=cache_path)
    return corr


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's populate without and with scores (the second read
    back from the first's TVG cache), and the inputs."""
    cache = tmp_path_factory.mktemp("tvg") / "jax.h5"
    rec, kps, matches = _scene()
    rng = np.random.default_rng(1)
    scores = {frozenset(k): rng.uniform(0.1, 1.0, len(m)) for k, m in matches.items()}
    plain = jcorr.Correspondences({}, rec)
    plain.populate(kps, matches, cache_path=cache)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorr, "estimate_two_view_geometry_batch", _no_estimation)
        scored = jcorr.Correspondences({}, _scene()[0])
        scored.populate(kps, matches, scores, cache_path=cache)
    return dict(plain=plain, scored=scored, kps=kps, matches=matches, scores=scores, cache=cache)


def assert_same_verification(cj, ct):
    assert ct.image_pairs() == cj.image_pairs()
    for i, j in cj.image_pairs():
        gj, gt = cj.two_view_geom_by_ids(i, j), ct.two_view_geom_by_ids(i, j)
        assert gt.config == gj.config and gt.num_inliers == gj.num_inliers
        np.testing.assert_array_equal(gt.inlier_matches, gj.inlier_matches)
        if gj.config == ttv.TwoViewConfig.CALIBRATED:  # elsewhere E is ill-posed (ROADMAP.md queue 3)
            _close_pose(gt.pose, gj.pose)
            np.testing.assert_allclose(gt.tri_angle, gj.tri_angle, rtol=1e-4)
        np.testing.assert_array_equal(ct.matches(j, i), cj.matches(j, i))
    assert_same_graph(cj.cg, ct.cg)
    for imid in cj.rec.images:
        assert ct.cg.num_correspondences_for_image(imid) == cj.cg.num_correspondences_for_image(imid)
    assert ct.inlier_match_scores == cj.inlier_match_scores
    assert_same_state(cj.rec, ct.rec)


def test_populate_matches_jax(jax_run):
    cj = jax_run["plain"]
    ct = _port_populate(jax_run["kps"], jax_run["matches"])
    configs = [cj.two_view_geom_by_ids(*p).config for p in cj.image_pairs()]
    assert len(configs) == 10 and ttv.TwoViewConfig.CALIBRATED in configs and ct.device.type == "cpu"
    assert_same_verification(cj, ct)
    assert all(ct.inlier_match_scores[frozenset(p)] == len(ct.matches(*p)) for p in ct.image_pairs())


def test_populate_with_scores_matches_jax(jax_run):
    cj = jax_run["scored"]
    ct = _port_populate(jax_run["kps"], jax_run["matches"], jax_run["scores"])
    assert_same_verification(cj, ct)
    assert all(0 < ct.inlier_match_scores[frozenset(p)] < len(ct.matches(*p)) for p in ct.image_pairs())


def test_tvg_cache_crosses_packages(jax_run, tmp_path):
    """The port reads the JAX package's cache without verifying a pair, and
    the JAX package reads the port's; both digests are the same function."""
    kps, matches = jax_run["kps"], jax_run["matches"]
    shutil.copy(jax_run["cache"], tmp_path / "jax.h5")
    ct = _port_populate(kps, matches, cache_path=tmp_path / "jax.h5", estimator=_no_estimation)
    assert_same_verification(jax_run["plain"], ct)

    written = _port_populate(kps, matches, cache_path=tmp_path / "port.h5")
    cj = jcorr.Correspondences({}, _scene()[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcorr, "estimate_two_view_geometry_batch", _no_estimation)
        cj.populate(kps, matches, cache_path=tmp_path / "port.h5")
    assert_same_verification(cj, written)
    (n0, n1), m = next(iter(matches.items()))
    args = (m, kps[n0], kps[n1], 4.0, 512)
    assert tcorr._TvgCache._digest(*args) == jcorr._TvgCache._digest(*args)
    assert tcorr._TvgCache._key("a/b.jpg", "c.jpg") == jcorr._TvgCache._key("a/b.jpg", "c.jpg")


def test_correspondences_refuse_the_cpu_without_a_card(monkeypatch):
    rec = convert.reconstruction(_scene()[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcorr.Correspondences({}, rec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rec.camera(0).device()
    cam = rec.camera(0).device("cpu")
    assert cam.fx.dtype == torch.float32 and cam.fx.device.type == "cpu" and (cam.width, cam.height) == (160, 120)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_populate_on_card_matches_cpu(cuda):
    """populate on the card against the CPU with the same draws: the same
    pairs and configs, inlier counts within 1%."""
    _, kps, matches = _scene()
    cg, cc = (_port_populate(kps, matches, device=d) for d in (cuda, "cpu"))
    assert cg.image_pairs() == cc.image_pairs()
    for p in cc.image_pairs():
        g, c = cg.two_view_geom_by_ids(*p), cc.two_view_geom_by_ids(*p)
        assert g.config == c.config
        assert abs(g.num_inliers - c.num_inliers) <= 0.01 * c.num_inliers
