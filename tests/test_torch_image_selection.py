"""Next-view and init-pair selection: the port's ImageSelection against the
JAX package's on the scene of tests/test_image_selection.py (a populated
PlaneScene of 5 images × 200 points, images 0 and 1 registered with
points between them), carried across with `convert.reconstruction` and
`convert.correspondences`.

Both are the same numpy code over the same state, so every ranking gives
the same order and scores within 1e-12, and find_init_pairs and
next_image the same answers, also after at_success and at_failure calls.
"""

import numpy as np
import pytest

from mpsfm_tpu.mapper.image_selection import ImageSelection as JSelection
from mpsfm_tpu.scene.correspondences import Correspondences as JCorr
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.mapper.image_selection import ImageSelection as TSelection

from synthetic import PlaneScene

METHODS = [
    "MAX_MATCHER_INLIER_SCORES",
    "MAX_NUM_INLIER_SCORES_TOT",
    "MAX_VISIBLE_POINTS_NUM",
    "MAX_VISIBLE_POINTS_RATIO",
    "MIN_UNCERTAINTY",
    "MAX_NUM_CORRESPONDENCES",
    "MAX_NUM_INLIER_CORRESPONDENCES",
    "MAX_NUM_INLIER_CORRESPONDENCES_TOT",
]


@pytest.fixture(scope="module")
def scenes():
    """(JAX rec, JAX corr, port rec, port corr) of the scene of
    tests/test_image_selection.py; an ignore mask on one pair, so the
    discount of _per_ref_scores is exercised."""
    scene = PlaneScene(rng=np.random.default_rng(0), n_images=5, n_points=200, point_jitter=0.3)
    rec, keypoints, matches, gt = scene.build(with_priors=False)
    corr = JCorr({"num_hyp": 256}, rec)
    corr.populate(keypoints, matches)
    for i in (0, 1):
        rec.images[i].pose = gt["poses"][i]
        rec.images[i].registered = True
    m = corr.matches(0, 1)
    for k in range(0, len(m), 2):
        kp0, kp1 = int(m[k, 0]), int(m[k, 1])
        if rec.images[0].point3D_ids[kp0] >= 0:
            continue
        rec.add_point3D(gt["points"][k % 200] * 0 + [0, 0, 5.0], [(0, kp0), (1, kp1)])
    n = len(corr.matches(0, 3))
    rec.images[3].ignore_matches_AP = {0: np.arange(n) % 3 == 0}
    rt = convert.reconstruction(rec)
    rt.images[3].ignore_matches_AP = {0: rec.images[3].ignore_matches_AP[0].copy()}
    return rec, corr, rt, convert.correspondences(corr, rt, device="cpu")


def test_converter_carries_correspondences(scenes):
    rj, cj, rt, ct = scenes
    assert ct.image_pairs() == cj.image_pairs() and ct.inlier_match_scores == cj.inlier_match_scores
    for i, j in cj.image_pairs():
        np.testing.assert_array_equal(ct.matches(i, j), cj.matches(i, j))
        gj, gt = cj.two_view_geom_by_ids(j, i), ct.two_view_geom_by_ids(j, i)
        assert (gt.config, gt.num_inliers, gt.tri_angle) == (gj.config, gj.num_inliers, gj.tri_angle)
        np.testing.assert_array_equal(gt.inlier_matches, gj.inlier_matches)
        np.testing.assert_allclose(np.asarray(gt.pose.quat), np.asarray(gj.pose.quat), atol=1e-6)
        np.testing.assert_allclose(np.asarray(gt.pose.t), np.asarray(gj.pose.t), atol=1e-6)
    for imid in rj.images:
        for a, b in zip(ct.cg.correspondences_all(imid), cj.cg.correspondences_all(imid)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", METHODS)
def test_ranking_matches_jax(scenes, method):
    rj, cj, rt, ct = scenes
    sj = JSelection({"image_selection_method": method}, rj, cj)
    st = TSelection({"image_selection_method": method}, rt, ct)
    for imid in (2, 3, 4):
        oj, ot = sj.rank_image(imid), st.rank_image(imid)
        assert ot["refid"] == oj["refid"]
        np.testing.assert_allclose(ot["score"], oj["score"], rtol=1e-12, atol=0)
        assert ot["score"] > 0 and ot["refid"] in (0, 1)
    assert st.next_image() and sj.next_image()
    assert (st.candid, rt.best_next_ref_imid) == (sj.candid, rj.best_next_ref_imid)


def test_find_init_pairs_and_next_image_ladder_match_jax(scenes):
    rj, cj, rt, ct = scenes
    sj, st = JSelection({}, rj, cj), TSelection({}, rt, ct)
    assert st.find_init_pairs() == sj.find_init_pairs()
    assert st.find_init_pairs({(0, 1), (2, 1)}) == sj.find_init_pairs({(0, 1), (2, 1)})
    floor = {"init_min_num_inliers": 10**6}  # no pair passes: the unfiltered order
    assert TSelection(floor, rt, ct).find_init_pairs() == JSelection(floor, rj, cj).find_init_pairs()
    trail = []
    for sel in (sj, st):
        out = []
        for step in ("fail", "fail", "success", "fail", "fail", "fail"):
            ok = sel.next_image()
            out.append((ok, sel.candid, sel.rec.best_next_ref_imid))
            if not ok:
                break
            if step == "fail":
                sel.at_failure(sel.candid)
            else:
                sel.at_success()
            out.append((sorted(sel.freeze_imids), list(sel.registration_order)))
        out.append(sel.next_image())  # every candidate frozen
        out.append((sel.next_image([4, 2]), sel.candid))
        trail.append(out)
    assert trail[1] == trail[0]
    assert trail[0][-2] is False and trail[0][-1][0] is True


def test_unknown_method_raises(scenes):
    _, _, rt, ct = scenes
    with pytest.raises(ValueError):
        TSelection({"image_selection_method": "BOGUS"}, rt, ct).rank_image(2)
