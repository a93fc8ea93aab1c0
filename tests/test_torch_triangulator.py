"""Incremental triangulation: the port's Triangulator against the JAX
package's on the cases of tests/test_mapper_units.py (track creation and
completion, :13; low-parallax lifting from depth, :41), and on completion,
merging and retriangulation of two-view tracks, each run on a JAX
Reconstruction and on its copy by `convert.reconstruction` with the same
correspondence graph.

Both are the same numpy code over the same state: the tracks, every
image's point3D_ids and the point pool equal, xyz within 1e-9.
"""

import numpy as np
import pytest

from mpsfm_tpu.mapper.triangulator import Triangulator as JTriangulator
from mpsfm_tpu.scene.corrgraph import CorrespondenceGraph as JGraph
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.mapper.triangulator import Triangulator as TTriangulator
from mpsfm_tpu_torch.scene.corrgraph import CorrespondenceGraph as TGraph

from test_ba import make_synthetic_rec

XYZ_TOL = 1e-9


def assert_same_points(rj, rt):
    assert rt._num_points == rj._num_points
    np.testing.assert_array_equal(rt.alive, rj.alive)
    np.testing.assert_array_equal(rt.track_len, rj.track_len)
    np.testing.assert_array_equal(rt.point_ids(), rj.point_ids())
    np.testing.assert_allclose(rt.xyz[rt.point_ids()], rj.xyz[rj.point_ids()], rtol=0, atol=XYZ_TOL)
    for pid in rj.point_ids():
        assert rt.tracks[pid] == rj.tracks[pid], pid
    for imid, im in rj.images.items():
        np.testing.assert_array_equal(rt.images[imid].point3D_ids, im.point3D_ids)


def graphs(pairs, n_kps):
    """The same correspondence graph in both packages: pairs {(i, j): matches}."""
    out = []
    for G in (JGraph, TGraph):
        cg = G()
        for imid, n in n_kps.items():
            cg.add_image(imid, n)
        for (i, j), m in pairs.items():
            cg.add_correspondences(i, j, m)
        cg.finalize()
        out.append(cg)
    return out


def identity_pairs(n_cams, n):
    return {(i, j): np.stack([np.arange(n)] * 2, -1) for i in range(n_cams) for j in range(i + 1, n_cams)}


def wipe_points(*recs):
    """Delete every point, in the same order in each reconstruction (their
    pools then hand out the same free ids)."""
    for rec in recs:
        for pid in list(rec.point_ids()):
            rec.delete_point3D(int(pid))


def test_creates_and_completes_as_jax(rng):
    rj, gt = make_synthetic_rec(rng, n_cams=4, n_pts=60, noise_px=0.3, pose_noise=0.0)
    rt = convert.reconstruction(rj)
    wipe_points(rj, rt)
    gj, gt_ = graphs(identity_pairs(4, 60), {i: 60 for i in range(4)})
    tj, tt = JTriangulator({"min_angle": 0.5}, rj, gj), TTriangulator({"min_angle": 0.5}, rt, gt_)
    assert tt.triangulate_image(0) == tj.triangulate_image(0)
    assert_same_points(rj, rt)
    assert rt.num_points3D() > 40 and rt.track_len[rt.point_ids()].mean() > 3.0
    kp_of = np.array([rt.tracks[p][0][1] for p in rt.point_ids()])
    assert np.median(np.linalg.norm(rt.xyz[rt.point_ids()] - gt["pts"][kp_of], axis=1)) < 0.05
    assert tt.complete_and_merge_all_tracks() == tj.complete_and_merge_all_tracks() == 0


class _TrueDepth:
    """A depth prior that returns each keypoint's true depth (the mock of
    tests/test_mapper_units.py::test_triangulator_lift_low_parallax)."""

    activated = True

    def __init__(self, rec, imid, pts):
        self.rec, self.imid, self.pts = rec, imid, pts

    def valid_at_kps(self, xy):
        return np.ones(len(xy), bool)

    def data_at_kps(self, xy):
        im = self.rec.images[self.imid]
        idx = [int(np.argmin(np.linalg.norm(im.keypoints - p, axis=1))) for p in xy]
        return im.pose.transform(self.pts[idx])[:, 2]


def test_lifts_low_parallax_as_jax(rng):
    rj, gt = make_synthetic_rec(rng, n_cams=2, n_pts=40, noise_px=0.0, pose_noise=0.0)
    rj.images[1].pose = rj.images[0].pose.copy()
    rj.images[1].pose.t = rj.images[1].pose.t + np.array([0.02, 0, 0])
    p_cam = rj.images[1].pose.transform(gt["pts"])
    rj.images[1].keypoints = rj.cameras[1].img_from_cam(p_cam[:, :2] / p_cam[:, 2:3])
    rt = convert.reconstruction(rj)
    wipe_points(rj, rt)
    gj, gt_ = graphs({(0, 1): np.stack([np.arange(40)] * 2, -1)}, {0: 40, 1: 40})
    for rec in (rj, rt):
        for i in (0, 1):
            rec.images[i].depth = _TrueDepth(rec, i, gt["pts"])
    tj, tt = JTriangulator({}, rj, gj), TTriangulator({}, rt, gt_)
    risky_j = rj.find_points3D_with_small_triangulation_angle
    lifted = []
    rj.find_points3D_with_small_triangulation_angle = lambda a, p: lifted.append(len(p)) or risky_j(a, p)
    tj.triangulate_image(0)
    tt.triangulate_image(0)
    assert lifted and lifted[0] > 20  # every fresh point went through the lifting test
    assert_same_points(rj, rt)
    assert rt.num_points3D() > 20
    kp_of = np.array([rt.tracks[p][0][1] for p in rt.point_ids()])
    assert np.median(np.linalg.norm(rt.xyz[rt.point_ids()] - gt["pts"][kp_of], axis=1)) < 0.05


@pytest.mark.parametrize("op", ["complete_and_merge", "retriangulate"])
def test_completes_merges_and_retriangulates_as_jax(rng, op):
    """Two-view tracks of 4 cameras: points of images (0, 1) for every
    keypoint, and for every third keypoint a second point of images (2, 3),
    so that completion extends the first and merging joins the pairs;
    retriangulation (no image below nsafe long tracks) runs creation over
    every image, and deletes its low-parallax points (no depth to lift
    them from)."""
    rj, gt = make_synthetic_rec(rng, n_cams=4, n_pts=60, noise_px=0.3, pose_noise=0.0)
    rt = convert.reconstruction(rj)
    wipe_points(rj, rt)
    jitter = rng.normal(scale=1e-3, size=(2, 60, 3))
    for rec in (rj, rt):
        for k in range(60):
            rec.add_point3D(gt["pts"][k] + jitter[0, k], [(0, k), (1, k)])
            if k % 3 == 0:
                rec.add_point3D(gt["pts"][k] + jitter[1, k], [(2, k), (3, k)])
        for k in range(0, 60, 7):  # a few keypoints left free in image 0
            rec.delete_point3D(int(rec.images[0].point3D_ids[k]))
    gj, gt_ = graphs(identity_pairs(4, 60), {i: 60 for i in range(4)})
    conf = {"min_angle": 0.5, "nsafe_threshold": 0, "lift_low_parallax": False}
    tj, tt = JTriangulator(conf, rj, gj), TTriangulator(conf, rt, gt_)
    if op == "complete_and_merge":
        nj, nt = tj.complete_and_merge_all_tracks(), tt.complete_and_merge_all_tracks()
        assert nt == nj > 0
        assert tt.complete_and_merge_tracks(rt.point_ids().tolist()) == tj.complete_and_merge_tracks(
            rj.point_ids().tolist())
    else:
        for rec in (rj, rt):
            for imid in (0, 1, 2, 3):
                rec.images[imid].depth = None
        nj, nt = tj.retriangulate(), tt.retriangulate()
        assert nt == nj > 0
    assert_same_points(rj, rt)
