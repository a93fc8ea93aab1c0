"""The scene's host state: the port against the JAX package.

The cases of tests/test_scene.py run on both packages with the same
inputs, and each leaves the same state: integer and bool arrays equal,
float64 arrays within 1e-12 (the host math is the same numpy code, so in
practice bit-equal). Also the scene-state converter on synthetic plane
scenes, the config loader on every YAML under configs/, the map sampling
of utils/interp.py, the HDF5 caches of utils/io.py written by one package
and read by the other, and the timers and trace of utils/profiling.py.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mpsfm_tpu.config as jconfig
import mpsfm_tpu.scene.corrgraph as jcg
import mpsfm_tpu.scene.reconstruction as jrec
import mpsfm_tpu.utils.interp as jinterp
import mpsfm_tpu.utils.profiling as jprof
import mpsfm_tpu_torch.config as tconfig
import mpsfm_tpu_torch.scene.corrgraph as tcg
import mpsfm_tpu_torch.scene.reconstruction as trec
import mpsfm_tpu_torch.utils.interp as tinterp
import mpsfm_tpu_torch.utils.io as tio
import mpsfm_tpu_torch.utils.profiling as tprof
from mpsfm_tpu_torch import convert, native

from synthetic import PlaneScene

ROOT = Path(__file__).resolve().parents[1]
FTOL = 1e-12

JAX = SimpleNamespace(Reconstruction=jrec.Reconstruction, HostCamera=jrec.HostCamera, ImageRecord=jrec.ImageRecord,
                      Pose=jrec.Pose, CorrespondenceGraph=jcg.CorrespondenceGraph)
PORT = SimpleNamespace(Reconstruction=trec.Reconstruction, HostCamera=trec.HostCamera, ImageRecord=trec.ImageRecord,
                       Pose=trec.Pose, CorrespondenceGraph=tcg.CorrespondenceGraph)


def assert_close(a, b, what=""):
    """Integer and bool arrays equal, floats within FTOL."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    if np.issubdtype(a.dtype, np.floating) or np.issubdtype(b.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=0, atol=FTOL, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_state(ra, rb):
    """Two reconstructions (of either package) hold the same scene: cameras,
    images (keypoints, point3D_ids, poses, registration), the point pool
    (xyz, alive, track_len, high-water mark), every alive point's track in
    its store's order, and the flat observation table."""
    assert ra.cameras.keys() == rb.cameras.keys()
    for cid, ca in ra.cameras.items():
        cb = rb.cameras[cid]
        assert_close(ca.params, cb.params, f"camera {cid}")
        assert (ca.width, ca.height, ca.int_width, ca.int_height) == (cb.width, cb.height, cb.int_width, cb.int_height)
    assert list(ra.images) == list(rb.images)
    for imid, ia in ra.images.items():
        ib = rb.images[imid]
        assert (ia.name, ia.camera_id, ia.registered) == (ib.name, ib.camera_id, ib.registered)
        assert_close(ia.keypoints, ib.keypoints, f"keypoints of {imid}")
        assert_close(ia.point3D_ids, ib.point3D_ids, f"point3D_ids of {imid}")
        assert (ia.pose is None) == (ib.pose is None)
        if ia.pose is not None:
            assert_close(ia.pose.q, ib.pose.q, f"pose q of {imid}")
            assert_close(ia.pose.t, ib.pose.t, f"pose t of {imid}")
    assert ra._num_points == rb._num_points
    for k in ("alive", "track_len", "xyz"):
        assert_close(getattr(ra, k), getattr(rb, k), k)
    assert_close(ra.point_ids(), rb.point_ids(), "point_ids")
    for pid in ra.point_ids():
        assert ra.tracks[pid] == rb.tracks[pid], f"track of {pid}"
    for a, b in zip(ra.observations(), rb.observations()):
        assert_close(a, b, "observations")


def assert_same_graph(ga, gb):
    assert ga.image_pairs() == gb.image_pairs()
    for i, j in ga.image_pairs():
        assert_close(ga.matches(i, j), gb.matches(i, j), f"pair {i}, {j}")
        assert_close(ga.matches(j, i), gb.matches(j, i), f"pair {j}, {i}")
    assert ga.finalized == gb.finalized
    if ga.finalized:
        for imid in ga._num_kps:
            for a, b in zip(ga.correspondences_all(imid), gb.correspondences_all(imid)):
                assert_close(a, b, f"adjacency of {imid}")
            assert ga.num_correspondences_for_image(imid) == gb.num_correspondences_for_image(imid)


# ---- the cases of tests/test_scene.py, on either package (m) ----

def build_rec(m, n_images=4, n_kps=50):
    rec = m.Reconstruction()
    rec.add_camera(m.HostCamera(1, np.array([500.0, 500.0, 320.0, 240.0]), 640, 480))
    rng = np.random.default_rng(0)
    for i in range(n_images):
        im = m.ImageRecord(i, f"im{i}.jpg", 1)
        im.keypoints = rng.uniform(0, 600, size=(n_kps, 2))
        im.point3D_ids = np.full(n_kps, -1, np.int64)
        im.pose = m.Pose(np.array([1.0, 0, 0, 0]), np.array([0.5 * i, 0.0, 0.0]))
        im.registered = True
        rec.add_image(im)
    return rec


def case_point_pool_add_delete(m):
    rec = build_rec(m)
    pid = rec.add_point3D(np.array([0.0, 0, 5.0]), [(0, 0), (1, 0), (2, 0)])
    assert rec.alive[pid] and rec.track_len[pid] == 3 and rec.images[0].point3D_ids[0] == pid
    rec.add_observation(pid, 3, 0)
    assert rec.track_len[pid] == 4
    rec.remove_observation(pid, 3, 0)
    rec.remove_observation(pid, 0, 0)
    assert rec.alive[pid]
    rec.remove_observation(pid, 1, 0)  # track drops below 2 -> delete
    assert not rec.alive[pid]
    assert (rec.images[2].point3D_ids == -1).all()
    return rec, [pid]


def case_pool_growth_and_reuse(m):
    rec = build_rec(m, n_images=2, n_kps=3000)
    pids = [rec.add_point3D(np.array([0.0, 0, 5.0]), [(0, k), (1, k)]) for k in range(2500)]
    assert rec.num_points3D() == 2500
    rec.delete_point3D(pids[0])
    pid2 = rec.add_point3D(np.array([1.0, 0, 5.0]), [(0, 0), (1, 0)])
    assert pid2 == pids[0]  # slot reuse
    return rec, pids + [pid2]


def case_add_point_skips_taken_observations(m):
    rec = build_rec(m)
    p1 = rec.add_point3D(np.array([0.0, 0, 5.0]), [(0, 0), (1, 0)])
    p2 = rec.add_point3D(np.array([0.0, 0, 6.0]), [(0, 0), (1, 1), (2, 1)])
    assert rec.images[0].point3D_ids[0] == p1 and rec.track_len[p2] == 2
    return rec, [p1, p2]


def case_projection_and_filters(m):
    rec = build_rec(m)
    xyz = np.array([0.3, 0.2, 5.0])
    track = []
    for imid in range(4):
        im = rec.images[imid]
        p_cam = im.pose.transform(xyz[None])[0]
        im.keypoints[imid] = rec.cameras[1].img_from_cam(p_cam[:2] / p_cam[2])
        track.append((imid, imid))
    pid = rec.add_point3D(xyz, track)
    (o_pid, o_im, o_kp), err = rec._point_reproj_errors([pid])
    assert len(err) == 4 and err.max() < 1e-12
    rec.images[3].keypoints[3] += 50.0
    changed = rec.filter_points3D(4.0, 0.001, [pid])
    assert changed == 1 and rec.track_len[pid] == 3
    changed2 = rec.filter_points3D(4.0, 30.0, [pid])
    assert not rec.alive[pid]
    return rec, [err, o_pid, o_im, o_kp, changed, changed2]


def case_negative_depth_filter(m):
    rec = build_rec(m)
    pid = rec.add_point3D(np.array([0.0, 0.0, -5.0]), [(0, 0), (1, 0), (2, 0)])
    n = rec.filter_observations_with_negative_depth()
    assert n >= 2 and not rec.alive[pid]
    return rec, [n]


def case_deregister_image(m):
    rec = build_rec(m)
    p1 = rec.add_point3D(np.array([0, 0, 5.0]), [(0, 0), (1, 0), (2, 0)])
    p2 = rec.add_point3D(np.array([0, 0, 6.0]), [(0, 1), (1, 1)])
    rec.deregister_image(1)
    assert not rec.images[1].registered
    assert rec.track_len[p1] == 2 and rec.alive[p1] and not rec.alive[p2]
    return rec, [p1, p2]


def case_local_bundle_ranking(m):
    rec = build_rec(m)
    for k in range(3):
        rec.add_point3D(np.array([0, 0, 5.0 + k]), [(0, k), (1, k)])
    rec.add_point3D(np.array([0, 0, 9.0]), [(0, 3), (2, 3)])
    ids = rec.find_local_bundle_ids(0)
    assert ids[0] == 1 and 2 in ids and 3 not in ids
    return rec, [ids, rec.shared_point_counts(0)]


def case_normalize(m):
    rec = build_rec(m)
    for k in range(10):
        rec.add_point3D(np.array([k * 1.0, 0, 5.0]), [(0, k), (1, k)])
    before_px, _ = rec.project_points_into_image(0, rec.point_ids())
    scale = rec.normalize(False, 5, 0.2, 0.8)
    after_px, depth = rec.project_points_into_image(0, rec.point_ids())
    np.testing.assert_allclose(before_px, after_px, atol=1e-8)
    return rec, [scale, before_px, after_px, depth]


def case_corrgraph_adjacency(m):
    cg = m.CorrespondenceGraph()
    for i in range(3):
        cg.add_image(i, 10)
    cg.add_correspondences(0, 1, np.array([[0, 5], [1, 6]]))
    cg.add_correspondences(2, 0, np.array([[3, 0]]))  # reversed order pair
    cg.finalize()
    assert cg.num_correspondences_between_images(0, 1) == cg.num_correspondences_between_images(1, 0) == 2
    assert set(map(tuple, cg.matches(1, 0).tolist())) == {(5, 0), (6, 1)}
    oim, okp = cg.correspondences(0, 0)
    assert set(zip(oim.tolist(), okp.tolist())) == {(1, 5), (2, 3)}
    assert cg.num_correspondences_for_image(0) == 3
    return cg, [oim, okp]


def case_corrgraph_dedup_on_repeat_add(m):
    cg = m.CorrespondenceGraph()
    cg.add_image(0, 5)
    cg.add_image(1, 5)
    cg.add_correspondences(0, 1, np.array([[0, 1]]))
    cg.add_correspondences(0, 1, np.array([[0, 1], [2, 3]]))
    assert cg.num_correspondences_between_images(0, 1) == 2
    return cg, []


def case_find_local_bundle_prefers_triangulation_angle(m):
    rec = m.Reconstruction()
    rec.add_camera(m.HostCamera(1, np.array([500.0, 500.0, 320.0, 240.0]), 640, 480))
    n_kps = 40
    for i, cx in enumerate([0.0, 1e-4, 2.0, 3.0]):
        im = m.ImageRecord(i, f"im{i}.jpg", 1)
        im.keypoints = np.tile(np.array([[320.0, 240.0]]), (n_kps, 1))
        im.point3D_ids = np.full(n_kps, -1, np.int64)
        im.pose = m.Pose(np.array([1.0, 0, 0, 0]), np.array([-cx, 0.0, 0.0]))
        im.registered = True
        rec.add_image(im)
    rng = np.random.default_rng(3)
    for k in range(n_kps):
        xyz = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), 8.0 + rng.uniform(0, 2)])
        rec.add_point3D(xyz, [(0, k), (1, k), (2, k), (3, k)])
    sel = rec.find_local_bundle_ids(0, num_images=2)
    assert set(sel) == {2, 3}
    sel3 = rec.find_local_bundle_ids(0, num_images=3)
    assert set(sel3) == {1, 2, 3}
    return rec, [sel, sel3, rec.triangulation_angles(rec.point_ids())]


CASES = [case_point_pool_add_delete, case_pool_growth_and_reuse, case_add_point_skips_taken_observations,
         case_projection_and_filters, case_negative_depth_filter, case_deregister_image, case_local_bundle_ranking,
         case_normalize, case_corrgraph_adjacency, case_corrgraph_dedup_on_repeat_add,
         case_find_local_bundle_prefers_triangulation_angle]


def _same_results(a, b):
    if isinstance(a, dict):
        assert a == b
    else:
        assert_close(a, b)


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_scene_case_matches_jax(case):
    """Each case of tests/test_scene.py passes on both packages and leaves
    the same state, with the same intermediate results."""
    obj_j, out_j = case(JAX)
    obj_t, out_t = case(PORT)
    assert len(out_j) == len(out_t)
    for a, b in zip(out_j, out_t):
        _same_results(a, b)
    if isinstance(obj_j, jcg.CorrespondenceGraph):
        assert_same_graph(obj_j, obj_t)
    else:
        assert isinstance(obj_t._store, native.NativeTrackStore)
        assert_same_state(obj_j, obj_t)


def _plane_scene(seed):
    return PlaneScene(rng=np.random.default_rng(seed), n_images=5, n_points=200, point_jitter=0.3)


def _triangulate_matches(rec, matches, gt, stride):
    """Every image registered at its ground-truth pose, and a point for every
    stride-th match of each pair, placed at an arbitrary scene point (so
    the filters have observations to remove)."""
    for i, pose in enumerate(gt["poses"]):
        rec.images[i].pose = pose
        rec.images[i].registered = True
    for (n0, n1), m in matches.items():
        i0, i1 = rec.imid(n0), rec.imid(n1)
        for k in range(0, len(m), stride):
            rec.add_point3D(gt["points"][k % len(gt["points"])], [(i0, int(m[k, 0])), (i1, int(m[k, 1]))])


@pytest.mark.parametrize("seed", [0, 1])
def test_converter_carries_plane_scenes(seed):
    """A JAX Reconstruction of tests/synthetic.PlaneScene, with points, dead
    slots (deleted points, auto-deleted tracks) and a deregistered image,
    crosses over with identical state; the same filters then act the same
    on both."""
    rj, _, matches, gt = _plane_scene(seed).build(with_priors=False)
    assert_same_state(rj, convert.reconstruction(rj))  # images only

    _triangulate_matches(rj, matches, gt, stride=2)
    rng = np.random.default_rng(seed)
    for pid in rng.choice(rj.point_ids(), 15, replace=False):
        rj.delete_point3D(int(pid))
    for pid in rng.choice(rj.point_ids(), 10, replace=False):
        imid, kp = rj.tracks[pid][0]
        rj.remove_observation(int(pid), imid, kp)  # two-observation tracks: the point dies
    rj.deregister_image(4)
    assert (~rj.alive[: rj._num_points]).sum() > 20
    rt = convert.reconstruction(rj)
    assert_same_state(rj, rt)
    assert isinstance(rt._store, native.NativeTrackStore)
    for r in (rj, rt):
        r.filter_all_points3D(2.0, 0.5)
    assert_same_state(rj, rt)
    assert_close(rj.triangulation_angles(rj.point_ids()), rt.triangulation_angles(rt.point_ids()))
    assert rj.find_local_bundle_ids(0, num_images=2) == rt.find_local_bundle_ids(0, num_images=2)
    assert_close(rj.normalize(), rt.normalize())
    assert_same_state(rj, rt)


# ---- config, interp, io, profiling ----

YAMLS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*.yaml"))


@pytest.mark.parametrize("path", YAMLS)
def test_load_cfg_matches_jax(path):
    cj = jconfig.load_cfg(ROOT / path)
    ct = tconfig.load_cfg(ROOT / path)
    assert ct.to_dict() == cj.to_dict()
    assert tconfig.summarize_cfg(ct) == jconfig.summarize_cfg(cj)


def test_base_class_merges_as_jax():
    class J(jconfig.BaseClass):
        default_conf = {"a": 1, "b": {"c": 2, "d": [1, {"e": 3}]}}

    class T(tconfig.BaseClass):
        default_conf = J.default_conf

    over = {"b": {"c": 5, "f": 6}, "g": None}
    assert T(over).conf.to_dict() == J(over).conf.to_dict()
    assert T(over).conf.b.c == 5 and T().conf == J().conf


def test_interp_matches_jax(rng):
    maps = [rng.normal(size=(13, 17)), rng.normal(size=(13, 17, 3))]
    xy = rng.uniform(-3, 20, size=(200, 2))
    for data in maps:
        for scale in ((1.0, 1.0), (0.5, 0.75)):
            assert_close(tinterp.sample_bilinear(data, xy, scale), jinterp.sample_bilinear(data, xy, scale))
            assert_close(tinterp.sample_nearest(data, xy, scale), jinterp.sample_nearest(data, xy, scale))
        for hw in ((7, 9), (26, 40)):
            assert_close(tinterp.resize_bilinear(data, hw), jinterp.resize_bilinear(data, hw))
            assert_close(tinterp.resize_nearest(data, hw), jinterp.resize_nearest(data, hw))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_io_round_trips_across_packages(tmp_path, rng, writer):
    """Every HDF5 cache written by one package reads the same in the other."""
    import mpsfm_tpu.utils.io as jio  # imports h5py: here, not at collection (the card's host has none)

    w, r = (jio, tio) if writer == "jax" else (tio, jio)
    kps, desc, sc = rng.uniform(0, 100, (30, 2)), rng.normal(size=(30, 8)), rng.uniform(size=30)
    w.write_features(tmp_path / "f.h5", "a/im0.jpg", kps, desc, sc, uncertainty=0.5, image_size=(640, 480))
    k, u = r.get_keypoints(tmp_path / "f.h5", "a/im0.jpg", return_uncertainty=True)
    assert_close(k, jio.get_keypoints(tmp_path / "f.h5", "a/im0.jpg"))
    assert u == 0.5 and r.get_descriptors(tmp_path / "f.h5", "a/im0.jpg").shape == (30, 8)
    assert sorted(r.list_h5_names(tmp_path / "f.h5")) == sorted(w.list_h5_names(tmp_path / "f.h5")) == ["a/im0.jpg"]

    m0 = np.where(rng.uniform(size=30) < 0.6, rng.integers(0, 25, 30), -1)
    w.write_matches(tmp_path / "m.h5", "im0.jpg", "im1.jpg", m0, rng.uniform(size=30))
    for names in (("im0.jpg", "im1.jpg"), ("im1.jpg", "im0.jpg")):
        (ma, sa), (mb, sb) = r.get_matches(tmp_path / "m.h5", *names), w.get_matches(tmp_path / "m.h5", *names)
        assert_close(ma, mb)
        assert_close(sa, sb)

    mono = {"depth": rng.uniform(1, 5, (6, 8)), "valid": rng.uniform(size=(6, 8)) > 0.3,
            "normals": rng.normal(size=(6, 8, 3))}
    w.write_mono_map(tmp_path / "d.h5", "dir/im0.jpg", mono)
    got = r.get_mono_map(tmp_path / "d.h5", "im0.jpg")
    assert got.keys() == mono.keys() and all(np.array_equal(got[k], mono[k]) for k in mono)
    assert r.get_mono_map(tmp_path / "d.h5", "none.jpg") is None

    per = {n: {"depth": rng.uniform(1, 5, (4, 5)), "valid": np.ones((4, 5), bool),
               "variance": rng.uniform(0.1, 1, (4, 5))} for n in ("im0.jpg", "im1.jpg")}
    w.write_pair_mono_map(tmp_path / "p.h5", "im0.jpg", "im1.jpg", per)
    pairs = [("im0.jpg", "im1.jpg")]
    a, b = (m.get_mono_map_from_pairs(tmp_path / "p.h5", "im1.jpg", pairs) for m in (r, w))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    mask = rng.uniform(size=(6, 8)) > 0.5
    w.write_mask(tmp_path / "k.h5", "im0.jpg", mask)
    assert np.array_equal(r.get_mask(tmp_path / "k.h5", "im0.jpg"), mask)

    w.write_pairs(tmp_path / "pairs.txt", [("a", "b"), ("b", "a"), ("a", "c"), ("c", "c")])
    assert r.read_pairs(tmp_path / "pairs.txt") == w.read_pairs(tmp_path / "pairs.txt") == [("a", "b"), ("a", "c")]
    assert tio.names_to_pair("x/y.jpg", "z.jpg") == jio.names_to_pair("x/y.jpg", "z.jpg")
    assert tio.names_to_pair_old("x/y.jpg", "z.jpg") == jio.names_to_pair_old("x/y.jpg", "z.jpg")


def test_profiling_timers_and_trace(tmp_path):
    """PhaseTimers keep the JAX package's totals, counts and JSON layout;
    device_trace writes a Chrome trace of the block into log_dir."""
    tj, tt = jprof.PhaseTimers(), tprof.PhaseTimers()
    for timers in (tj, tt):
        for name in ("a", "b", "a"):
            with timers.phase(name):
                pass
    assert tt.counts == tj.counts == {"a": 2, "b": 1}
    data = tt.to_json(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == data and data.keys() == tj.to_json().keys()
    assert len(tt.summary().splitlines()) == 2
    tt.reset()
    assert not tt.totals and tprof.TIMERS is not None
    with tprof.device_trace(tmp_path / "trace"):
        torch.ones(8).sum()
    (trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
    assert "traceEvents" in json.loads(trace.read_text())


def test_chip_smoke_scene_phase_on_the_cpu():
    """chip_smoke.py's scene phase, its parts (a) the scene state, (b) the
    native store against the plain one and (d) the covariance store, at the
    small bundle on the CPU: their invariants and checks hold."""
    import chip_smoke

    b = chip_smoke.synthetic_bundle(8, 256)
    times = chip_smoke.scene_state_phase(b, b.quat, b.t, b.xyz, np.random.default_rng(0))
    assert {"add_points", "filter_points3D", "readd_points", "normalize"} <= times.keys()
    chip_smoke.store_parity_phase(b, b.quat, b.t, b.xyz, 6, 3)
    a = torch.randn(256, 3, 3, generator=torch.Generator().manual_seed(0))
    assert chip_smoke.cov_store_phase(a @ a.transpose(1, 2)) >= 0
