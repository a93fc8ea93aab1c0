"""The port's native track store: its build, its plain version and the JAX
package's Reconstruction.

The store is compiled from mpsfm_tpu_torch/native/trackstore.cpp into
mpsfm_tpu_torch/_build/ and never touches mpsfm_tpu/ (whose own tests
rebuild mpsfm_tpu/native/ in parallel, so its files are not checked here).
A failed build raises: the port has no silent fallback to PyTrackStore.
The native store is held against PyTrackStore op by op, and seeded
mutation sequences in the style of tests/test_native.py run on a JAX
Reconstruction, a port Reconstruction on the native store and one on
PyTrackStore, with the states compared along the way.
"""

from pathlib import Path

import numpy as np
import pytest

import mpsfm_tpu.scene.reconstruction as jrec
import mpsfm_tpu_torch
from mpsfm_tpu_torch import native
from mpsfm_tpu_torch.scene import reconstruction as trec

from test_torch_scene import assert_close, assert_same_state

PKG = Path(mpsfm_tpu_torch.__file__).resolve().parent


def test_store_builds_from_the_port_into_its_build_dir():
    native.NativeTrackStore()
    path = native.library_path()
    assert native.SOURCE == PKG / "native" / "trackstore.cpp"
    assert path.parent == PKG / "_build" and path.name.startswith("libtrackstore-")
    assert path.exists() and Path(native.load()._name) == path


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "trackstore.cpp"
    bad.write_text("int ts_create( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for trackstore.cpp:\n.*error"):
        native.NativeTrackStore()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        trec.Reconstruction()  # no fallback to the Python store
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_store_matches_plain_store_op_by_op():
    """tests/test_native.py's basic sequence on both stores, every return
    value compared."""
    stores = native.NativeTrackStore(), trec.PyTrackStore()
    outs = []
    for ts in stores:
        out = []
        for i in range(3):
            ts.add_image(i, 10)
        pid = ts.add_point([0.0, 0, 5.0], [(0, 0), (1, 0), (2, 0)])
        out.append(pid)
        p2 = ts.add_point([1.0, 0, 6.0], [(0, 0), (1, 1)])  # (0, 0) already taken
        out += [p2, ts.get_track(p2), ts.add_observation(p2, 2, 1), ts.add_observation(p2, 2, 1), ts.get_track(p2)]
        out += [ts.remove_observation(pid, 0, 0), ts.remove_observation(pid, 1, 0), ts.get_track(pid)]
        out.append(ts.add_point([2.0, 0, 7.0], [(0, 5), (1, 5)]))  # reuses pid's slot
        out.append(ts.add_point([3.0, 0, 7.0], [(0, 5)]))  # every observation taken: -1, slot freed
        out.append(ts.add_point([3.0, 0, 8.0], [(2, 9), (0, 9)]))
        ts.delete_point(p2)
        out += [ts.num_slots(), ts.observations(np.arange(ts.num_slots()))]
        outs.append(out)
    for a, b in zip(*outs):
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                assert_close(x, y)
        else:
            assert a == b
    nat = stores[0]
    assert nat.num_points() == 2 and list(nat.alive_pids()) == [0, 2]
    assert list(nat.image_point_ids(0, 10)[[5, 9]]) == [0, 2]


def _rec(module, n_im, n_kp, rng, plain=False):
    rec = module.Reconstruction()
    if plain:
        rec._store = trec.PyTrackStore()  # before any point is added
    rec.add_camera(module.HostCamera(1, np.array([500.0, 500, 320, 240]), 640, 480))
    for i in range(n_im):
        im = module.ImageRecord(i, f"im{i}", 1)
        im.keypoints = rng.uniform(0, 600, size=(n_kp, 2))
        im.point3D_ids = np.full(n_kp, -1, np.int64)
        im.pose = module.Pose(np.array([1.0, 0, 0, 0]), np.array([-0.4 * i, 0.05 * i, 0.0]))
        im.registered = True
        rec.add_image(im)
    return rec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mutation_sequence_matches_jax(seed):
    """A seeded storm of point adds, observation adds and removals and point
    deletes (tests/test_native.py:40), mirrored on the three
    reconstructions; states compared every 100 steps, then after the
    filters, a deregistration and re-adds into freed slots."""
    n_im, n_kp = 6, 200
    recs = [_rec(m, n_im, n_kp, np.random.default_rng(seed), plain=p)
            for m, p in ((jrec, False), (trec, False), (trec, True))]
    assert isinstance(recs[1]._store, native.NativeTrackStore)
    rng = np.random.default_rng(100 + seed)
    ref = recs[0]
    for step in range(600):
        op = rng.integers(0, 5)
        alive = ref.point_ids()
        if op <= 1 or len(alive) == 0:  # add a point
            k = int(rng.integers(0, n_kp))
            track = [(i, int((k + rng.integers(0, 3)) % n_kp)) for i in range(n_im) if rng.uniform() < 0.7]
            if len(track) < 2:
                continue
            xyz = np.array([rng.normal(), rng.normal(), rng.uniform(4, 8)])
            pids = [r.add_point3D(xyz, track) for r in recs]
            assert pids[0] == pids[1] == pids[2]
        elif op == 2:  # remove an observation
            pid = int(rng.choice(alive))
            imid, kp = ref.tracks[pid][rng.integers(0, ref.track_len[pid])]
            for r in recs:
                r.remove_observation(pid, imid, kp)
        elif op == 3:  # add an observation
            pid, imid, kp = int(rng.choice(alive)), int(rng.integers(0, n_im)), int(rng.integers(0, n_kp))
            for r in recs:
                r.add_observation(pid, imid, kp)
        else:  # delete a point
            pid = int(rng.choice(alive))
            for r in recs:
                r.delete_point3D(pid)
        if step % 100 == 99:
            for r in recs[1:]:
                assert_same_state(ref, r)
    angles = [r.triangulation_angles(r.point_ids()) for r in recs]
    changed = [r.filter_all_points3D(300.0, 1.0) for r in recs]
    assert changed[0] == changed[1] == changed[2]
    for r in recs:
        r.deregister_image(2)
    freed = sorted(set(range(ref._num_points)) - set(ref.point_ids().tolist()))
    added = [[r.add_point3D(np.array([0.0, 0, 5.0]), [(0, k), (1, k)]) for k in range(n_kp)] for r in recs]
    success = [p for p in added[0] if p >= 0]
    assert added[0] == added[1] == added[2] and freed and set(success[: len(freed)]) <= set(freed)
    for r, a in zip(recs[1:], angles[1:]):
        assert_close(angles[0], a)
        assert_same_state(ref, r)
