"""The distributed BA and the sharded inference of the port
(mpsfm_tpu_torch/parallel/) against the JAX package's parallel/ on the CPU.

Inputs: __graft_entry__._synthetic_ba_data (every camera sees every
point, with depth rows) and _synthetic_ba_data_sparse (a sweep), from a
seed. Two-rank runs are gloo groups of tests/torch_dist_worker.py
processes; the JAX package's sharded solve runs on a 2-device mesh of the
CPU (tests/conftest.py).

Tolerances:
  - partition_ba_data, make_block_schur_tables_sharded,
    unpartition_points: every array equal, dtypes included (the port's
    numpy is the JAX package's, line for line);
  - solve_ba_block_sharded on 2 ranks, each route, against the JAX
    package's on 2 devices and against the port's solve_ba:
    tests/test_parallel.py::test_block_sharded_ba_matches_single_device's
    bounds (cost0 1e-5 relative, cost 1e-3 relative, quaternions 1e-5,
    points 1e-3) over its 6 iterations at rel_tol 0 (the latch flips
    between packages, ROADMAP queue 3); the cost histories within 1e-3
    and the first DECISION_ITERS steps accepted in each. From the 4th step
    on the cost moves below float32's resolution of it (1e-6), so whether
    such a step is taken is float32 order: the JAX package itself takes 4
    of 6 on 8 devices and 5 on 2. The two ranks' results bit for bit;
  - run_sharded_batches: equal to the per-item results.
"""

import pickle

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_ba_data, _synthetic_ba_data_sparse
from mpsfm_tpu.ba import schur_sparse as jss
from mpsfm_tpu.parallel import dist_ba as jd
from mpsfm_tpu.parallel.sharded_inference import run_sharded_batches as jrun
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.ba import schur_sparse as tss
from mpsfm_tpu_torch.ba import solver as ts
from mpsfm_tpu_torch.extraction import base as tbase
from mpsfm_tpu_torch.mapper import optimizer as topt
from mpsfm_tpu_torch.parallel import dist_ba as td
from mpsfm_tpu_torch.parallel import multihost
from mpsfm_tpu_torch.parallel.sharded_inference import run_sharded_batches
from test_torch_multihost import load, run_ranks

ITERS = 6
DECISION_ITERS = 3
ROUTES = {"block-Schur": "1", "dense-T": "0"}  # MPSFM_DIST_BS
DATAS = {
    "bench": lambda: _synthetic_ba_data(n_cams=8, n_pts=128),
    "sweep": lambda: _synthetic_ba_data_sparse(n_cams=12, n_pts=512, track_len=4, with_pc=True),
}


def assert_parts_equal(pj, pt):
    assert pj.keys() == pt.keys()
    assert pj.get("n_bs_buckets") == pt.get("n_bs_buckets")
    for key in ("repl", "shard"):
        assert pj[key].keys() == pt[key].keys(), set(pj[key]) ^ set(pt[key])
        for k, a in pj[key].items():
            a, b = np.asarray(a), pt[key][k]
            assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, (key, k)
            assert np.array_equal(a, b), (key, k)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("name", sorted(DATAS))
def test_partition_matches_jax(name, n_shards, route, monkeypatch):
    """partition_ba_data array for array (depth rows included), the point
    ids of each shard, and the route: block-Schur tables, or the
    per-(point, camera) tables of the dense T route under MPSFM_DIST_BS=0."""
    monkeypatch.setenv("MPSFM_DIST_BS", ROUTES[route])
    d = DATAS[name]()
    assert float(np.asarray(d.d_valid).sum()) > 0
    pj, ij = jd.partition_ba_data(d, n_shards)
    pt, it = td.partition_ba_data(convert.ba_data(d._asdict(), device="cpu"), n_shards)
    assert_parts_equal(pj, pt)
    assert len(ij) == len(it) == n_shards and all(np.array_equal(a, b) for a, b in zip(ij, it))
    assert ("bs_uni_slots" in pt["shard"]) == (route == "block-Schur")
    assert ("pc_r_slot" in pt["shard"]) == (route == "dense-T")
    assert_parts_equal(pj, convert.parts(pj))


def shard_obs(parts, n):
    return [{k: parts["shard"][k][s] for k in ("r_pt", "r_cam", "r_valid", "d_pt", "d_cam", "d_valid")}
            for s in range(n)]


@pytest.mark.parametrize("limit", [None, "pairs", "blocks"])
@pytest.mark.parametrize("n_shards", [2, 3])
def test_block_schur_tables_sharded_match_jax(n_shards, limit, monkeypatch):
    """make_block_schur_tables_sharded table for table on a partition's
    shard tables (per-shard and shared), or None in both past a limit."""
    monkeypatch.setenv("MPSFM_DIST_BS", "0")
    d = DATAS["sweep"]()
    parts, _ = jd.partition_ba_data(d, n_shards)
    Pl, C = parts["shard"]["xyz"].shape[1], parts["repl"]["quat"].shape[0]
    kw = {"pairs": dict(max_pair_elems=1000), "blocks": dict(max_block_elems=1000)}.get(limit, {})
    bj = jss.make_block_schur_tables_sharded(shard_obs(parts, n_shards), Pl, C, **kw)
    bt = tss.make_block_schur_tables_sharded(shard_obs(parts, n_shards), Pl, C, **kw)
    assert (bj is None) == (bt is None) == (limit is not None)
    if bj is None:
        return
    (psj, shj), (pst, sht) = bj, bt
    assert shj.keys() == sht.keys() and len(psj) == len(pst) == n_shards
    for k in shj:
        assert shj[k].dtype == sht[k].dtype and np.array_equal(shj[k], sht[k]), k
    for a, b in zip(psj, pst):
        assert a.keys() == b.keys()
        for k in a:
            xs, ys = (a[k], b[k]) if isinstance(a[k], tuple) else ((a[k],), (b[k],))
            assert len(xs) == len(ys), k
            for x, y in zip(xs, ys):
                assert x.dtype == y.dtype and np.array_equal(x, y), k


def test_unpartition_points_matches_jax(rng):
    d = DATAS["sweep"]()
    _, pids = jd.partition_ba_data(d, 3)
    Pl = max(len(p) for p in pids)
    xs = rng.normal(size=(3, Pl, 3)).astype(np.float32)
    want = jd.unpartition_points(xs, pids, d.xyz.shape[0])
    for given in (xs, xs.reshape(-1, 3), torch.as_tensor(xs)):
        got = td.unpartition_points(given, pids, d.xyz.shape[0])
        assert got.dtype == want.dtype and np.array_equal(got, want)


def jax_solve(parts, n, **kw):
    q, t, x, info = jd.solve_ba_block_sharded(parts, jd.make_mesh(n, axis="blocks"), max_iters=ITERS, **kw)
    return {"quat": np.asarray(q), "t": np.asarray(t), "xyz": np.asarray(x).reshape(n, -1, 3),
            "cost0": float(info["cost0"]), "cost": float(info["cost"]), "accepted": int(info["accepted"]),
            "cost_history": np.asarray(info["cost_history"])}


def assert_solves_close(a, b, pids, P, what):
    """test_block_sharded_ba_matches_single_device's bounds (b the reference)."""
    assert abs(float(a["cost0"]) - float(b["cost0"])) <= 1e-5 * abs(float(b["cost0"])), what
    assert abs(float(a["cost"]) - float(b["cost"])) <= 1e-3 * abs(float(b["cost"])), what
    np.testing.assert_allclose(a["quat"], b["quat"], atol=1e-5, err_msg=what)
    xa = td.unpartition_points(a["xyz"], pids, P) if pids is not None else a["xyz"]
    xb = td.unpartition_points(b["xyz"], pids, P) if b["xyz"].ndim == 3 else b["xyz"]
    np.testing.assert_allclose(xa, xb, atol=1e-3, err_msg=what)


ITEMS = [np.full((4, 4), i, np.float32) for i in range(3)] + [np.full((8, 8), 9.0, np.float32),
                                                              np.arange(64, dtype=np.float32).reshape(8, 8)]


def infer(b):
    return b.sum(dim=(1, 2)), b[:, 0, :] > 4


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One launch of two gloo ranks on the bench bundle: both routes, a
    partition whose cameras differ on rank 1, and run_sharded_batches.
    Returns (the ranks' results, the JAX package's on 2 devices, the
    port's solve_ba, the point ids, P, the parts)."""
    out = tmp_path_factory.mktemp("two_ranks")
    d = DATAS["bench"]()
    routes, jres, pids = {}, {}, None
    for name, flag in ROUTES.items():
        with pytest.MonkeyPatch.context() as m:
            m.setenv("MPSFM_DIST_BS", flag)
            parts, pids = jd.partition_ba_data(d, 2)
        routes[name] = convert.parts(parts)
        jres[name] = jax_solve(parts, 2, rel_tol=0.0)
    (out / "inputs.pkl").write_bytes(pickle.dumps({"routes": routes, "items": ITEMS, "rel_tol": 0.0}))
    run_ranks("solve", 2, out)
    q, t, x, info = ts.solve_ba(convert.ba_data(d._asdict(), device="cpu"), max_iters=ITERS, rel_tol=0.0)
    single = {"quat": q.numpy(), "t": t.numpy(), "xyz": x.numpy(), "cost0": float(info["cost0"]),
              "cost": float(info["cost"])}
    return load(out, "rank{}.pkl", 2), jres, single, pids, d.xyz.shape[0], routes


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_two_rank_solve_matches_jax_and_solve_ba(two_ranks, route):
    """solve_ba_block_sharded in a 2-rank gloo group against the JAX
    package's on a 2-device mesh and against the port's solve_ba, on the
    block-Schur and the dense T route (K1's plain version on the CPU); the
    ranks' results equal bit for bit."""
    ranks, jres, single, pids, P, routes = two_ranks
    r0, r1 = (r["routes"][route] for r in ranks)
    for k in ("quat", "t", "xyz", "cost0", "cost", "cost_history"):
        assert np.array_equal(np.asarray(r0[k]), np.asarray(r1[k])), k
    assert r0["accepted"] == r1["accepted"]
    np.testing.assert_allclose(r0["cost_history"], jres[route]["cost_history"], rtol=1e-3)
    for hist, c0 in ((r0["cost_history"], r0["cost0"]), (jres[route]["cost_history"], jres[route]["cost0"])):
        assert (np.diff(np.concatenate([[c0], hist[:DECISION_ITERS]])) < 0).all()
    assert r0["xyz"].shape == jres[route]["xyz"].shape
    assert_solves_close(r0, jres[route], pids, P, f"{route}: port vs JAX")
    assert_solves_close(r0, single, pids, P, f"{route}: sharded vs solve_ba")
    assert ("n_bs_buckets" in routes[route]) == (route == "block-Schur")
    # one all-reduce for the cost and one for the step's system a step, one for Hcc and g_c a build
    assert r0["all_reduces"] == 1 + 2 * r0["steps"] + 1 + r0["accepted"]
    assert r0["all_reduce_bytes"] > 0


def test_two_rank_divergence_raises(two_ranks):
    """A rank whose replicated cameras differ from the others' fails the
    solve on every rank (RuntimeError) instead of mixing them into the sums."""
    for r in two_ranks[0]:
        assert "diverged" in r["diverged"], r["diverged"]


def test_two_rank_sharded_inference(two_ranks):
    """run_sharded_batches over 2 ranks (a bucket of 3, shared out as 2 + 2
    with a padded row, and one of 2) equals the per-item results on every
    rank."""
    for r in two_ranks[0]:
        assert len(r["inference"]) == len(ITEMS)
        for item, (s, m) in zip(ITEMS, r["inference"]):
            assert s == item.sum() and np.array_equal(m, item[0] > 4)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", sorted(DATAS))
def test_single_rank_solve_matches_jax(monkeypatch, name, route):
    """Without a process group the sharded solve is one shard and no
    collective: against the JAX package's on one device, on the bench
    bundle at test_block_sharded_ba_matches_single_device's bounds and on
    the sweep at tests/test_parallel.py::test_block_sharded_ba_sparse_tracks'
    (cost0 1e-4, cost 5e-2 relative: its soft modes leave the points
    where float32 order takes them)."""
    monkeypatch.setenv("MPSFM_DIST_BS", ROUTES[route])
    d = DATAS[name]()
    parts, pids = jd.partition_ba_data(d, 1)
    q, t, x, info = td.solve_ba_block_sharded(convert.parts(parts), None, max_iters=ITERS, rel_tol=0.0,
                                              device="cpu")
    got = {"quat": q.numpy(), "xyz": td.all_gather_points(x).numpy(), "cost0": float(info["cost0"]),
           "cost": float(info["cost"])}
    assert info["all_reduces"] == 0
    want = jax_solve(parts, 1, rel_tol=0.0)
    if name == "bench":
        assert_solves_close(got, want, pids, d.xyz.shape[0], route)
    else:
        assert got["cost"] < got["cost0"]
        np.testing.assert_allclose(got["cost0"], want["cost0"], rtol=1e-4)
        np.testing.assert_allclose(got["cost"], want["cost"], rtol=5e-2)


def test_group_size_must_match_the_partition():
    parts, _ = td.partition_ba_data(convert.ba_data(DATAS["bench"]()._asdict(), device="cpu"), 2)
    with pytest.raises(ValueError, match="2 shards needs a group of 2 ranks, not 1"):
        td.solve_ba_block_sharded(parts, None, device="cpu")


def test_sharded_inference_shape_buckets():
    """tests/test_parallel.py's twin, with one rank: plain batching."""
    items = [np.full((4, 4), i, np.float32) for i in range(3)] + [np.full((8, 8), 9.0, np.float32)]
    outs = run_sharded_batches(lambda b: b.sum(dim=(1, 2)), items, lambda x: x, device="cpu")
    assert [float(o) for o in outs] == [0.0, 16.0, 32.0, 9.0 * 64]
    want = jrun(lambda b: b.sum(axis=(1, 2)), items, lambda x: x)
    assert [float(o) for o in outs] == [float(o) for o in want]
    # tuples of outputs keep their order and dtypes
    outs = run_sharded_batches(infer, ITEMS, lambda x: x, device="cpu")
    assert all(m.dtype == bool and np.array_equal(m, it[0] > 4) for it, (_, m) in zip(ITEMS, outs))


def test_feature_extraction_through_sharded_inference(rng):
    """Extraction._feature_preds under sharded_inference (the default: one
    rank, shape buckets) equals the detector's own batches, image for
    image, with buckets of two shapes."""
    from mpsfm_tpu_torch.extraction.features.classical import ClassicalFeatures

    model = ClassicalFeatures({"max_keypoints": 64}, device="cpu")
    imgs = [rng.random((40, 48)).astype(np.float32) for _ in range(3)] + [rng.random((32, 40)).astype(np.float32)]
    ex = tbase.Extraction.__new__(tbase.Extraction)
    ex.conf = type("C", (), {"sharded_inference": True})()
    got = ex._feature_preds(model, imgs)
    ex.conf.sharded_inference = False
    want = ex._feature_preds(model, imgs)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert np.array_equal(g[k], w[k]), k


@pytest.mark.parametrize("world,conf,cams,want", [
    (1, {}, 200, 0),  # one rank never shards
    (4, {}, 95, 0),  # auto below dist_ba_min_cams
    (4, {}, 96, 4),
    (4, {"dist_ba": "on"}, 3, 4),
    (4, {"dist_ba": "off"}, 200, 0),
    (4, {"dist_ba_shards": 2}, 200, 2),
    (2, {"dist_ba_shards": 8}, 200, 2),
    (1, {"dist_ba": "on"}, 200, 0),
])
def test_use_dist_ba_reads_the_world_size(monkeypatch, world, conf, cams, want):
    """Optimizer._use_dist_ba decides as the JAX package's, over the ranks
    of the default process group (its devices there), for global bundles
    only."""
    monkeypatch.setattr(multihost, "world_size", lambda group=None: world)
    from mpsfm_tpu_torch.scene.reconstruction import Reconstruction

    opt = topt.Optimizer(conf, Reconstruction(), device="cpu")
    bundle = {"optim_ids": set(range(cams))}
    assert opt._use_dist_ba(bundle, "global") == want
    assert opt._use_dist_ba(bundle, "local") == 0



def test_entry_points_refuse_the_cpu_without_a_card(monkeypatch):
    """The sharded solve, the sharded inference and the process group's
    device default to the card and raise without one; nothing falls back
    to the CPU or from NCCL to gloo."""
    parts, _ = td.partition_ba_data(convert.ba_data(DATAS["bench"]()._asdict(), device="cpu"), 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for call in (lambda: td.solve_ba_block_sharded(parts), lambda: run_sharded_batches(infer, ITEMS, lambda x: x),
                 lambda: multihost.initialize_multihost()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not torch.distributed.is_initialized()
