"""The depth-consistency check's device core: the port against the JAX
package (mpsfm_tpu/mapper/depth_consistency.py) on the same float32 grids,
intrinsics and per-pair rows.

The scenes are those of tests/test_mapper_units.py (two views of the
analytic plane, exact depth, view 2 shifted by 0, 0.3 or 1.5), a bundle of
three refs of different poses, and a scene with inf, zero and negative
depths whose refs see part of the query outside their canvas. The grids and
factors come from the JAX checker's `_dc_dev`, the rows from its row
construction (:419-431).

Tolerances: the four counts of every pair equal, and the bundle score equal
to the JAX checker's (the JAX package's own test holds its batched score
to the per-pair chain within abs 0.02, tests/test_mapper_units.py). The
reprojection: u, v within 1e-4 px and z within 1e-6 relative (XLA
contracts a·b + c into an FMA, the port does not: 1 ulp), the in-canvas
mask equal except at pixels within 1e-4 px of a canvas edge (none here);
the z-buffer and the won mask of the same projection bit for bit (min is
exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.mapper import depth_consistency as jdc
from mpsfm_tpu_torch.mapper import depth_consistency as tdc
from synthetic import PlaneScene
from test_mapper_units import make_dc_rec

C, THRESH = 15.0, 0.6  # the checker's c and depth_cons_valid_thresh


def _t(a):
    return torch.tensor(np.asarray(a))


def _bundle_args(rec, query, refs):
    """The inputs of one _bundle_counts call of the JAX checker for `query`
    against `refs` (one grid shape), as numpy arrays: the query's grids, K and
    factors, the refs' stacked grids and Ks, and the rows built as the JAX
    checker builds them."""
    dc = jdc.DepthConsistencyChecker({}, rec)
    (d_q, dq_fac), (var_q, vq_fac), K_q = dc._dc_dev(query)
    pose_q = rec.images[query].pose
    Rq = pose_q.rotation_matrix()
    Mq44 = np.vstack([pose_q.inverse().matrix(), [0, 0, 0, 1]])
    items = []
    for ref in refs:
        (d_r, dr_fac), (var_r, vr_fac), K_r = dc._dc_dev(ref)
        pose_r = rec.images[ref].pose
        M_qr = pose_r.matrix() @ Mq44
        M_rq = pose_q.matrix() @ np.vstack([pose_r.inverse().matrix(), [0, 0, 0, 1]])
        R_rq = pose_r.rotation_matrix() @ Rq.T
        row = np.concatenate(
            [[dr_fac, vr_fac], M_qr.reshape(-1), M_rq.reshape(-1), R_rq[2], R_rq[:, 2]]
        ).astype(np.float32)
        items.append((np.asarray(d_r), np.asarray(var_r), np.asarray(K_r), row))
    args = [np.asarray(d_q), np.asarray(var_q), np.asarray(K_q), np.array([dq_fac, vq_fac], np.float32)]
    args += [np.stack([it[i] for it in items]) for i in range(4)]
    return dc, args


def _jax_counts(args):
    return np.asarray(jdc._bundle_counts(*[jnp.asarray(a) for a in args], jnp.float32(C), jnp.float32(THRESH)))


def _port_counts(args):
    return tdc._bundle_counts(*[_t(a) for a in args], C, THRESH).numpy()


def _four_view_rec(seed):
    scene = PlaneScene(rng=np.random.default_rng(seed), n_images=4, n_points=10, img_wh=(64, 48), focal=60.0)
    rec, _, _, gt = scene.build(with_priors=True, depth_scale_err_range=(1.0, 1.0))
    for i in range(4):
        rec.images[i].registered = True
        rec.images[i].pose = gt["poses"][i]
    return rec


@pytest.mark.parametrize("shift", [0.0, 0.3, 1.5])
def test_pair_counts_match_jax(rng, shift):
    rec = make_dc_rec(rng, shift=shift)
    dc, args = _bundle_args(rec, 0, [1])
    np.testing.assert_array_equal(_port_counts(args), _jax_counts(args))
    score = dc.check_bundle_depth_consistency(0, {"optim_ids": {0, 1}})
    assert tdc.bundle_score(_t(_port_counts(args))) == score
    # the rows from the poses alone are the JAX checker's, bit for bit
    pose_q, pose_r = rec.images[0].pose, rec.images[1].pose
    np.testing.assert_array_equal(tdc.pair_rows((pose_q.q, pose_q.t), [(pose_r.q, pose_r.t)]), args[7])


def test_bundle_of_three_refs_matches_jax():
    rec = _four_view_rec(3)
    dc, args = _bundle_args(rec, 0, [1, 2, 3])
    assert len({tuple(np.round(r[2:14], 4)) for r in args[7]}) == 3  # three different poses
    ct = _port_counts(args)
    np.testing.assert_array_equal(ct, _jax_counts(args))
    assert (ct[:, 1] > 0).all() and (ct[:, 3] > 0).all()
    assert tdc.bundle_score(_t(ct)) == dc.check_bundle_depth_consistency(0, {"optim_ids": {0, 1, 2, 3}})
    # each ref alone gives its own row of the batch
    for b in range(3):
        one = args[:4] + [a[b:b + 1] for a in args[4:]]
        np.testing.assert_array_equal(_port_counts(one), ct[b:b + 1])
    # the factors rescale the grids as the JAX package's do
    scaled = list(args)
    scaled[3] = np.array([1.1, 0.8], np.float32)
    scaled[7] = args[7].copy()
    scaled[7][:, 0:2] = [[0.9, 1.3], [1.0, 1.0], [1.2, 0.7]]
    np.testing.assert_array_equal(_port_counts(scaled), _jax_counts(scaled))


def test_inf_and_out_of_canvas_match_jax():
    """inf, zero and negative depths (a non-positive depth is lifted at 0.1),
    and refs translated so that part of the query lands outside their canvas
    (and far outside, where the float -> int conversion is undefined)."""
    rec = _four_view_rec(5)
    for i, d in ((0, rec.images[0].depth), (2, rec.images[2].depth)):
        prior = np.array(d.data_prior, np.float64)
        prior[3:9, 5:20] = np.inf
        prior[20:24, 30:40] = 0.0
        prior[30:33, 50:60] = -2.0
        d.data_prior = prior
    rec.images[1].pose.t = rec.images[1].pose.t + np.array([1.5, 0.0, 0.0])
    rec.images[3].pose.t = rec.images[3].pose.t + np.array([0.0, 0.0, -4.9])  # most of the scene behind or beside it
    dc, args = _bundle_args(rec, 0, [1, 2, 3])
    assert np.isinf(args[0]).any() and np.isinf(args[4][1]).any()
    ct = _port_counts(args)
    np.testing.assert_array_equal(ct, _jax_counts(args))
    # the query's in-canvas pixels in ref 1 are fewer than its pixels
    assert ct[0, 1] < args[0].size
    assert tdc.bundle_score(_t(ct)) == dc.check_bundle_depth_consistency(0, {"optim_ids": {0, 1, 2, 3}})


def test_reproject_and_min_buffer_match_jax():
    rec = _four_view_rec(5)
    _, args = _bundle_args(rec, 0, [1])
    d, K1, K2 = args[0].copy(), args[2], args[6][0]
    d[3:9, 5:20] = np.inf
    d[20:24, 30:40] = 0.0
    M = args[7][0, 2:14].reshape(3, 4).copy()
    M[0, 3] += 0.5  # part of the map leaves the canvas
    hw = args[4].shape[-2:]
    pj, zj, mj = (np.asarray(a) for a in jdc.reproject_depth_jax(jnp.asarray(d), jnp.asarray(K1), jnp.asarray(K2),
                                                                   jnp.asarray(M), hw))
    pt, zt, mt = (a.numpy() for a in tdc.reproject_depth(_t(d), _t(K1), _t(K2), _t(M), hw))
    fin = np.isfinite(zj)
    np.testing.assert_array_equal(np.isfinite(zt), fin)
    np.testing.assert_allclose(pt[fin], pj[fin], rtol=0, atol=1e-4)
    np.testing.assert_allclose(zt[fin], zj[fin], rtol=1e-6)
    near_edge = (np.abs(pj[..., 0]) < 1e-4) | (np.abs(pj[..., 0] + 0.5 - hw[1]) < 1e-4) | \
                (np.abs(pj[..., 1]) < 1e-4) | (np.abs(pj[..., 1] + 0.5 - hw[0]) < 1e-4)
    assert not near_edge.any()
    np.testing.assert_array_equal(mt, mj)
    assert 0 < mj.sum() < mj.size
    # the z-buffer of the same projection (JAX's), bit for bit
    bj, wj = (np.asarray(a) for a in jdc.min_buffer_jax(jnp.asarray(pj), jnp.asarray(zj), jnp.asarray(mj), hw))
    bt, wt = (a.numpy() for a in tdc.min_buffer(_t(pj), _t(zj), _t(mj), hw))
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(wt, wj)
    assert 0 < wj.sum() < mj.sum() and np.isinf(bj).any()  # occluded pixels lose; some targets stay empty


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_counts_on_card_match_cpu(cuda):
    """The port on the card against the port on the CPU, same inputs: every
    op is one float32 elementwise op or an exact min, so the counts are
    equal."""
    for seed, refs in ((3, [1, 2, 3]), (5, [1, 2, 3])):
        rec = _four_view_rec(seed)
        if seed == 5:
            prior = np.array(rec.images[2].depth.data_prior, np.float64)
            prior[3:9, 5:20] = np.inf
            rec.images[2].depth.data_prior = prior
        _, args = _bundle_args(rec, 0, refs)
        card = tdc._bundle_counts(*[_t(a).to(cuda) for a in args], C, THRESH).cpu().numpy()
        np.testing.assert_array_equal(card, _port_counts(args))
