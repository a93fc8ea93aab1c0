"""Rotations, projection, triangulation, small linear algebra, robust
losses and LM helpers: the port against the JAX package.

Same float32 inputs from a seed; the two differ only by rounding (atol
1e-6 on unit-scale values, rtol 1e-6 on the losses). Projection, over the
cases of tests/test_geometry.py: pixels within 1e-3 px (a few ulp at 600
px), depths and lifted points within 1e-5. Triangulation: within the JAX
test's 1e-3 of the truth and 1e-4 of the JAX package, angles within 1e-5
rad. Linear algebra: eigenvectors and nullspace vectors within 1e-4 up to
sign (the library's); the two largest singular values within 1e-5
relative, every singular value within 1e-3·σ₁ (the floor of an SVD
through eigh(MᵀM), sqrt(eps)·σ₁); U and V proper rotations, with
U diag(s₁, s₂, sign(det M)·s₃) Vᵀ - M within 1e-3·σ₁.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.ba import losses as jl
from mpsfm_tpu.ba import solver as js
from mpsfm_tpu.geometry import linalg as jla
from mpsfm_tpu.geometry import projection as jpr
from mpsfm_tpu.geometry import rotations as jr
from mpsfm_tpu.geometry import triangulation as jtri
from mpsfm_tpu_torch.ba import losses as tl
from mpsfm_tpu_torch.ba import solver as ts
from mpsfm_tpu_torch.geometry import linalg as tla
from mpsfm_tpu_torch.geometry import projection as tpr
from mpsfm_tpu_torch.geometry import rotations as tr
from mpsfm_tpu_torch.geometry import triangulation as ttri


def _q(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(fn_name, *args):
    j = getattr(jr, fn_name)(*[jnp.asarray(a) for a in args])
    t = getattr(tr, fn_name)(*[torch.from_numpy(np.array(a)) for a in args])
    return j, t


@pytest.mark.parametrize("fn", ["quat_normalize", "quat_conj", "quat_to_matrix", "so3_exp_quat"])
def test_unary_rotation_ops_match_jax(rng, fn):
    arg = rng.normal(size=(32, 3)).astype(np.float32) if fn == "so3_exp_quat" else _q(rng, 32) * 1.7
    if fn == "so3_exp_quat":
        arg[:4] *= 1e-7  # the small-angle branch
    j, t = _both(fn, arg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_binary_rotation_ops_match_jax(rng):
    q1, q2 = _q(rng, 16), _q(rng, 16)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    for fn, args in (("quat_mul", (q1, q2)), ("quat_rotate", (q1, v))):
        j, t = _both(fn, *args)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6, err_msg=fn)


def test_matrix_to_quat_matches_jax(rng):
    R = np.asarray(jr.quat_to_matrix(jnp.asarray(_q(rng, 64))))
    j, t = _both("matrix_to_quat", R)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def test_rigid_ops_match_jax(rng):
    q, tt, pts = _q(rng, 5), rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 3)).astype(np.float32)
    jp, tp = jr.Rigid3d(jnp.asarray(q), jnp.asarray(tt)), tr.Rigid3d(torch.from_numpy(q), torch.from_numpy(tt))
    pairs = [
        (jr.rigid_transform(jp, jnp.asarray(pts)), tr.rigid_transform(tp, torch.from_numpy(pts))),
        (jr.projection_center(jp), tr.projection_center(tp)),
        (jr.rigid_compose(jr.rigid_inverse(jp), jp).t, tr.rigid_compose(tr.rigid_inverse(tp), tp).t),
        (jr.apply_local_update(jp, jnp.asarray(pts * 1e-3), jnp.asarray(tt)).quat,
         tr.apply_local_update(tp, torch.from_numpy(pts * 1e-3), torch.from_numpy(tt)).quat),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)
    ident = tr.Rigid3d.identity((2,), device="cpu")
    np.testing.assert_array_equal(ident.quat.numpy(), np.asarray(jr.Rigid3d.identity((2,)).quat))


@pytest.mark.parametrize("loss_id", [jl.TRIVIAL, jl.SOFT_L1, jl.CAUCHY])
def test_losses_match_jax(loss_id):
    """The cases of tests/test_ba.py::test_losses_match_ceres_forms."""
    s = np.array([0.0, 1.0, 4.0, 100.0], np.float32)
    a = np.full(4, 1.5, np.float32)
    for fn in ("rho", "rho_prime"):
        j = getattr(jl, fn)(loss_id, jnp.asarray(s), jnp.asarray(a))
        t = getattr(tl, fn)(loss_id, torch.from_numpy(s), torch.from_numpy(a))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, err_msg=fn)
    assert tl.LOSS_IDS == jl.LOSS_IDS
    assert (tl.TRIVIAL, tl.SOFT_L1, tl.CAUCHY) == (jl.TRIVIAL, jl.SOFT_L1, jl.CAUCHY)


def test_solver_helpers_match_jax(rng):
    q = _q(rng, 6)
    tt = rng.normal(size=(6, 3)).astype(np.float32)
    delta = (rng.normal(size=(6, 6)) * 0.01).astype(np.float32)
    jq, jt = js._apply_cam_update(jnp.asarray(q), jnp.asarray(tt), jnp.asarray(delta))
    tq, tt2 = ts._apply_cam_update(torch.from_numpy(q), torch.from_numpy(tt), torch.from_numpy(delta))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tt2.numpy(), np.asarray(jt), atol=1e-6)
    for a, b in zip(ts._rotmat_cols(torch.from_numpy(q)), js._rotmat_cols(jnp.asarray(q))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    M = rng.normal(size=(10, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    M[0] = 0.0  # singular: the determinant guard
    np.testing.assert_allclose(ts.inv3x3(torch.from_numpy(M)).numpy(), np.asarray(js.inv3x3(jnp.asarray(M))),
                               rtol=1e-5, atol=1e-6)


def _cams(params):
    return jpr.Camera.from_params(jnp.asarray(params)), tpr.Camera.from_params(torch.tensor(params))


def _poses(q, t):
    return jr.Rigid3d(jnp.asarray(q), jnp.asarray(t)), tr.Rigid3d(torch.tensor(q), torch.tensor(t))


def test_projection_matches_jax(rng):
    """tests/test_geometry.py::test_projection_roundtrip and test_cam_img_inverse."""
    jc, tc = _cams(np.array([600.0, 610.0, 320.0, 240.0], np.float32))
    jp, tp = _poses(_q(rng, 1)[0], (rng.normal(size=3) * 0.1).astype(np.float32))
    pts_cam = (rng.uniform(1.0, 5.0, size=(50, 3)) * np.array([0.4, 0.4, 1.0])).astype(np.float32)
    pts = tr.rigid_transform(tr.rigid_inverse(tp), torch.tensor(pts_cam))
    px_j, d_j = jax.jit(jpr.project_points)(jp, jc, jnp.asarray(pts.numpy()))
    px_t, d_t = tpr.project_points(tp, tc, pts)
    np.testing.assert_allclose(px_t.numpy(), np.asarray(px_j), atol=1e-3)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    assert (d_t.numpy() > 0).all()
    lifted = tpr.lift_to_world(tp, tc, px_t, d_t)
    np.testing.assert_allclose(lifted.numpy(), pts.numpy(), atol=1e-5)
    np.testing.assert_allclose(lifted.numpy(), np.asarray(jax.jit(jpr.lift_to_world)(jp, jc, px_j, d_j)), atol=1e-5)
    xy = np.array([[10.0, 20.0], [300.0, 200.0]], np.float32)
    np.testing.assert_allclose(tpr.img_from_cam(tc, tpr.cam_from_img(tc, torch.tensor(xy))).numpy(), xy, atol=1e-4)
    np.testing.assert_allclose(tpr.cam_from_img(tc, torch.tensor(xy)).numpy(),
                               np.asarray(jpr.cam_from_img(jc, jnp.asarray(xy))), atol=1e-6)
    np.testing.assert_array_equal(tc.calibration_matrix().numpy(), np.asarray(jc.calibration_matrix()))
    simple = tpr.Camera.from_params(torch.tensor([500.0, 320.0, 240.0]))
    assert float(simple.fx) == float(simple.fy) == 500.0
    # a dense map: unproject, then project back to the pixel grid
    depth = rng.uniform(2.0, 4.0, size=(6, 8)).astype(np.float32)
    wj = jax.jit(jpr.unproject_depth_map)(jp, jc, jnp.asarray(depth))
    wt = tpr.unproject_depth_map(tp, tc, torch.tensor(depth))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-5)
    px, d = tpr.project_points(tp, tc, wt)
    np.testing.assert_allclose(d.numpy(), depth, rtol=1e-5)


def _two_view(rng, n=40):
    """tests/test_geometry.py::make_two_view: (jax and port cameras and
    poses, world points, pixels in both views from the port)."""
    jc, tc = _cams(np.array([500.0, 500.0, 320.0, 240.0], np.float32))
    q2 = tr.so3_exp_quat(torch.tensor([0.02, -0.4, 0.01])).numpy()
    jp1, tp1 = _poses(np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32))
    jp2, tp2 = _poses(q2, np.array([-1.0, 0.0, 0.1], np.float32))
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n), rng.uniform(3.0, 8.0, n)], -1).astype(np.float32)
    px1, _ = tpr.project_points(tp1, tc, torch.tensor(pts))
    px2, _ = tpr.project_points(tp2, tc, torch.tensor(pts))
    return (jc, tc), (jp1, tp1), (jp2, tp2), pts, px1, px2


def test_triangulation_matches_jax(rng):
    """tests/test_geometry.py::test_triangulate_two_view and test_point_depth."""
    (jc, tc), (jp1, tp1), (jp2, tp2), pts, px1, px2 = _two_view(rng)
    Xt = ttri.triangulate_two_view_px(tp1, tp2, tc, tc, px1, px2)
    Xj = jax.jit(jtri.triangulate_two_view_px)(jp1, jp2, jc, jc, jnp.asarray(px1.numpy()), jnp.asarray(px2.numpy()))
    np.testing.assert_allclose(Xt.numpy(), pts, atol=1e-3)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-4)
    assert ttri.has_positive_depth(tp1, Xt).all()
    ang_t = ttri.pair_triangulation_angle(tp1, tp2, Xt)
    ang_j = jax.jit(jtri.pair_triangulation_angle)(jp1, jp2, jnp.asarray(Xt.numpy()))
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=1e-5)
    assert (ang_t.numpy() > np.deg2rad(1.0)).all()
    jq, tq = _poses(_q(rng, 1)[0], rng.normal(size=3).astype(np.float32))
    p = rng.normal(size=(7, 3)).astype(np.float32)
    np.testing.assert_allclose(ttri.point_depth(tq, torch.tensor(p)).numpy(),
                               np.asarray(jtri.point_depth(jq, jnp.asarray(p))), atol=1e-6)
    np.testing.assert_allclose(ttri.point_depth(tq, torch.tensor(p)).numpy(),
                               tr.rigid_transform(tq, torch.tensor(p))[:, 2].numpy(), atol=1e-6)


def test_triangulate_nview_matches_jax(rng):
    """tests/test_geometry.py::test_triangulate_nview, the 10 points as one
    batch (the JAX function under vmap), and with one view masked."""
    (jc, tc), (jp1, tp1), (jp2, tp2), pts, px1, px2 = _two_view(rng, n=10)
    jp3, tp3 = _poses(tr.so3_exp_quat(torch.tensor([0.0, 0.3, 0.0])).numpy(), np.array([0.8, 0.1, 0.0], np.float32))
    px3, _ = tpr.project_points(tp3, tc, torch.tensor(pts))
    mats = torch.stack([ttri._pose_matrix(p) for p in (tp1, tp2, tp3)]).expand(10, 3, 3, 4)
    xy = torch.stack([tpr.cam_from_img(tc, px) for px in (px1, px2, px3)], 1)  # (10, 3, 2)
    for mask in (np.ones((10, 3), bool), np.array([[True, False, True]] * 10)):
        Xt, ok_t = ttri.triangulate_nview(mats, xy, torch.tensor(mask))
        Xj, ok_j = jax.jit(jax.vmap(jtri.triangulate_nview))(jnp.asarray(mats.numpy()), jnp.asarray(xy.numpy()),
                                                             jnp.asarray(mask))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        assert ok_t.all()
        np.testing.assert_allclose(Xt.numpy(), pts, atol=1e-3)
        np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-4)
    _, ok = ttri.triangulate_nview(mats, xy, torch.tensor([[True, False, False]] * 10))
    assert not ok.any()


def _up_to_sign(a, b, atol):
    s = np.sign((a * b).sum(-1, keepdims=True))
    np.testing.assert_allclose(a * s, b, atol=atol)


def test_linalg_matches_jax(rng):
    A = rng.normal(size=(16, 12, 9)).astype(np.float32)
    S = np.einsum("bmi,bmj->bij", A, A)
    _up_to_sign(tla.smallest_eigvec(torch.tensor(S)).numpy(), np.asarray(jla.smallest_eigvec(jnp.asarray(S))), 1e-4)
    w = rng.uniform(0.5, 1.0, size=(16, 12)).astype(np.float32)
    _up_to_sign(tla.nullspace_vector(torch.tensor(A), torch.tensor(w)).numpy(),
                np.asarray(jax.jit(jla.nullspace_vector)(jnp.asarray(A), jnp.asarray(w))), 1e-4)
    Am = rng.normal(size=(16, 8, 9)).astype(np.float32)  # minimal: 8 rows of 9 columns
    vt = tla.nullspace_vector_minimal(torch.tensor(Am)).numpy()
    _up_to_sign(vt, np.asarray(jax.jit(jla.nullspace_vector_minimal)(jnp.asarray(Am))), 1e-4)
    assert np.abs(np.einsum("bmi,bi->bm", Am, vt)).max() < 1e-4
    M = rng.normal(size=(32, 3, 3)).astype(np.float32)
    M[:8, :, 2] = M[:8, :, 0] + M[:8, :, 1]  # rank 2, the essential-matrix case
    U, s, Vt = (a.numpy() for a in tla.svd3x3(torch.tensor(M)))
    Uj, sj, Vtj = (np.asarray(a) for a in jax.jit(jla.svd3x3)(jnp.asarray(M)))
    s1 = s[:, :1, None]
    np.testing.assert_allclose(s[:, :2], sj[:, :2], rtol=1e-5)
    assert (np.abs(s - sj) <= 1e-3 * s1[:, :, 0]).all()  # the floor of eigh(MᵀM): sqrt(eps)·σ₁
    # proper U and V: the smallest singular value carries det(M)'s sign
    signed = s * np.stack([np.ones(32), np.ones(32), np.sign(np.linalg.det(M))], -1).astype(np.float32)
    assert (np.abs(U @ (signed[:, :, None] * Vt) - M) <= 1e-3 * s1).all()
    np.testing.assert_allclose(np.linalg.det(U), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Vt), 1.0, atol=1e-5)
    # where the JAX package's V is proper, its factors are the port's up to the
    # signs of matched column pairs of U and V
    proper = np.linalg.det(Vtj) > 0
    for b in np.nonzero(proper & (np.arange(32) >= 8))[0]:
        for k in range(2):
            _up_to_sign(Vt[b, k], Vtj[b, k], 1e-3)
            _up_to_sign(U[b, :, k], Uj[b, :, k], 1e-3)


def test_eigh_in_chunks_equals_one_call(rng, monkeypatch):
    """Batches above EIGH_CHUNK (cuSOLVER refuses 32 768 small matrices on
    the card) go through in chunks, with the same result as one call."""
    A = rng.normal(size=(3, 7, 4, 4)).astype(np.float32)
    S = torch.tensor(A @ A.transpose(0, 1, 3, 2))
    w, v = torch.linalg.eigh(S)
    monkeypatch.setattr(tla, "EIGH_CHUNK", 5)
    wc, vc = tla.eigh(S)
    assert wc.shape == w.shape and vc.shape == v.shape
    np.testing.assert_array_equal(wc.numpy(), w.numpy())
    np.testing.assert_array_equal(vc.numpy(), v.numpy())


def test_eigh_of_a_non_finite_matrix_is_nan_as_in_jax(rng):
    """A degenerate sample's NaN or inf matrix gives NaN eigenvalues and
    vectors, as jnp.linalg.eigh does (the library raises for the whole
    batch); the other matrices are the library's."""
    A = rng.normal(size=(4, 3, 3)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1)
    S[1, 0, 2] = S[1, 2, 0] = np.nan
    S[3] = np.inf
    w, v = tla.eigh(torch.tensor(S))
    wj, vj = jnp.linalg.eigh(jnp.asarray(S))
    for b in (1, 3):
        assert np.isnan(w[b].numpy()).all() and np.isnan(v[b].numpy()).all()
        assert np.isnan(np.asarray(wj[b])).all()
    w0, v0 = torch.linalg.eigh(torch.tensor(S[[0, 2]]))
    np.testing.assert_array_equal(w[[0, 2]].numpy(), w0.numpy())
    np.testing.assert_array_equal(v[[0, 2]].numpy(), v0.numpy())

