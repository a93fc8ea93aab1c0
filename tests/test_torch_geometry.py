"""Rotations, robust losses and LM helpers: the port against the JAX package.

Same float32 inputs from a seed; the two differ only by rounding
(atol 1e-6 on unit-scale values, rtol 1e-6 on the losses).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.ba import losses as jl
from mpsfm_tpu.ba import solver as js
from mpsfm_tpu.geometry import rotations as jr
from mpsfm_tpu_torch.ba import losses as tl
from mpsfm_tpu_torch.ba import solver as ts
from mpsfm_tpu_torch.geometry import rotations as tr


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
