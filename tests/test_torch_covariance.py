"""Point covariances: the PyTorch port against the JAX package on the CPU.

Both packages get the JAX package's bench bundle (__graft_entry__.
_synthetic_ba_data, 8 cameras × 256 points) as numpy arrays. On the CPU
the port's reduced solve with 3P right-hand sides runs K1's plain version
(ba/cholesky.cholesky_solve_plain); the JAX package runs XLA's cho_factor
and cho_solve.

Tolerances: covariances max |Δ| ≤ COV_REL·max |cov|. The reduced system
is ill-conditioned (κ(S) ≈ 7e7 on this bundle, with S = Hcc − S_red formed
with cancellation): perturbing S by one float32 ulp (1e-7 relative) moves
the covariances by 1.5e-4 of max |cov|, and a float64 solve of the same
float32 S differs from K1's plain version by 2.0e-4. Measured on the CPU
against the JAX package: 7.2e-5 (gather and scatter paths alike); on an
H100, card vs CPU: 7.2e-4. The pieces of the assembly (J_r, w_r, cost)
1e-5 relative. Against the explicit dense H⁻¹ on 3 cameras × 6 points the
port is held to the JAX package's own bound (tests/test_ba.py: rtol 0.08,
atol 5e-4).
"""

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_ba_data
from mpsfm_tpu.ba import losses as jlosses
from mpsfm_tpu.ba.covariance import point_covariances as jcov
from mpsfm_tpu.ba.problem import build_ba_data
from mpsfm_tpu.ba.solver import _assemble as jassemble
from mpsfm_tpu.ba.solver import make_pc_tables as jpc
from mpsfm_tpu.ba.solver import make_slot_tables as jslots
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.ba import losses
from mpsfm_tpu_torch.ba.covariance import point_covariances
from mpsfm_tpu_torch.ba.solver import BAData, _assemble, make_pc_tables, make_slot_tables

from test_ba import make_synthetic_rec

PC_FIELDS = ("pc_r_slot", "pc_r_mask", "pc_d_slot", "pc_d_mask")
COV_REL = 1e-3  # vs the JAX package on the CPU
CARD_COV_REL = 2e-3  # card vs CPU (chip_smoke.py's COV_REL)


def _arrays(data):
    return {k: None if v is None else np.asarray(v) for k, v in data._asdict().items()}


@pytest.mark.parametrize("path", ["gather", "scatter"])
def test_point_covariances_match_jax(path):
    """With the per-(point, camera) tables T is a gather; without them a
    scatter-add (index_put_ with accumulate on the port's side)."""
    data = _synthetic_ba_data(8, 256)
    if path == "scatter":
        data = data._replace(**{k: None for k in PC_FIELDS})
    t = convert.ba_data(_arrays(data), device="cpu")
    assert (t.pc_r_slot is None) == (path == "scatter")
    cov = point_covariances(t).numpy()
    ref = np.asarray(jcov(data))
    assert cov.shape == ref.shape == (256, 3, 3)
    assert np.abs(cov - ref).max() <= COV_REL * np.abs(ref).max()


def test_assemble_matches_jax():
    data = _synthetic_ba_data(4, 64)
    t = convert.ba_data(_arrays(data), device="cpu")
    for loss in (losses.TRIVIAL, losses.CAUCHY):
        a = _assemble(t, t.quat, t.t, t.xyz, loss, loss)
        j = jassemble(data, data.quat, data.t, data.xyz, loss, loss)
        for k in ("J_r", "r_res", "w_r", "J_d", "d_res", "w_d"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(j[k]), rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(a["cost"]), float(j["cost"]), rtol=1e-5)
    assert jlosses.CAUCHY == losses.CAUCHY


def test_table_builders_match_jax(rng):
    ids = rng.integers(0, 40, 300)
    for got, ref in zip(make_slot_tables(ids, 40), jslots(ids, 40)):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(make_slot_tables(ids, 40, pad_width=16), jslots(ids, 40, pad_width=16)):
        np.testing.assert_array_equal(got, ref)
    pts = np.tile(np.arange(30), 4)
    valid = (rng.random(120) > 0.2).astype(np.float32)
    for got, ref in zip(make_pc_tables(pts, valid, 30, 4, 30), jpc(pts, valid, 30, 4, 30)):
        np.testing.assert_array_equal(got, ref)
    assert make_pc_tables(np.zeros(4, int), np.ones(4), 1, 2, 2) == (None, None)  # a point twice in a camera


def test_ba_data_converts_types():
    data = _synthetic_ba_data(2, 16)
    t = convert.ba_data(_arrays(data), device="cpu")
    assert t.r_cam.dtype == t.r_pt.dtype == t.pc_r_slot.dtype == torch.int64
    assert t.xyz.dtype == t.pc_r_mask.dtype == torch.float32
    assert set(BAData._fields) == set(data._fields) - {"bs"}
    with pytest.raises(ValueError, match="not ported"):
        convert.ba_data({**_arrays(data), "bs": np.zeros(1)}, device="cpu")


def test_point_covariance_matches_dense_inverse(rng):
    """cov_p from the Schur identity == the point block of the dense H⁻¹
    built explicitly from the port's own Jacobians (tiny problem; the
    port of tests/test_ba.py::test_point_covariance_matches_dense_inverse)."""
    rec, _ = make_synthetic_rec(rng, n_cams=3, n_pts=6, noise_px=0.5, pose_noise=0.0)
    bundle = {"optim_ids": {0, 1, 2}, "pts3D": set(rec.point_ids().tolist()), "constpoints": set()}
    d = convert.ba_data(_arrays(build_ba_data(rec, bundle, mode="global", use_depth=False).data), device="cpu")
    cov = point_covariances(d).numpy()

    asm = _assemble(d, d.quat, d.t, d.xyz, losses.TRIVIAL, losses.TRIVIAL)
    J_r = asm["J_r"].double().numpy()  # (2,9,No)
    w = asm["w_r"].double().numpy()
    C, P = d.quat.shape[0], d.xyz.shape[0]
    r_cam, r_pt = d.r_cam.numpy(), d.r_pt.numpy()
    n_dof = 6 * C + 3 * P
    H = np.zeros((n_dof, n_dof))
    for n in range(w.shape[0]):
        Jn = np.zeros((2, n_dof))
        Jn[:, 6 * r_cam[n]:6 * r_cam[n] + 6] = J_r[:, :6, n]
        Jn[:, 6 * C + 3 * r_pt[n]:6 * C + 3 * r_pt[n] + 3] = J_r[:, 6:, n]
        H += w[n] * Jn.T @ Jn
    dof, pv = d.cam_dof.double().numpy(), d.point_var.double().numpy()
    H[np.arange(6 * C), np.arange(6 * C)] += (1.0 - dof.reshape(-1)) + 1e-6  # as point_covariances regularises
    H[6 * C + np.arange(3 * P), 6 * C + np.arange(3 * P)] += np.repeat(1.0 - pv, 3) + 1e-6
    Hinv = np.linalg.inv(H)
    for p in range(6):  # the real points
        blk = Hinv[6 * C + 3 * p:6 * C + 3 * p + 3, 6 * C + 3 * p:6 * C + 3 * p + 3]
        np.testing.assert_allclose(cov[p], blk, rtol=0.08, atol=5e-4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_point_covariances_on_card(cuda):
    """The covariances on the card (K1 with many right-hand sides) against
    the CPU's (its plain version)."""
    from mpsfm_tpu_torch.ba import cholesky

    arrays = _arrays(_synthetic_ba_data(8, 256))
    n0 = cholesky.KERNEL_MANY.launches
    cov = point_covariances(convert.ba_data(arrays, device=cuda))
    torch.cuda.synchronize()
    assert cholesky.KERNEL_MANY.launches == n0 + 1
    ref = point_covariances(convert.ba_data(arrays, device="cpu"))
    assert float((cov.cpu() - ref).abs().max()) <= CARD_COV_REL * float(ref.abs().max())


@pytest.mark.cuda
def test_point_covariances_scatter_path_on_card(cuda):
    """Without the per-(point, camera) tables T is a scatter-add
    (index_put_ with accumulate, whose atomics add in no fixed order on the
    card); card against CPU."""
    arrays = _arrays(_synthetic_ba_data(8, 256)._replace(**{k: None for k in PC_FIELDS}))
    data = convert.ba_data(arrays, device=cuda)
    assert data.pc_r_slot is None
    cov = point_covariances(data)
    torch.cuda.synchronize()
    ref = point_covariances(convert.ba_data(arrays, device="cpu"))
    assert bool(torch.isfinite(cov).all())
    assert float((cov.cpu() - ref).abs().max()) <= CARD_COV_REL * float(ref.abs().max())
