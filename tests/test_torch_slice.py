"""The refinement step as a whole — point covariances, BiNI gate + solve,
the int_covs chain (fresh depth downscaled, diag(H⁻¹) at the keypoints,
updated depth variances), depth rows sampled from the refined maps with
those variances, dense LM-Schur BA — through the JAX package and through
the port (chip_smoke.run_slice, on the CPU), at a small size: B = 2
images of 48×64 (diag(H⁻¹) on 24×32, 64 keypoints each padded to 128
queries), 8 cameras × 256 points, the main path's parameters.

Tolerances: covariances max |Δ| ≤ 1e-3·max |cov| (test_torch_covariance.py), refined log-depth mean
|Δz| < 1e-4, diag(H⁻¹) variances 1e-3 relative, updated depth variances
1e-3 relative, quat/t 1e-4 and xyz 1e-3 absolute, cost 1e-3 relative, the
same accepted count and info4 flags (so the same changed lanes). Gaps
measured on the CPU: see ROADMAP.md queue 3.
"""

import jax.numpy as jnp
import numpy as np

import chip_smoke
from __graft_entry__ import _synthetic_ba_data
from mpsfm_tpu.ba import device_depth as jdd
from mpsfm_tpu.ba.covariance import point_covariances as jcov
from mpsfm_tpu.ba.dense import densify as jdensify
from mpsfm_tpu.ba.dense import solve_ba_dense as jsolve
from mpsfm_tpu.integration import bini as jbini
from mpsfm_tpu.scene import image_priors as jip


def _jax_chain(inputs):
    pr = inputs.priors
    p = jbini.BiniParams(**chip_smoke.MAIN_BINI)
    cov = jcov(_synthetic_ba_data(inputs.C, inputs.P))
    z, info4 = jbini.bini_gate_solve_batch_anchors(
        jnp.asarray(pr.anch), jnp.asarray(pr.prev), p, cov,
        *[(jnp.asarray(a), jnp.asarray(b)) for a, b in pr.pairs],
    )
    B = z.shape[0]
    hw = pr.stat8_ds[0].shape[-2:]
    pairs_ds = [(jbini.resize_log_dev(jbini.take_z(z, jnp.int32(b)), jnp.float32(0.0), hw), jnp.asarray(pr.stat8_ds[b]))
                for b in range(B)]
    flags = jnp.stack([jip._changed_flag_dev(info4, jnp.int32(b)) for b in range(B)])
    varlog = jbini.diag_inverse_gated_batch_anchors(
        jnp.asarray(pr.anch_ds), jnp.asarray(pr.rowcol), p._replace(cg_max_iter=chip_smoke.COV_CG_ITERS), 128,
        cov, flags, *pairs_ds)
    sigma2 = jnp.stack([
        jip._updated_unc_dev(varlog, jnp.int32(b), jnp.asarray(pr.sigma2[b]), jnp.asarray(pr.dprior[b]), info4,
                             jnp.int32(b), jnp.float32(chip_smoke.INT_COV_FLOOR))
        for b in range(B)
    ])
    dense = jdensify(inputs.bundle, inputs.C, inputs.P)
    logd = jnp.stack([
        jdd.sample_logd(z[b], jnp.float32(0.0), jnp.asarray(pr.gx[b]), jnp.asarray(pr.gy[b]))
        for b in range(B)
    ])
    rows = chip_smoke.ROWS
    d_logt, d_w, d_scale, trunc = jdd.build_depth_grids(
        logd, sigma2[:, :pr.Sd], jnp.asarray(pr.ptidx), jnp.asarray(pr.cam_rows),
        dense.quat, dense.t, dense.xyz,
        jnp.float32(rows["m_base"]), jnp.float32(rows["sff"]), jnp.float32(rows["min_trunc"]),
        C=inputs.C, P=inputs.P, scale_filter=rows["scale_filter"], compute_trunc=rows["compute_trunc"],
    )
    dense = dense._replace(d_logt=d_logt, d_w=d_w, d_scale=d_scale)
    quat, t, xyz, info = jsolve(dense, max_iters=chip_smoke.LM_ITERS)
    return dict(cov=np.asarray(cov), z=np.asarray(z), info4=np.asarray(info4), varlog=np.asarray(varlog),
                sigma2=np.asarray(sigma2), quat=np.asarray(quat), t=np.asarray(t),
                xyz=np.asarray(xyz), cost=float(info["cost"]), accepted=int(info["accepted"]),
                trunc=float(trunc))


def test_slice_matches_jax():
    inputs = chip_smoke.make_inputs(**chip_smoke.SMALL)
    j = _jax_chain(inputs)
    t = chip_smoke.run_slice(inputs, "cpu")
    chip_smoke.check_slice(t, inputs)
    np.testing.assert_array_equal(t["info4"].numpy()[:, 2:], j["info4"][:, 2:])
    assert np.abs(t["cov"].numpy() - j["cov"]).max() <= 1e-3 * np.abs(j["cov"]).max()
    assert np.abs(t["z"].numpy() - j["z"]).mean() < 1e-4
    np.testing.assert_allclose(t["varlog"].numpy(), j["varlog"], rtol=1e-3)
    np.testing.assert_allclose(t["sigma2"].numpy(), j["sigma2"], rtol=1e-3)
    np.testing.assert_allclose(float(t["trunc"]), j["trunc"], rtol=1e-4)
    assert t["accepted"] == j["accepted"]
    np.testing.assert_allclose(t["cost"], j["cost"], rtol=1e-3)
    np.testing.assert_allclose(t["quat"].numpy(), j["quat"], atol=1e-4)
    np.testing.assert_allclose(t["t"].numpy(), j["t"], atol=1e-4)
    np.testing.assert_allclose(t["xyz"].numpy(), j["xyz"], atol=1e-3)


def test_synthetic_bundle_is_the_bench_bundle():
    """chip_smoke's numpy copy of the JAX package's bench bundle gives the
    same arrays for the same seed."""
    ref = _synthetic_ba_data(n_cams=8, n_pts=256)
    mine = chip_smoke.synthetic_bundle(8, 256)
    for k, v in vars(mine).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)), err_msg=k)
