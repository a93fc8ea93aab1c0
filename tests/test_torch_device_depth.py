"""Depth rows built on the device: the port against the JAX package.

sample_logd must agree to float32 rounding (atol 2e-6; measured max |Δ|
2.4e-7 in log-depth); build_depth_grids' grids and truncation multiplier
to 1e-5 relative (measured ≤ 2.0e-7; d_logt and the multiplier equal).
The MAD fit averages the two middle values
of an even count, as jnp.nanmedian does; the grids drop padded rows
(ptidx ≥ P) and rows the scale filter rejects.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.ba import device_depth as jdd
from mpsfm_tpu_torch.ba import device_depth as tdd

H, W = 40, 56


def test_sample_logd_matches_jax(rng):
    zlog = rng.normal(scale=0.2, size=(H, W)).astype(np.float32) + 1.5
    gx = rng.uniform(-2, W + 2, 300).astype(np.float32)  # past the border: clamped
    gy = rng.uniform(-2, H + 2, 300).astype(np.float32)
    j = np.asarray(jdd.sample_logd(jnp.asarray(zlog), jnp.float32(0.3), jnp.asarray(gx), jnp.asarray(gy)))
    t = tdd.sample_logd(torch.from_numpy(zlog), 0.3, torch.from_numpy(gx), torch.from_numpy(gy)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-6)


def _rows(rng, C, P, Cr, Sd, n_pad):
    """De-duplicated (camera, point) rows; the last n_pad entries of each
    row are padding (ptidx >= P)."""
    cam_rows = rng.choice(C, Cr, replace=False).astype(np.int32)
    ptidx = np.stack([rng.choice(P, Sd, replace=False) for _ in range(Cr)]).astype(np.int32)
    ptidx[:, Sd - n_pad:] = P + rng.integers(0, 3, (Cr, n_pad))
    return cam_rows, ptidx


def _state(rng, C, P):
    q = np.concatenate([np.ones((C, 1)), rng.normal(scale=0.05, size=(C, 3))], 1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(scale=0.1, size=(C, 3))
    xyz = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(4, 9, P)], -1)
    return q.astype(np.float32), t.astype(np.float32), xyz.astype(np.float32)


@pytest.mark.parametrize("compute_trunc,scale_filter", [(True, True), (True, False), (False, True)])
def test_build_depth_grids_matches_jax(rng, compute_trunc, scale_filter):
    C, P, Cr, Sd, n_pad = 6, 80, 4, 25, 4
    cam_rows, ptidx = _rows(rng, C, P, Cr, Sd, n_pad)
    assert (ptidx < P).sum() % 2 == 0  # even count of valid rows: the median averages two
    q, t, xyz = _state(rng, C, P)
    z = np.einsum("rij,rsj->rsi", np.stack([_R(q[c]) for c in cam_rows]), xyz[np.clip(ptidx, 0, P - 1)])[..., 2]
    z = z + t[cam_rows, 2][:, None]
    logd = (np.log(np.clip(z, 1e-3, None)) + rng.normal(scale=0.3, size=z.shape)).astype(np.float32)
    sigma2 = (np.exp(2 * logd) * rng.uniform(0.001, 0.01, z.shape)).astype(np.float32)
    args = (logd, sigma2, ptidx, cam_rows, q, t, xyz)
    scal = (0.8, 1.5, 0.5)
    j = jdd.build_depth_grids(*map(jnp.asarray, args), *map(jnp.float32, scal), C=C, P=P,
                              scale_filter=scale_filter, compute_trunc=compute_trunc)
    tt = tdd.build_depth_grids(*map(torch.from_numpy, args), *scal, C=C, P=P,
                               scale_filter=scale_filter, compute_trunc=compute_trunc)
    names = ("d_logt", "d_w", "d_scale", "trunc")
    for name, a, b in zip(names, tt, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, err_msg=name)
    assert (np.asarray(j[1]) > 0).sum() > 0
    if scale_filter:
        assert (np.asarray(j[1]) > 0).sum() < (ptidx < P).sum()  # the filter dropped some rows


def test_nanmedian_averages_the_middle_pair():
    x = torch.tensor([[1.0, float("nan"), 4.0], [2.0, 10.0, float("nan")]])
    assert float(tdd._nanmedian(x)) == 3.0  # (2 + 4) / 2; torch.nanmedian gives 2
    assert float(jnp.nanmedian(jnp.asarray(x.numpy()))) == 3.0


def _R(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
