"""Depth and Normals priors: the port against the JAX package.

Both are host float64 numpy (scene/priors.py is a copy), so every field is
held to 1e-12 (integer and bool arrays equal): each conf variant of the
uncertainty model, a mask at another resolution, continuity, the
activate → rescale (multiplicative, then with a shift) → reset sequence,
and the device working map (set_data_from_device) read back by the lazy
getter, which takes exp in float64 after the float32 → float64 cast in
both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.scene import priors as jpri
from mpsfm_tpu_torch.scene import priors as tpri

FTOL = 1e-12
H0, W0 = 24, 32  # the maps' resolution
HW = (12, 16)  # the integration grid


def assert_fields(a, b):
    """Every attribute of a JAX package object and its port twin: arrays
    (float within FTOL, others equal), scalars, tuples and None equal;
    the conf and the device map are compared elsewhere."""
    va, vb = vars(a), vars(b)
    assert va.keys() == vb.keys()
    for k, x in va.items():
        y = vb[k]
        if k in ("conf", "_data_dev"):
            continue
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape, k
            if np.issubdtype(x.dtype, np.floating):
                np.testing.assert_allclose(y, x, rtol=0, atol=FTOL, err_msg=k)
            else:
                np.testing.assert_array_equal(y, x, err_msg=k)
        else:
            assert x == y, k


def depth_inputs(rng, hw=(H0, W0)):
    d = 4.0 + rng.uniform(0, 2, hw)
    d[:, hw[1] // 2:] += 3.0  # a discontinuity
    d2 = d * np.exp(rng.normal(scale=0.05, size=hw))
    d[0, 0] = 0.0  # an invalid pixel
    return {
        "depth": d,
        "depth2": d2,
        "depth_variance": (0.05 * d) ** 2 + 1e-4,
        "depth_variance2": (0.04 * d2) ** 2 + 1e-4,
        "valid": rng.uniform(size=hw) > 0.05,
    }


DEPTH_CONFS = {
    "default": {},
    "no_prior_uncertainty": {"prior_uncertainty": False},
    "flip": {"flip_consistency": True, "prior_uncertainty": False},
    "flip_prior_uncertainty": {"flip_consistency": True},
    "fixed": {"fixed_uncertainty": True, "depth_uncertainty": None, "prior_uncertainty": False},
    "flip_no_depth_uncertainty": {"flip_consistency": True, "depth_uncertainty": None},
    "variance_only": {"depth_uncertainty": None},
    "max_std_depth_lim": {"max_std": 0.2, "depth_lim": 6.5, "std_multiplier": 1.5},
    "no_continuity": {"use_continuity": False, "inherent_noise": 0.05},
}


def make_depth(pkg, conf, inputs, kps=None, mask=None):
    d = pkg.Depth(conf, {k: v.copy() for k, v in inputs.items()}, HW, kps=kps, mask=mask)
    d.set_grid_scale(HW[1] / W0, HW[0] / H0)
    return d


@pytest.mark.parametrize("name", sorted(DEPTH_CONFS))
def test_depth_matches_jax(rng, name):
    inputs = depth_inputs(rng)
    kps = rng.uniform([0, 0], [W0, H0], (40, 2))
    mask = rng.uniform(size=(7, 9)) > 0.2  # another resolution: resized by nearest
    a = make_depth(jpri, DEPTH_CONFS[name], inputs, kps, mask)
    b = make_depth(tpri, DEPTH_CONFS[name], inputs, kps, mask)
    assert_fields(a, b)
    assert dict(a.conf) == dict(b.conf)


def test_depth_at_the_grid_resolution(rng):
    """Maps already at the grid's size skip the resize, without kps."""
    inputs = depth_inputs(rng, HW)
    a = jpri.Depth({}, inputs, HW)
    b = tpri.Depth({}, inputs, HW)
    assert_fields(a, b)
    assert b.uncertainty_update is None


def test_depth_sequence_matches_jax(rng):
    """activate → rescale (multiplicative, working map too) → rescale with
    a shift → sampling at keypoints → reset, field by field after each."""
    inputs = depth_inputs(rng)
    kps = rng.uniform([0, 0], [W0, H0], (40, 2))
    a, b = (make_depth(p, {}, inputs, kps) for p in (jpri, tpri))
    steps = [
        lambda d: d.activate(),
        lambda d: d.rescale(0.0, 1.3, rescale_working=True),
        lambda d: d.rescale(0.0, 1.0),  # a no-op
        lambda d: d.rescale(0.2, 1.1, rescale_working=True),
        lambda d: d.rescale(0.0, 0.9),
        lambda d: d.reset(),
        lambda d: d.activate(),
    ]
    for step in steps:
        step(a)
        step(b)
        assert_fields(a, b)
        if a.data is not None:
            for f in ("data_at_kps", "data_prior_at_kps", "uncertainty_at_kps", "valid_at_kps"):
                np.testing.assert_allclose(getattr(b, f)(kps), getattr(a, f)(kps), rtol=0, atol=FTOL, err_msg=f)
    assert (b.version, b.data_epoch) == (a.version, a.data_epoch) and b.version >= 1


def test_depth_device_map_matches_jax(rng):
    """The working map adopted from a device log-depth grid: no host copy
    until read, a multiplicative rescale accumulates the log-shift and
    keeps the epoch, the lazy getter reads exp(z + shift) in float64, and
    the data setter drops the device map."""
    inputs = depth_inputs(rng)
    a, b = (make_depth(p, {}, inputs) for p in (jpri, tpri))
    for d in (a, b):
        d.activate()
    z = np.log(np.clip(a.data_prior, 1e-3, None) * 1.05).astype(np.float32)
    a.set_data_from_device(jnp.asarray(z))
    b.set_data_from_device(torch.as_tensor(z))
    assert a._data is None and b._data is None and b.data_log_dev()[1] == a.data_log_dev()[1] == 0.0
    epoch = b.data_epoch
    for d in (a, b):
        d.rescale(0.0, 1.2, rescale_working=True)
    assert b._data is None and b.data_epoch == epoch == a.data_epoch
    assert b.data_log_dev()[1] == a.data_log_dev()[1] == float(np.log(1.2))
    assert torch.equal(b.data_log_dev()[0], torch.as_tensor(z))
    np.testing.assert_array_equal(b.data, a.data)  # same float64 arithmetic
    assert_fields(a, b)
    for d in (a, b):
        d.data = d.data * 2.0
    assert b._data_dev is None and b.data_log_shift == 0.0 and b.data_epoch == epoch + 1
    assert_fields(a, b)


def normals_inputs(rng, hw=(H0, W0)):
    def unit(shape):
        n = np.stack([rng.normal(scale=0.3, size=shape), rng.normal(scale=0.3, size=shape), -np.ones(shape)], -1)
        return n / np.linalg.norm(n, axis=-1, keepdims=True)

    return {
        "normals": unit(hw),
        "normals2": unit(hw),
        "normals_variance": rng.uniform(1e-4, 1e-3, hw),
        "normals2_variance": rng.uniform(1e-4, 1e-3, hw),
    }


NORMALS_CONFS = {
    "default": ({}, ("normals",)),
    "variance": ({"std_multiplier": 2.0}, ("normals", "normals_variance")),
    "flip": ({"flip_consistency": True}, ("normals", "normals2")),
    "flip_variances": (
        {"flip_consistency": True, "prior_std_multiplier": 1.5, "lc_std_multiplier": 2.0},
        ("normals", "normals2", "normals_variance", "normals2_variance"),
    ),
    "downscale_3": ({"downscale_factor": 3}, ("normals", "normals_variance")),
}


@pytest.mark.parametrize("name", sorted(NORMALS_CONFS))
def test_normals_match_jax(rng, name):
    conf, keys = NORMALS_CONFS[name]
    inputs = normals_inputs(rng)
    nd = {k: inputs[k] for k in keys}
    mask = rng.uniform(size=(5, 7)) > 0.2
    cont = jpri.get_continuity_mask(depth_inputs(rng, HW)["depth"])
    a = jpri.Normals(conf, {k: v.copy() for k, v in nd.items()}, HW, mask=mask, continuity_mask=cont)
    b = tpri.Normals(conf, {k: v.copy() for k, v in nd.items()}, HW, mask=mask, continuity_mask=cont)
    assert_fields(a, b)


def test_helpers_match_jax(rng):
    d = depth_inputs(rng)["depth"] + 0.5
    np.testing.assert_array_equal(tpri.get_continuity_mask(d, 1.1), jpri.get_continuity_mask(d, 1.1))
    n = normals_inputs(rng)
    args = (n["normals"], n["normals2"], 1e-4, n["normals_variance"], n["normals2_variance"], 1.5, 2.0)
    np.testing.assert_allclose(tpri.two_view_normal_covariance(*args), jpri.two_view_normal_covariance(*args),
                               rtol=0, atol=FTOL)
    s = jpri._cart_to_spherical(n["normals"])
    np.testing.assert_allclose(tpri._cart_to_spherical(n["normals"]), s, rtol=0, atol=FTOL)
    np.testing.assert_allclose(tpri._spherical_jacobian(s), jpri._spherical_jacobian(s), rtol=0, atol=FTOL)
