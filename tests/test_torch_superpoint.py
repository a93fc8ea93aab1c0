"""SuperPoint on the port against the JAX package's, on the CPU.

The JAX net's flax params are carried across as the magicleap state dict
(convert.superpoint_state_dict) and loaded with load_state_dict; the
net's score and descriptor maps agree within 1e-4, and the detections
(keypoints as sets, at least 99% common: top_k may order ties its own
way; scores and descriptors of common keypoints within 1e-4) at 96×128
and 240×320. simple_nms is equal; a superpoint_v1.pth that matches the
manifest loads, one that does not is refused with the diff.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mpsfm_tpu.extraction.features import superpoint as jsp
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction.features import superpoint as tsp

TOL, COMMON = 1e-4, 0.99
SIZES = {"96x128": ((96, 128), 200), "240x320": ((240, 320), 800)}  # the top-k cut binds at both


@pytest.fixture(scope="module")
def pair():
    j = jsp.SuperPoint({"max_keypoints": 500})
    j.init_random(0)
    t = tsp.SuperPoint({"max_keypoints": 500}, device="cpu")
    t.load_state_dict(convert.superpoint_state_dict(jax.tree.map(np.asarray, j.params)))
    return j, t


def image(hw, seed=0):
    """A smooth random texture (uniform noise blurred) in [0, 1]."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (1, 1, hw[0] // 4, hw[1] // 4)), dtype=torch.float32)
    x = torch.nn.functional.interpolate(x, size=hw, mode="bilinear", align_corners=False)[0, 0]
    return (0.7 * x.numpy() + 0.3 * rng.uniform(0, 1, hw)).astype(np.float32)


@pytest.mark.parametrize("size", list(SIZES))
def test_net_maps_equal_jax(pair, size):
    j, t = pair
    img = image(SIZES[size][0])
    s_j, d_j = j._fwd(j.params, jnp.asarray(img)[None, :, :, None])
    with torch.no_grad():
        s_t, d_t = t.net(torch.as_tensor(img)[None, None])
    assert s_t.shape == s_j.shape and d_t.shape == d_j.shape
    assert np.abs(np.asarray(s_j) - s_t.numpy()).max() <= TOL
    assert np.abs(np.asarray(d_j) - d_t.numpy()).max() <= TOL


@pytest.mark.parametrize("size", list(SIZES))
def test_detections_equal_jax(pair, size):
    j, t = pair
    hw, kmax = SIZES[size]
    j.conf["max_keypoints"] = t.conf["max_keypoints"] = kmax
    img = image(hw, seed=1)
    oj, ot = j(img), t(img)
    assert len(ot["keypoints"]) > 0.5 * kmax
    kj = {tuple(k): i for i, k in enumerate(oj["keypoints"].tolist())}
    common = [(kj[tuple(k)], i) for i, k in enumerate(ot["keypoints"].tolist()) if tuple(k) in kj]
    assert len(common) >= COMMON * max(len(oj["keypoints"]), len(ot["keypoints"]))
    a, b = np.array(common).T
    assert np.abs(oj["scores"][a] - ot["scores"][b]).max() <= TOL
    assert np.abs(oj["descriptors"][a] - ot["descriptors"][b]).max() <= TOL


def test_simple_nms_equal_jax():
    rng = np.random.default_rng(3)
    heat = rng.uniform(0, 1, (2, 64, 80)).astype(np.float32)
    heat[0, 10:14, 10:14] = 2.0  # a plateau
    heat[1] = np.round(heat[1] * 8) / 8  # many ties
    for r in (1, 4):
        np.testing.assert_array_equal(tsp.simple_nms(torch.as_tensor(heat), r).numpy(),
                                      np.asarray(jsp.simple_nms(jnp.asarray(heat), r)))


def test_batch_equals_single_images(pair):
    """batch_fn on three images of one shape (one not a multiple of 8)
    equals the images one by one."""
    _, t = pair
    t.conf["max_keypoints"] = 300
    imgs = [image((100, 130), seed=s) for s in range(3)]
    batched = t.batch(imgs)
    for img, out in zip(imgs, batched):
        one = t(img)
        for k in ("keypoints", "scores", "descriptors"):
            np.testing.assert_allclose(out[k], one[k], atol=1e-6)
        assert (out["keypoints"][:, 0] < 130).all() and (out["keypoints"][:, 1] < 100).all()


def test_checkpoint_loads_with_the_manifest_and_refuses_a_mismatch(pair, tmp_path):
    j, carried = pair
    sd = convert.superpoint_state_dict(jax.tree.map(np.asarray, j.params))
    good = tmp_path / "superpoint_v1.pth"
    torch.save(sd, good)
    t = tsp.SuperPoint({"weights_path": str(good), "max_keypoints": 200}, device="cpu")
    assert t.net is not None and t.net.conv1a.weight.device.type == "cpu"
    img = image((96, 128), seed=2)
    carried.conf["max_keypoints"] = 200
    np.testing.assert_array_equal(t(img)["keypoints"], carried(img)["keypoints"])
    sd.pop("convPb.bias")
    sd["conv1a.weight"] = torch.zeros(64, 3, 3, 3)
    bad = tmp_path / "superpoint_bad.pth"
    torch.save(sd, bad)
    with pytest.raises(ValueError, match=r"missing 1 keys, e.g. \['convPb.bias'\].*shape mismatch"):
        tsp.SuperPoint({"weights_path": str(bad)}, device="cpu")


def test_init_random_is_seeded():
    a, b, c = (tsp.SuperPoint(device="cpu") for _ in range(3))
    a.init_random(5)
    b.init_random(5)
    c.init_random(6)
    assert torch.equal(a.net.convDb.weight, b.net.convDb.weight)
    assert not torch.equal(a.net.convDb.weight, c.net.convDb.weight)
