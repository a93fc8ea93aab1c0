"""NetVLAD retrieval on the port against the JAX package's, on the CPU.

init_random(seed) gives both packages the same weights (the same numpy
draws); the descriptors agree within 1e-5 relative, with and without the
resize to resize_max, and with a whitening and a mean carried through
both packages' torch-export converters. The matconvnet .mat loader reads
what the JAX package's reads; the torch export is manifest-checked; the
resize before the net equals OpenCV's INTER_LINEAR (the JAX package's
cv2.resize) on the host that has OpenCV.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mpsfm_tpu.extraction.retrieval import NetVLAD as JNetVLAD
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction.retrieval import _CONV_IDX, NetVLAD

REL = 1e-5


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_gap(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(a)).max())


def image(hw, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (hw[0] // 8 + 1, hw[1] // 8 + 1, 3))
    big = np.kron(base, np.ones((8, 8, 1)))[:hw[0], :hw[1]]
    return np.clip(big + rng.normal(0, 8, big.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("hw,resize_max", [((75, 100), 128), ((150, 200), 96)])
def test_init_random_descriptor_equals_jax(hw, resize_max):
    """resize_max 128 keeps the 75×100 image; 96 resizes 150×200 to 72×96."""
    j = JNetVLAD({"resize_max": resize_max})
    j.init_random(0)
    t = NetVLAD({"resize_max": resize_max}, device="cpu")
    t.init_random(0)
    for name in ("conv0", "conv12"):
        np.testing.assert_array_equal(t.params[name]["w"].numpy(),
                                      np.transpose(np.asarray(j.params[name]["w"]), (3, 2, 0, 1)))
    img = image(hw)
    a, b = j(img), t(img)
    assert b.shape == (64 * 512,) and rel_gap(a, b) <= REL


def test_whitened_descriptor_through_both_converters():
    """A torch-export state dict with a (small) whitening and a mean, through
    each package's params_from_torch_state_dict; and the JAX params carried
    across by convert.netvlad_params."""
    rng = np.random.default_rng(1)
    j = JNetVLAD()
    j.init_random(2, K=8, D=512)
    sd = {}
    for i, ti in enumerate(_CONV_IDX):
        sd[f"backbone.{ti}.weight"] = np.transpose(np.asarray(j.params[f"conv{i}"]["w"]), (3, 2, 0, 1))
        sd[f"backbone.{ti}.bias"] = rng.normal(scale=0.01, size=sd[f"backbone.{ti}.weight"].shape[0])
    sd["netvlad.score_proj.weight"] = np.asarray(j.params["assign_w"])[:, :, None]
    sd["netvlad.centers"] = np.asarray(j.params["centers"]).T
    sd["whiten.weight"] = rng.normal(size=(64, 8 * 512)) / 64
    sd["whiten.bias"] = rng.normal(size=64) * 0.01
    sd["preproc_mean"] = np.array([123.68, 116.779, 103.939])
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    jp = JNetVLAD.params_from_torch_state_dict(sd)
    t = NetVLAD(device="cpu")
    t.params = t._to_device(NetVLAD.params_from_torch_state_dict(sd))
    x = np.random.default_rng(3).uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    ref = np.asarray(j._fwd(jp, jnp.asarray(x)))
    got = t.forward(torch.as_tensor(x)).numpy()
    assert got.shape == (1, 64) and rel_gap(ref, got) <= REL
    t.params = t._to_device(convert.netvlad_params(jax.tree.map(np.asarray, jp)))
    assert rel_gap(ref, t.forward(torch.as_tensor(x)).numpy()) <= REL


def _fake_mat(path, rng):
    """A matconvnet struct in the Pitts30K file's layout (convs at layers
    0..28, NetVLAD at 30, whitening at 33, averageImage), at small widths."""
    import scipy.io as sio

    layers = np.empty(36, dtype=object)
    for i in range(36):
        layers[i] = {"weights": np.empty(0, dtype=object), "name": f"l{i}"}

    def weights(*arrays):
        w = np.empty(len(arrays), dtype=object)
        for i, a in enumerate(arrays):
            w[i] = a.astype(np.float32)
        return w

    c = 3
    for li in _CONV_IDX:
        layers[li] = {"weights": weights(rng.normal(size=(3, 3, c, 4)), rng.normal(size=(4,))), "name": f"c{li}"}
        c = 4
    layers[30] = {"weights": weights(rng.normal(size=(4, 5)), rng.normal(size=(4, 5))), "name": "vlad"}
    layers[33] = {"weights": weights(rng.normal(size=(1, 1, 20, 6)), rng.normal(size=(6, 1))), "name": "wpca"}
    net = {"layers": layers, "meta": {"normalization": {"averageImage": rng.uniform(100, 130, (1, 1, 3))}}}
    sio.savemat(path, {"net": net})


def test_mat_loader_reads_what_the_jax_loader_reads(tmp_path):
    path = tmp_path / "Pitts30K_struct.mat"
    _fake_mat(path, np.random.default_rng(4))
    jp = jax.tree.map(np.asarray, JNetVLAD._load_mat(path))
    t = NetVLAD({"weights_path": str(path)}, device="cpu")
    want = convert.netvlad_params(jp)
    assert sorted(t.params) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            np.testing.assert_array_equal(t.params[k]["w"].numpy(), v["w"])
            np.testing.assert_array_equal(t.params[k]["b"].numpy(), v["b"])
        else:
            np.testing.assert_array_equal(t.params[k].numpy(), v)


def test_torch_export_is_manifest_checked(tmp_path):
    """The export at the official surface (K = 64, D = 512, whitening to
    4096; the whitening a zero-stride tensor, so the file stays small)
    loads; one without its whitening bias is refused with the diff."""
    from mpsfm_tpu_torch.extraction.manifest import load_manifest

    sd = {k: torch.zeros(1).expand(*v) for k, v in load_manifest("netvlad").items()}
    path = tmp_path / "netvlad.pth"
    torch.save(sd, path)
    assert path.stat().st_size < 1 << 20
    t = NetVLAD({"weights_path": str(path)}, device="cpu")
    assert tuple(t.params["whiten_w"].shape) == (4096, 64 * 512) and tuple(t.params["centers"].shape) == (64, 512)
    sd.pop("whiten.bias")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="whiten.bias"):
        NetVLAD({"weights_path": str(path)}, device="cpu")


@pytest.mark.parametrize("hw,resize_max", [((480, 640), 320), ((301, 257), 200)])
def test_resize_equals_opencv(hw, resize_max):
    """prepare's resize is cv2.resize(img, (int(W·s), int(H·s))), as the
    JAX package calls it (INTER_LINEAR on the float image), then the /32 pad."""
    import cv2

    img = image(hw, seed=5)
    t = NetVLAD({"resize_max": resize_max}, device="cpu")
    x = t.prepare(img)[0].numpy()
    f = img.astype(np.float32) / 255.0
    s = resize_max / max(hw)
    ref = cv2.resize(f, (int(hw[1] * s), int(hw[0] * s)))
    h, w = ref.shape[:2]
    assert x.shape == (-(-h // 32) * 32, -(-w // 32) * 32, 3)
    np.testing.assert_allclose(x[:h, :w], ref, atol=1e-6)
    assert not x[h:].any() and not x[:, w:].any()
