"""DSINE on the port against the JAX package's, on the CPU.

At tests/test_dsine.py's TINY config and a second small config (two-block
stages, a 5×5 stride-2 depthwise stage, a wider head, 3 GRU steps, an image
whose sides pad on both ends), init_random(seed) gives both packages the
same weights, and infer_image's normals agree within 1e-4 absolute and
normals_variance within 1e-4 of its largest value, with and without the
flipped pass. The dsine-kappa-fc backend gives the JAX backend's keys and
maps (normals2 included). The official names round-trip through a
checkpoint both packages load; an official-size checkpoint that does not
match its manifest is refused; without weights the backend raises
MissingWeightsError.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction import priors as jpriors
from mpsfm_tpu.extraction.nets.dsine import DSINE as JDSINE
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction import manifest as tman
from mpsfm_tpu_torch.extraction import priors as tpriors
from mpsfm_tpu_torch.extraction.nets import dsine as tdsine
from mpsfm_tpu_torch.extraction.nets.dsine import DSINE

from test_dsine import TINY

NORMALS_ATOL, VAR_REL = 1e-4, 1e-4
SECOND = dict(
    stages=((1, 8, 2, 1, 3), (6, 12, 2, 2, 5), (6, 16, 1, 2, 3), (6, 20, 1, 2, 5), (6, 24, 1, 2, 3)),
    stem=16, head=40, decoder_nf=24, feature_dim=12, hidden_dim=8, iters=3,
)
CONFIGS = {"tiny": (TINY, (50, 70), (120.0, 130.0, 35.0, 25.0)),
           "second": (SECOND, (83, 101), (90.0, 95.0, 50.5, 41.0))}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rgb(hw, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (*hw, 3)).astype(np.uint8)


def assert_normals_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if k.startswith("normals") and k.endswith("variance"):
            assert np.abs(x - y).max() <= VAR_REL * np.abs(x).max(), k
        else:
            assert np.abs(x - y).max() <= NORMALS_ATOL, k


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("flip", [False, True])
def test_infer_image_equals_jax(name, flip):
    conf, hw, intr = CONFIGS[name]
    j = JDSINE(conf)
    j.init_random(3)
    t = DSINE(conf, device="cpu")
    t.init_random(3)
    got = t.infer_image(rgb(hw), intr, flip=flip)
    assert_normals_equal(j.infer_image(rgb(hw), intr, flip=flip), got)
    np.testing.assert_allclose(np.linalg.norm(got["normals"], axis=-1), 1.0, atol=1e-5)


def test_same_padding_is_bottom_right():
    """A stride-2 depthwise 3×3 conv of an even side pads (0, 1), as XLA's
    'SAME' does; torch's padding=1 would pad (1, 1) and shift the map."""
    import jax
    import jax.numpy as jnp

    from mpsfm_tpu_torch.extraction.nets.depth_anything import _conv

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, 10, 4)).astype(np.float32)
    w = rng.normal(size=(4, 1, 3, 3)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.transpose(jnp.asarray(w), (2, 3, 1, 0)), (2, 2), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=4)
    got = _conv(torch.as_tensor(x), torch.as_tensor(w), stride=2, groups=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    sym = torch.nn.functional.conv2d(torch.as_tensor(x).permute(0, 3, 1, 2), torch.as_tensor(w), stride=2, padding=1,
                                     groups=4).permute(0, 2, 3, 1)
    assert np.abs(sym.numpy() - np.asarray(want)).max() > 1e-2


def test_b5_preset_and_init_random_are_the_manifest():
    """The default config is the TF-EfficientNet-B5 ladder, and its
    init_random names and shapes are the pinned dsine manifest's."""
    assert [s[1] for s in tdsine.efficientnet_stages()] == [24, 40, 64, 128, 176, 304, 512]
    net = DSINE(device="cpu")
    assert net.conf["stem"] == 48 and net.conf["head"] == 2048
    assert tman.manifest_from_params(net.init_random(0)) == tman.load_manifest("dsine")


def write_jax_checkpoint(path, conf, seed, wrap=False):
    j = JDSINE(conf)
    j.init_random(seed)
    sd = convert.dsine_state_dict({k: np.asarray(v) for k, v in j.params.items()})
    torch.save({"model": sd} if wrap else sd, path)
    return j


@pytest.mark.parametrize("wrap", [False, True])
def test_official_names_round_trip(tmp_path, wrap):
    """The JAX package's draw as dsine.pth (bare, or under "model" as the
    official file is): the port loads the same tensors, and the JAX package
    loads the file too."""
    j = write_jax_checkpoint(tmp_path / "dsine.pth", TINY, 5, wrap)
    t = DSINE({**TINY, "weights_path": str(tmp_path / "dsine.pth")}, device="cpu")
    assert t.params.keys() == j.params.keys()
    for k, v in j.params.items():
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(v), err_msg=k)
    j2 = JDSINE({**TINY, "weights_path": str(tmp_path / "dsine.pth")})
    assert j2.params.keys() == j.params.keys()
    with pytest.raises(ValueError, match="unrecognized"):
        t.params_from_torch_state_dict({"head.weight": torch.zeros(1)})


def test_backend_equals_jax(tmp_path):
    """dsine-kappa-fc through NeuralDepthBackend in both packages from one
    checkpoint: the flipped pass's normals2, no depth, the same maps."""
    write_jax_checkpoint(tmp_path / "dsine.pth", SECOND, 7)
    conf = {**SECOND, "weights_path": str(tmp_path / "dsine.pth")}
    jb = jpriors.get_prior_backend("DSINE-kappa-fc", dict(conf))
    tb = tpriors.get_prior_backend("DSINE-kappa-fc", dict(conf), device="cpu")
    assert isinstance(tb.backend, tpriors._DSINEBackend) and tb.backend.flip_consistency
    img, intr = rgb((64, 90), 2), (80.0, 85.0, 44.0, 31.0)
    got = tb(img, intrinsics=intr)
    assert set(got) == {"normals", "normals_variance", "normals2", "normals2_variance"}
    assert_normals_equal(jb(img, intrinsics=intr), got)
    plain = tpriors.get_prior_backend("dsine-kappa", dict(conf), device="cpu")
    assert set(plain(img, intrinsics=intr)) == {"normals", "normals_variance"}
    # without intrinsics both take the wrapper's default focal
    assert_normals_equal(jb(img), tb(img))


def zero_checkpoint(name, drop=(), reshape=None):
    """An official-size state dict of zero-stride zeros from a pinned
    manifest (no memory per element), less `drop`, with `reshape` {key: shape}."""
    return {k: torch.zeros(1).expand(*(reshape or {}).get(k, v)) for k, v in tman.load_manifest(name).items()
            if k not in drop}


def test_official_size_checkpoint_is_checked_against_its_manifest(tmp_path):
    torch.save(zero_checkpoint("dsine"), tmp_path / "ok.pth")
    net = DSINE({"weights_path": str(tmp_path / "ok.pth")}, device="cpu")
    assert len(net.params) == len(tman.load_manifest("dsine"))
    torch.save(zero_checkpoint("dsine", drop=("decoder.gru.convz.weight",)), tmp_path / "short.pth")
    with pytest.raises(ValueError, match="manifest 'dsine'.*decoder.gru.convz.weight"):
        DSINE({"weights_path": str(tmp_path / "short.pth")}, device="cpu")
    bad = zero_checkpoint("dsine", reshape={"encoder.original_model.conv_stem.weight": (48, 3, 5, 5)})
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape mismatch"):
        DSINE({"weights_path": str(tmp_path / "bad.pth")}, device="cpu")


def test_without_weights_the_backend_raises_missing_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("MPSFM_WEIGHTS_DIR", str(tmp_path))
    img = rgb((40, 60))
    for conf in ({}, {"weights_path": str(tmp_path / "none.pth")}, {"weights_path": "dsine"}):
        be = tpriors.get_prior_backend("dsine-kappa-fc", conf, device="cpu")
        assert be.backend is None
        with pytest.raises(tpriors.MissingWeightsError) as e:
            be(img)
        if conf.get("weights_path") == "dsine":  # a registry name: its URL, nothing fetched
            assert "dsine.pth" in str(e.value) and "drive.google.com" in str(e.value)
    assert list(tmp_path.iterdir()) == []
