"""The framework's own prior net in the port (mpsfm_tpu_torch/extraction/
nets/mono.py) against the JAX package's on the CPU.

MonoViT on the JAX package's Flax init carried across by
convert.mono_state_dict: every output within 1e-4 of its largest value.
ViTMonoBackend through both packages' loaders on one checkpoint (the port's
save_mono_params, the timm-style naming both read), with resize_long
(INTER_AREA in, INTER_LINEAR out) at an integer and a non-integer ratio and
with flip-consistency: every map within 1e-4 of its largest value. The
OpenCV twins (guided_filter.resize_area, resize_linear) against cv2 at
integer and non-integer ratios, up and down. The checkpoint naming's round
trip, the routing of vit_mono* and of unnamed nets with weights, and what
the backend refuses.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction import priors as jpriors
from mpsfm_tpu.extraction.nets.mono import MonoViT as JMonoViT
from mpsfm_tpu.extraction.nets.mono import ViTMonoBackend as JViTMonoBackend
from mpsfm_tpu.extraction.nets.mono import kappa_to_alpha as jkappa_to_alpha
from mpsfm_tpu.extraction.nets.mono import mono_params_from_torch as jmono_params_from_torch
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction import priors as tpriors
from mpsfm_tpu_torch.extraction.guided_filter import resize_area, resize_linear
from mpsfm_tpu_torch.extraction.nets import mono
from mpsfm_tpu_torch.extraction.nets.train_mono import save_mono_params

NET = {"dim": 32, "depth_blocks": 4, "num_heads": 2, "patch": 16, "feat": 16}
REL = 1e-4


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def flax_params():
    return jax.jit(JMonoViT(**NET).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))


@pytest.fixture(scope="module")
def checkpoint(flax_params, tmp_path_factory):
    path = tmp_path_factory.mktemp("mono") / "mono.pth"
    save_mono_params(convert.mono_state_dict(flax_params), path)
    return path


def test_monovit_equals_jax(flax_params):
    net = mono.MonoViT(**NET)
    net.load_state_dict(convert.mono_state_dict(flax_params))
    x = np.random.default_rng(0).uniform(0, 1, (2, 48, 80, 3)).astype(np.float32)
    jo = JMonoViT(**NET).apply(flax_params, jnp.asarray(x))
    with torch.no_grad():
        to = net.eval()(torch.as_tensor(x))
    assert jo.keys() == to.keys()
    for k in jo:
        assert to[k].shape == jo[k].shape and rel_gap(to[k], jo[k]) <= REL, k


@pytest.mark.parametrize("hw,resize_long,flip", [((64, 80), None, False), ((96, 128), 64, True),
                                                 ((100, 130), 64, False)])
def test_backend_equals_jax(checkpoint, hw, resize_long, flip):
    """No resize; an integer ratio (OpenCV's fast area path) with the
    flipped pass; a non-integer ratio (the fractional box)."""
    conf = {**NET, "weights_path": str(checkpoint), "canonical_focal": 100.0, "resize_long": resize_long,
            "flip_consistency": flip}
    rgb = (np.random.default_rng(1).uniform(0, 255, hw + (3,))).astype(np.uint8)
    intr = (90.0, 95.0, hw[1] / 2, hw[0] / 2)
    oj = JViTMonoBackend(conf)(rgb, intrinsics=intr)
    ot = tpriors.get_prior_backend("vit_mono", conf, device="cpu")(rgb, intrinsics=intr)
    assert oj.keys() == ot.keys() and ("depth2" in ot) == flip
    for k in oj:
        assert ot[k].shape == oj[k].shape, k
        if oj[k].dtype == bool:
            np.testing.assert_array_equal(ot[k], oj[k])
        else:
            assert rel_gap(ot[k], oj[k]) <= REL, k


def test_unnamed_net_with_weights_routes_to_the_mono_backend(checkpoint):
    """NeuralDepthBackend routes a name it does not know, given a weights
    file, to ViTMonoBackend (the JAX package's priors.py:156-167)."""
    conf = {**NET, "weights_path": str(checkpoint)}
    tb = tpriors.get_prior_backend("my_prior", conf, device="cpu")
    jb = jpriors.get_prior_backend("my_prior", conf)
    assert isinstance(tb.backend, mono.ViTMonoBackend) and isinstance(jb.backend, JViTMonoBackend)
    rgb = (np.random.default_rng(2).uniform(0, 255, (48, 64, 3))).astype(np.uint8)
    assert rel_gap(tb(rgb)["depth"], jb(rgb)["depth"]) <= REL


@pytest.mark.parametrize("src,dst", [((480, 640), (120, 160)), ((240, 320), (96, 128)), ((37, 51), (20, 17)),
                                     ((30, 40), (45, 70)), ((30, 40), (20, 70))])
@pytest.mark.parametrize("channels", [None, 3])
def test_opencv_twins_equal_cv2(src, dst, channels):
    """INTER_AREA at integer ratios (the fast path), non-integer ones (the
    fractional box), enlargements and a mixed one: within one float32 step
    of cv2; INTER_LINEAR likewise."""
    X = np.random.default_rng(3).uniform(0, 2, src + ((channels,) if channels else ())).astype(np.float32)
    for fn, interp in ((resize_area, cv2.INTER_AREA), (resize_linear, cv2.INTER_LINEAR)):
        ref = cv2.resize(X, dst[::-1], interpolation=interp)
        got = fn(torch.as_tensor(X), dst).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.abs(got - ref).max() <= 2 * np.spacing(np.float32(2.0)), interp


def test_checkpoint_naming_round_trip(flax_params, checkpoint):
    """save_mono_params' timm-style file: the JAX package's converter reads it
    back to the Flax params exactly, the port's to the module's state dict."""
    sd = torch.load(checkpoint)
    assert "trunk.patch_embed.proj.weight" in sd and "trunk.blocks.3.mlp.fc2.bias" in sd
    assert sd["trunk.pos_embed"].shape == (1, 24 * 24, NET["dim"])
    back = jmono_params_from_torch({k: v.numpy() for k, v in sd.items()}, depth=NET["depth_blocks"])
    flat_j = jax.tree_util.tree_leaves_with_path(flax_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))
    net = mono.MonoViT(**NET)
    want = convert.mono_state_dict(flax_params)
    got = mono.load_mono_params(checkpoint, net)
    assert got.keys() == want.keys() == net.state_dict().keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    torch.save(want, checkpoint.parent / "port_names.pth")  # the port's own names load as they are
    got = mono.load_mono_params(checkpoint.parent / "port_names.pth", net)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_kappa_to_alpha_is_the_jax_formula():
    k = np.geomspace(1e-3, 1e3, 50)
    np.testing.assert_array_equal(mono.kappa_to_alpha(k), jkappa_to_alpha(k))


def test_what_the_backend_refuses(tmp_path):
    """Without weights (the default width, no file) calling raises
    MissingWeightsError; a Flax file raises naming the format."""
    be = tpriors.get_prior_backend("vit_mono", device="cpu")
    with pytest.raises(tpriors.MissingWeightsError, match="vit_mono"):
        be(np.zeros((32, 32, 3), np.uint8))
    flax_file = tmp_path / "mono.msgpack"
    flax_file.write_bytes(b"\x80")
    with pytest.raises(ValueError, match="Flax .msgpack"):
        mono.ViTMonoBackend({"weights_path": str(flax_file)}, device="cpu")
