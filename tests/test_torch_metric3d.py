"""Metric3Dv2 on the port against the JAX package's, on the CPU.

At tests/test_metric3d.py's TINY config (standard MLP) and TINY with
SwiGLU (the giant2 path), init_random(seed) gives both packages the same
weights, and infer_image's depth, depth variance, normals and normals
variance agree within 1e-4 relative (to each map's largest magnitude) and
valid is equal, with and without the flipped pass. The official names
round-trip through a checkpoint both packages load; the backends
(metric3dv2-small, -fc, metric3dv2-normals) give the JAX backends'
outputs; an official-size checkpoint that does not match its manifest is
refused with convert_checked's diff; without weights the backend raises
MissingWeightsError.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction import priors as jpriors
from mpsfm_tpu.extraction.nets.metric3d import Metric3Dv2 as JMetric3Dv2
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction import priors as tpriors
from mpsfm_tpu_torch.extraction.nets.metric3d import Metric3Dv2

REL = 1e-4
TINY = dict(  # tests/test_metric3d.py:20-25
    encoder="vit_small_reg", dim=32, depth=4, heads=2, mlp="mlp",
    hooks=(0, 1, 2, 3), feature_channels=(8, 12, 16, 16),
    decoder_channels=(8, 8, 12, 16, 16), hidden=8, iters=2,
    crop_size=(112, 112), pos_grid=8,
)
INTR = (100.0, 110.0, 60.0, 45.0)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rgb(hw=(90, 120), seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (*hw, 3)).astype(np.uint8)


def assert_maps_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and y.dtype == x.dtype, k
        if x.dtype == bool:
            np.testing.assert_array_equal(x, y, err_msg=k)
        else:
            assert np.abs(x - y).max() <= REL * max(np.abs(x).max(), 1e-12), k


@pytest.mark.parametrize("mlp", ["mlp", "swiglu"])
@pytest.mark.parametrize("flip", [False, True])
def test_infer_image_equals_jax(mlp, flip):
    c = dict(TINY, mlp=mlp)
    j = JMetric3Dv2(c)
    j.init_random(0)
    t = Metric3Dv2(c, device="cpu")
    t.init_random(0)
    assert_maps_equal(j.infer_image(rgb(), INTR, flip=flip), t.infer_image(rgb(), INTR, flip=flip))


def test_position_embedding_interpolation_equals_jax():
    """A crop of 126×98 (9×7 patches) against the 8×8 pretraining grid: the
    +0.1 bicubic interpolation of the position embedding runs."""
    c = dict(TINY, crop_size=(126, 98))
    j = JMetric3Dv2(c)
    j.init_random(1)
    t = Metric3Dv2(c, device="cpu")
    t.init_random(1)
    assert_maps_equal(j.infer_image(rgb((70, 60), 1), INTR), t.infer_image(rgb((70, 60), 1), INTR))


def test_official_names_round_trip(tmp_path):
    """The JAX params saved under module.depth_model.* (in a
    model_state_dict wrapper) load into both packages to the same arrays;
    a key outside encoder./decoder. is refused."""
    src = JMetric3Dv2(TINY)
    src.init_random(1)
    jp = {k: np.asarray(v) for k, v in src.params.items()}
    ckpt = tmp_path / "metric_depth_vit_small_800k.pth"
    torch.save({"model_state_dict": convert.metric3d_state_dict(jp, "module.depth_model.")}, ckpt)
    t = Metric3Dv2({**TINY, "weights_path": str(ckpt)}, device="cpu")
    j = JMetric3Dv2({**TINY, "weights_path": str(ckpt)})
    assert t.params.keys() == j.params.keys() == jp.keys()
    for k, v in jp.items():
        np.testing.assert_array_equal(t.params[k].numpy(), v)
    assert_maps_equal(j.infer_image(rgb(), INTR), t.infer_image(rgb(), INTR))
    with pytest.raises(ValueError, match="unrecognized checkpoint keys"):
        t.params_from_torch_state_dict({"head.weight": torch.zeros(1)})


def _ckpt(tmp_path, seed, name="metric_depth_vit_small_800k.pth", conf=TINY):
    src = JMetric3Dv2(conf)
    src.init_random(seed)
    path = tmp_path / name
    torch.save(convert.metric3d_state_dict({k: np.asarray(v) for k, v in src.params.items()}, "depth_model."), path)
    return path


@pytest.mark.parametrize("name", ["metric3dv2-small", "metric3dv2-small-fc", "metric3dv2-normals"])
def test_backends_equal_jax(tmp_path, name):
    """The named backends with a checkpoint: the calibrations and presets
    applied, the -fc pass's *2 maps, normals only for metric3dv2-normals."""
    path = _ckpt(tmp_path, 2)
    conf = {**TINY, "weights_path": str(path)}
    jb = jpriors.get_prior_backend(name, dict(conf))
    tb = tpriors.get_prior_backend(name, dict(conf), device="cpu")
    assert isinstance(tb.backend, tpriors._Metric3DBackend)
    assert tb.conf == jb.conf
    image = rgb((48, 64), 3)
    out_j = jb(image, intrinsics=(120.0, 120.0, 32.0, 24.0))
    out_t = tb(image, intrinsics=(120.0, 120.0, 32.0, 24.0))
    assert_maps_equal(out_j, out_t)
    if name == "metric3dv2-normals":
        assert set(out_t) == {"normals", "normals_variance"}
    if name.endswith("-fc"):
        assert {"depth2", "normals2", "valid2"} <= set(out_t)
    # without intrinsics: the wrapper's default focal, 1.2 × the long side
    assert_maps_equal(jb(image), tb(image))


def test_backend_loads_a_registry_name_from_the_weights_dir(tmp_path, monkeypatch):
    """weights_path may be a registry name: its file is found in
    $MPSFM_WEIGHTS_DIR (or ./local/weights) and loaded as by its path; a
    registered file that is nowhere raises MissingWeightsError with its URL
    at the call."""
    wdir = tmp_path / "weights"
    wdir.mkdir()
    path = _ckpt(wdir, 2)
    monkeypatch.setenv("MPSFM_WEIGHTS_DIR", str(wdir))
    by_name = tpriors.get_prior_backend("metric3dv2-small", {**TINY, "weights_path": "metric3dv2-small"},
                                        device="cpu")
    by_path = tpriors.get_prior_backend("metric3dv2-small", {**TINY, "weights_path": str(path)}, device="cpu")
    assert isinstance(by_name.backend, tpriors._Metric3DBackend) and by_name.conf["weights_path"] == str(path)
    assert_maps_equal(by_name(rgb((48, 64), 3)), by_path(rgb((48, 64), 3)))
    monkeypatch.setenv("MPSFM_WEIGHTS_DIR", str(tmp_path / "empty"))
    monkeypatch.chdir(tmp_path)
    missing = tpriors.get_prior_backend("metric3dv2-large", {"weights_path": "metric3dv2-large"}, device="cpu")
    assert missing.backend is None
    url = "https://huggingface.co/JUGGHM/Metric3D/resolve/main/metric_depth_vit_large_800k.pth"
    with pytest.raises(tpriors.MissingWeightsError, match="has no weights") as e:
        missing(rgb())
    assert url in str(e.value)


def test_official_size_checkpoint_is_manifest_checked(tmp_path):
    """At the official small arch a checkpoint missing most keys is refused
    by convert_checked with the manifest's diff."""
    path = tmp_path / "metric_depth_vit_small_800k.pth"
    torch.save({"depth_model.encoder.cls_token": torch.zeros(1, 1, 384)}, path)
    with pytest.raises(ValueError, match="does not match manifest 'metric3dv2-small'.*missing"):
        Metric3Dv2({"encoder": "vit_small_reg", "weights_path": str(path)}, device="cpu")


def test_without_weights_the_backend_raises_missing_weights():
    be = tpriors.get_prior_backend("metric3dv2-large", {})
    assert be.backend is None and be.conf["encoder"] == "vit_large_reg"
    assert be.conf["prior_std_multiplier"] == pytest.approx(3.7757)
    with pytest.raises(tpriors.MissingWeightsError, match="has no weights"):
        be(rgb())
    assert issubclass(tpriors.MissingWeightsError, RuntimeError)


def test_init_random_on_device_is_seeded_and_scaled():
    """on_device draws other numbers from a torch.Generator, at the same
    shapes and scales."""
    a, b = Metric3Dv2(TINY, device="cpu"), Metric3Dv2(TINY, device="cpu")
    pa, pb = a.init_random(3, on_device=True), b.init_random(3, on_device=True)
    ref = Metric3Dv2(TINY, device="cpu").init_random(3)
    assert pa.keys() == ref.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]) and pa[k].shape == ref[k].shape
    w = pa["encoder.blocks.0.attn.qkv.weight"]
    assert abs(float(w.std()) - 32**-0.5) < 0.02
