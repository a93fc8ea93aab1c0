"""DepthAnythingV2 on the port against the JAX package's, on the CPU.

At two small configs (a metric vits-shaped net whose position embedding
is resized from a 5² grid by DINOv2's bicubic rule with its 0.1 offset, and
a relative one at a second input size and hook set), init_random(seed)
gives both packages the same weights, and infer_image's depth agrees
within 1e-4 of its largest value (the JAX package tests its converters at
1e-4, tests/test_converters_dense.py). HuggingFace names are renamed as the
JAX package renames them; the parameter list at vitl is the pinned
manifest, and an official-size file that does not match it is refused. The
depthanythingv2-outdoor backend gives the JAX backend's maps (metric depth,
its calibrated variance, geometric normals); without weights it raises
MissingWeightsError.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction import priors as jpriors
from mpsfm_tpu.extraction.nets.depth_anything import DepthAnythingV2 as JDA2
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction import manifest as tman
from mpsfm_tpu_torch.extraction import priors as tpriors
from mpsfm_tpu_torch.extraction.nets import depth_anything as tda

from test_torch_dsine import zero_checkpoint

REL = 1e-4
METRIC = dict(encoder="vits", dim=32, depth=4, heads=2, hooks=(0, 1, 2, 3), features=16,
              out_channels=(8, 12, 16, 16), input_size=70, depth_estimation_type="metric", max_depth=20.0)
RELATIVE = dict(encoder="vitb", dim=24, depth=5, heads=3, hooks=(0, 2, 3, 4), features=12,
                out_channels=(6, 8, 10, 12), input_size=84, depth_estimation_type="relative")
CONFIGS = {"metric": (METRIC, (60, 80)), "relative": (RELATIVE, (90, 61))}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rgb(hw, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (*hw, 3)).astype(np.uint8)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_infer_image_equals_jax(name):
    """The same init_random(1) arrays; the depth at the input's resolution
    within REL of its largest value (the short side to input_size, both
    sides to multiples of 14, the forward, the depth resized back)."""
    conf, hw = CONFIGS[name]
    j = JDA2(conf)
    j.init_random(1)
    t = tda.DepthAnythingV2(conf, device="cpu")
    t.init_random(1)
    assert j.params.keys() == t.params.keys() == {n for n, _, _, _ in tda.param_specs(t.conf)}
    for k, v in j.params.items():
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(v), err_msg=k)
    img = rgb(hw, 2)
    want, got = j.infer_image(img), t.infer_image(img)
    assert got.shape == hw and np.isfinite(got).all()
    assert np.abs(got - want).max() <= REL * np.abs(want).max(), (np.abs(got - want).max(), np.abs(want).max())
    if conf["depth_estimation_type"] == "metric":
        assert (got > 0).all() and (got < conf["max_depth"]).all()


def hf_state_dict(params, depth):
    """The official names renamed back to HuggingFace's
    DepthAnythingForDepthEstimation (qkv split into query/key/value, the
    fusion stages reversed)."""
    sd = {}
    for k, v in params.items():
        v = np.asarray(v)
        if k == "pretrained.cls_token":
            sd["backbone.embeddings.cls_token"] = v
        elif k == "pretrained.pos_embed":
            sd["backbone.embeddings.position_embeddings"] = v
        elif k.startswith("pretrained.patch_embed.proj."):
            sd["backbone.embeddings.patch_embeddings.projection." + k.split(".")[-1]] = v
        elif k.startswith("pretrained.norm."):
            sd["backbone.layernorm." + k.split(".")[-1]] = v
        elif k.startswith("pretrained.blocks."):
            i, rest = k.split(".")[2], ".".join(k.split(".")[3:])
            b = f"backbone.encoder.layer.{i}."
            if rest.startswith("attn.qkv."):
                for part, x in zip(("query", "key", "value"), np.split(v, 3, axis=0)):
                    sd[b + f"attention.attention.{part}.{rest.split('.')[-1]}"] = x
            else:
                m = {"attn.proj.weight": "attention.output.dense.weight", "attn.proj.bias": "attention.output.dense.bias",
                     "ls1.gamma": "layer_scale1.lambda1", "ls2.gamma": "layer_scale2.lambda1"}
                sd[b + m.get(rest, rest)] = v
        elif k.startswith("depth_head.projects."):
            sd[f"neck.reassemble_stage.layers.{k.split('.')[2]}.projection.{k.split('.')[-1]}"] = v
        elif k.startswith("depth_head.resize_layers."):
            sd[f"neck.reassemble_stage.layers.{k.split('.')[2]}.resize.{k.split('.')[-1]}"] = v
        elif k.startswith("depth_head.scratch.layer"):
            sd[f"neck.convs.{int(k.split('.')[2][5]) - 1}.weight"] = v
        elif k.startswith("depth_head.scratch.refinenet"):
            parts = k.split(".")
            i = 4 - int(parts[2][len("refinenet"):])
            if parts[3] == "out_conv":
                sd[f"neck.fusion_stage.layers.{i}.projection.{parts[-1]}"] = v
            else:
                unit = {"resConfUnit1": "residual_layer1", "resConfUnit2": "residual_layer2"}[parts[3]]
                conv = {"conv1": "convolution1", "conv2": "convolution2"}[parts[4]]
                sd[f"neck.fusion_stage.layers.{i}.{unit}.{conv}.{parts[-1]}"] = v
        elif k.startswith("depth_head.scratch.output_conv1."):
            sd["head.conv1." + k.split(".")[-1]] = v
        elif k.startswith("depth_head.scratch.output_conv2.0."):
            sd["head.conv2." + k.split(".")[-1]] = v
        elif k.startswith("depth_head.scratch.output_conv2.2."):
            sd["head.conv3." + k.split(".")[-1]] = v
    return sd


def test_hf_names_rename_as_the_jax_package_renames_them(tmp_path):
    j = JDA2(METRIC)
    j.init_random(3)
    hf = hf_state_dict(j.params, METRIC["depth"])
    got = tda.DepthAnythingV2._rename_hf(hf)
    want = JDA2._rename_hf(hf)
    assert got.keys() == want.keys() == j.params.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], np.asarray(j.params[k]), err_msg=k)
    torch.save({k: torch.tensor(v) for k, v in hf.items()}, tmp_path / "hf.pth")
    t = tda.DepthAnythingV2({**METRIC, "weights_path": str(tmp_path / "hf.pth")}, device="cpu")
    assert t.params.keys() == j.params.keys()


def test_official_names_and_manifest(tmp_path):
    """vitl's parameter list is the pinned manifest; an official-size file
    (with the unused mask token) loads manifest-checked, one short of a key
    raises naming it."""
    net = tda.DepthAnythingV2({}, device="cpu")
    assert {n: list(s) for n, s, _, _ in tda.param_specs(net.conf)} == tman.load_manifest("depthanythingv2-vitl")
    sd = dict(zero_checkpoint("depthanythingv2-vitl"), **{"pretrained.mask_token": torch.zeros(1, 1024)})
    torch.save(sd, tmp_path / "ok.pth")
    t = tda.DepthAnythingV2({"weights_path": str(tmp_path / "ok.pth")}, device="cpu")
    assert len(t.params) == len(tman.load_manifest("depthanythingv2-vitl"))
    torch.save(zero_checkpoint("depthanythingv2-vitl", drop=("depth_head.projects.2.bias",)), tmp_path / "short.pth")
    with pytest.raises(ValueError, match="manifest 'depthanythingv2-vitl'.*depth_head.projects.2.bias"):
        tda.DepthAnythingV2({"weights_path": str(tmp_path / "short.pth")}, device="cpu")


def test_backend_equals_jax(tmp_path):
    """depthanythingv2-outdoor on a checkpoint of the JAX package's draw
    (METRIC, max_depth from the conf): depth, variance, valid, normals and
    their variance as the JAX backend's; without weights both raise, the
    port MissingWeightsError."""
    j = JDA2(METRIC)
    j.init_random(4)
    torch.save(convert.depth_anything_state_dict({k: np.asarray(v) for k, v in j.params.items()}),
               tmp_path / "da2.pth")
    conf = {**METRIC, "weights_path": str(tmp_path / "da2.pth")}
    jb = jpriors.get_prior_backend("depthanythingv2-outdoor", conf)
    tb = tpriors.get_prior_backend("depthanythingv2-outdoor", conf, device="cpu")
    assert isinstance(tb.backend, tpriors._DA2Backend) and tb.backend.net.conf["max_depth"] == 20.0
    img, intr = rgb((56, 75), 5), (80.0, 82.0, 37.0, 28.5)
    want, got = jb(img, intrinsics=intr), tb(img, intrinsics=intr)
    assert got.keys() == want.keys() == {"depth", "depth_variance", "valid", "normals", "normals_variance"}
    for k in want:
        x, y = np.asarray(want[k]), np.asarray(got[k])
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if x.dtype == bool:
            np.testing.assert_array_equal(x, y)
        elif k == "normals":  # unit vectors of the depth's central differences
            assert np.abs(x - y).max() <= 1e-3, k
        else:
            assert np.abs(x - y).max() <= REL * np.abs(x).max(), k
    with pytest.raises(tpriors.MissingWeightsError, match="has no weights"):
        tpriors.get_prior_backend("depthanythingv2-outdoor", {}, device="cpu")(img)
