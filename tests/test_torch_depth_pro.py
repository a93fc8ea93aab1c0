"""DepthPro in the port (mpsfm_tpu_torch/extraction/nets/depth_pro.py)
against the JAX package's on the CPU.

The forward at tests/test_converters_dense.py's tiny conf (3 blocks of 32
wide, a 224² input over 56² patches), on params the port draws
(init_random, a torch.Generator) and carries across to the JAX package as
numpy arrays: inverse depth and field of view within 1e-4 of each
output's largest value (float32's summation order). _DepthProBackend on a
56×70 image with and without intrinsics against the JAX backend on the same
weights, each map within 1e-4 of its largest value, the depth and its
variance as the inverse depth they come from. The full-width parameter list is the pinned manifest key for key
(shapes only; nothing drawn at full width), the torch-unfold patch order
and its inverse, the checkpoint loader (mask tokens dropped) and
MissingWeightsError without weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction import priors as jpriors
from mpsfm_tpu.extraction.nets.depth_pro import DepthPro as JDepthPro
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction import priors as tpriors
from mpsfm_tpu_torch.extraction.manifest import load_manifest
from mpsfm_tpu_torch.extraction.nets.depth_pro import MODEL_CONFIG, DepthPro, param_specs

TINY = {"dim": 32, "depth": 3, "heads": 2, "vit_image_size": 56, "vit_patch": 14, "patch_size": 56, "image_size": 224,
        "scaled_images_feature_dims": (16, 16, 8), "intermediate_hook_ids": (2, 1), "intermediate_feature_dims": (8, 8),
        "fusion_hidden_size": 8, "use_fov_model": True}
REL = 1e-4
# the backend's depth maps held as the net's output, the inverse depth (the variance is (0.0875 d)²)
INVERSE = {"depth": lambda d: 1 / d, "depth_variance": lambda v: 1 / np.sqrt(v)}


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
def nets():
    t = DepthPro(TINY, device="cpu")
    t.init_random(0)
    j = JDepthPro(TINY)
    j.params = {k: jnp.asarray(v.numpy()) for k, v in t.params.items()}
    return t, j


def test_forward_equals_jax(nets):
    t, j = nets
    x = np.random.default_rng(0).normal(size=(2, 224, 224, 3)).astype(np.float32)
    inv_j, fov_j = (np.asarray(a) for a in j._jit_fwd(j.params, jnp.asarray(x)))
    with torch.no_grad():
        inv_t, fov_t = t.forward(torch.as_tensor(x))
    assert inv_t.shape == inv_j.shape == (2, 448, 448) and fov_t.shape == fov_j.shape == (2,)
    assert rel_gap(inv_t, inv_j) <= REL and rel_gap(fov_t, fov_j) <= REL


def test_backend_equals_jax(nets, tmp_path):
    """Through both packages' loaders and backends: a checkpoint of the port's
    draw (HF names, a mask token included, which both drop)."""
    t, _ = nets
    sd = convert.depth_pro_state_dict({k: v.numpy() for k, v in t.params.items()})
    for enc in ("depth_pro.encoder.patch_encoder.model.", "depth_pro.encoder.image_encoder.model.",
                "fov_model.fov_encoder.model."):
        sd[enc + "embeddings.mask_token"] = torch.zeros(1, TINY["dim"])
    # the last layer's bias 1 keeps the inverse depth off its clip (the seeded draw's bias 0 leaves ReLU
    # zeros, depths of 1e4 next to depths of 20), so that the normals from the depth's differences are
    # well-conditioned
    sd["head.layers.4.bias"] = torch.ones(1)
    ckpt = tmp_path / "depth_pro.pt"
    torch.save(sd, ckpt)
    conf = {**TINY, "weights_path": str(ckpt)}
    img = (np.random.default_rng(0).uniform(0, 255, (56, 70, 3))).astype(np.uint8)
    jb = jpriors.NeuralDepthBackend("depthpro", conf)
    tb = tpriors.get_prior_backend("depthpro", conf, device="cpu")
    assert isinstance(tb.backend, tpriors._DepthProBackend) and tb.conf["depth_uncertainty"] == 0.0875
    assert tb.backend.net.params.keys() == t.params.keys()  # the mask tokens dropped
    for intr in ((60.0, 64.0, 35.0, 28.0), None):
        oj, ot = jb(img, intrinsics=intr), tb(img, intrinsics=intr)
        assert oj.keys() == ot.keys() and ot["depth"].shape == (56, 70)
        for k in oj:
            if oj[k].dtype == bool:
                np.testing.assert_array_equal(oj[k], ot[k])
            else:  # depth = 1 / (clipped inverse depth): its relative error grows as 1 / inverse depth
                inv = INVERSE.get(k, lambda a: a)
                assert rel_gap(inv(ot[k]), inv(oj[k])) <= REL, k
    # the FOV head's focal where no intrinsics are given
    jres, tres = jb.backend.net.infer_image(img), tb.backend.net.infer_image(img)
    assert abs(tres["fov_deg"] - jres["fov_deg"]) <= REL * abs(jres["fov_deg"])
    assert abs(tres["f_px"] - jres["f_px"]) <= REL * abs(jres["f_px"])


def test_full_width_specs_are_the_manifest():
    """The official conf's parameter list is the pinned manifest, name for
    name and shape for shape (951.9 M parameters; nothing drawn)."""
    specs = {name: list(shape) for name, shape in param_specs(MODEL_CONFIG)}
    man = load_manifest("depthpro")
    assert specs == man and len(man) == 1410
    assert round(sum(np.prod(s) for s in man.values()) / 1e6, 1) == 951.9


def test_patch_split_and_merge_follow_torch_unfold():
    """_split_to_patches in torch-unfold order (patch index major, the batch
    minor), the JAX package's; _merge_patches its inverse where nothing is
    cropped."""
    x = torch.arange(2 * 8 * 8, dtype=torch.float32).reshape(2, 8, 8, 1)
    p = DepthPro._split_to_patches(x, 4, 0.0)
    ref = x.permute(0, 3, 1, 2).unfold(2, 4, 4).unfold(3, 4, 4)  # (B, C, gi, gj, 4, 4)
    ref = ref.permute(2, 3, 0, 4, 5, 1).reshape(-1, 4, 4, 1)
    assert torch.equal(p, ref)
    jx = jnp.asarray(x.numpy())
    assert np.array_equal(np.asarray(JDepthPro._split_to_patches(jx, 4, 0.0)), p.numpy())
    assert torch.equal(DepthPro._merge_patches(p, 2, 0), x)
    q = DepthPro._split_to_patches(x, 4, 0.5)
    assert q.shape == (9 * 2, 4, 4, 1)
    np.testing.assert_array_equal(DepthPro._merge_patches(q, 2, 1).numpy(),
                                  np.asarray(JDepthPro._merge_patches(jnp.asarray(q.numpy()), 2, 1)))


def test_missing_weights_raise_at_the_official_width():
    with pytest.raises(tpriors.MissingWeightsError, match="depthpro"):
        tpriors.get_prior_backend("depthpro", device="cpu")(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="init_random"):
        DepthPro(TINY, device="cpu").infer_image(np.zeros((8, 8, 3), np.uint8))
