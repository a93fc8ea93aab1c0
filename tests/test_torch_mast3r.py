"""MASt3R on the port against the JAX package's, on the CPU.

At tests/test_mast3r.py's TINY config and a second small config (head
width 64, an odd patch grid, a 2-block decoder), init_random(seed) gives
both packages the same weights, and the forward's pointmaps, confidences,
descriptors and descriptor confidences agree within 1e-4 of each output's
largest magnitude (the JAX package's own bound against its torch twin,
tests/test_mast3r.py, is 2e-4 absolute). CroCo's RoPE2D tables and their
application agree within 1e-6. Mast3rMatcher's keypoints equal the JAX
matcher's as sets (certainties within 1e-5), its pair depth within 1e-4
relative, its descriptor samples within 1e-5. The official names: the
parameter list at the official size is the pinned manifest, checkpoints in
the naver wrapper format load in both packages, an official-size file that
does not match the manifest is refused, and without weights at the
official width the matcher raises MissingWeightsError naming the file.
Extraction.extract_pair_depths writes MASt3R's pair depth for images
without sensor depth (the twin of tests/test_mast3r.py's
test_extract_pair_depths_uses_matcher_pointmap), equal to the JAX
package's store.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mpsfm_tpu.extraction.base import Extraction as JExtraction
from mpsfm_tpu.extraction.nets.mast3r import Mast3rMatcher as JMatcher
from mpsfm_tpu.extraction.nets.mast3r import Mast3rNet as JNet
from mpsfm_tpu.extraction.nets.mast3r import apply_rope as japply_rope
from mpsfm_tpu.extraction.nets.mast3r import rope_tables as jrope_tables
from mpsfm_tpu.utils import io as jio
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction import manifest as tman
from mpsfm_tpu_torch.extraction.base import Extraction as TExtraction
from mpsfm_tpu_torch.extraction.base import get_dense_matcher
from mpsfm_tpu_torch.extraction.nets import mast3r as tm
from mpsfm_tpu_torch.extraction.priors import MissingWeightsError
from mpsfm_tpu_torch.utils import io as tio

from test_mast3r import TINY
from test_torch_dsine import zero_checkpoint

REL = 1e-4
SECOND = dict(
    enc_dim=64, enc_depth=2, enc_heads=1,
    dec_dim=32, dec_depth=2, dec_heads=2,
    patch=16, desc_dim=5, rope_freq=100.0,
    dpt_layer_dims=(6, 8, 10, 12), dpt_feature_dim=8,
    mlp_hidden_factor=2.0,
)
CONFIGS = {"tiny": (TINY, (48, 64)), "second": (SECOND, (80, 112))}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nets(conf, seed):
    j = JNet(conf)
    j.init_random(seed)
    t = tm.Mast3rNet(conf, device="cpu")
    t.init_random(seed)
    return j, t


@pytest.mark.parametrize("h,w,hd", [(3, 4, 16), (5, 7, 64), (4, 4, 12)])
def test_rope_tables_and_apply_rope_equal_jax(h, w, hd):
    cj, sj = jrope_tables(h, w, hd)
    ct, st = tm.rope_tables(h, w, hd)
    assert ct.shape == (2, h * w, hd // 2) and ct.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    t = np.random.default_rng(hd).normal(size=(2, h * w, 3, hd)).astype(np.float32)
    want = np.asarray(japply_rope(jnp.asarray(t), cj, sj))
    assert np.abs(tm.apply_rope(torch.as_tensor(t), ct, st).numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_equals_jax(name):
    """Both packages' init_random(1) draws are the same arrays; the forward
    on a seeded pair within REL of each output's largest magnitude."""
    conf, (H, W) = CONFIGS[name]
    j, t = nets(conf, 1)
    assert j.params.keys() == t.params.keys()
    for k, v in j.params.items():
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(v), err_msg=k)
    rng = np.random.default_rng(2)
    xa, xb = (rng.normal(size=(1, H, W, 3)).astype(np.float32) for _ in range(2))
    hw = (H // 16, W // 16)
    want = j._jit_fwd(j.params, jnp.asarray(xa), jnp.asarray(xb), hw)
    with torch.no_grad():
        got = t.forward(torch.as_tensor(xa), torch.as_tensor(xb), hw)
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        assert np.abs(a - b).max() <= REL * np.abs(a).max(), (k, np.abs(a - b).max(), np.abs(a).max())


def images(seed, hw=(48, 64)):
    rng = np.random.default_rng(seed)
    return [(rng.random((*hw, 3)) * 255).astype(np.uint8) for _ in range(2)]


def assert_same_sets(a, b):
    """Keypoints of both images exactly as sets of pairs, certainties within 1e-5."""
    assert len(a["certainty"]) == len(b["certainty"]) > 0
    ka, kb = (np.concatenate([m["keypoints0"], m["keypoints1"]], 1) for m in (a, b))
    ia, ib = np.lexsort(ka.T[::-1]), np.lexsort(kb.T[::-1])
    np.testing.assert_array_equal(ka[ia], kb[ib])
    assert np.abs(a["certainty"][ia] - b["certainty"][ib]).max() <= 1e-5


def write_checkpoint(path, conf, seed):
    j = JNet(conf)
    j.init_random(seed)
    torch.save({"model": convert.mast3r_state_dict({k: np.asarray(v) for k, v in j.params.items()})}, path)
    return j


@pytest.mark.parametrize("over", [{"stride": 4}, {"stride": 2, "max_matches": 20, "certainty_threshold": 0.5}])
def test_matcher_equals_jax_as_sets(tmp_path, over):
    """get_dense_matcher("mast3r") on a checkpoint in the naver wrapper
    format, on a uint8 pair of different sizes (padded to one) and on the
    gray [0, 1] pair Extraction hands it; at stride 2 the certainty
    threshold and the max_matches cut bind. The pair depth and descriptor
    samples as the JAX matcher's."""
    write_checkpoint(tmp_path / "m.pth", TINY, 2)
    conf = {**TINY, "weights_path": str(tmp_path / "m.pth"), **over}
    jm, m = JMatcher(conf), get_dense_matcher("mast3r", conf, device="cpu")
    assert isinstance(m, tm.Mast3rMatcher)
    a, b = images(0)
    pair = (a, b[:40, :56])
    for imgs in (pair, [im.mean(-1).astype(np.float32) / 255 for im in images(1, (50, 70))]):
        assert_same_sets(jm(*imgs), m(*imgs))
    if "max_matches" in over:
        uncut = tm.Mast3rMatcher({**conf, "max_matches": 10 ** 6}, device="cpu")(*pair)
        assert len(m(*pair)["certainty"]) == over["max_matches"] < len(uncut["certainty"])
    pj, pt = jm.pair_depth(*pair), m.pair_depth(*pair)
    for key, sh in (("0", (48, 64)), ("1", (40, 56))):
        assert pt[key]["depth"].shape == sh and pt[key]["depth"].dtype == np.float64
        np.testing.assert_array_equal(pt[key]["valid"], pj[key]["valid"])
        for f in ("depth", "variance"):
            assert np.abs(pt[key][f] - pj[key][f]).max() <= REL * np.abs(pj[key][f]).max(), (key, f)
    kps = np.array([[10.0, 12.0], [30.5, 20.25], [0.0, 47.0]])
    dj = jm.descriptors_at(jm._forward(*pair)[0], kps, 1)
    dt = m.descriptors_at(m._forward(*pair)[0], kps, 1)
    assert dt.shape == (3, TINY["desc_dim"]) and np.abs(dt - dj).max() <= 1e-5


def test_official_names_and_manifest(tmp_path):
    """The parameter list at the official size is the pinned manifest, name
    for name and shape for shape (what init_random draws); a checkpoint of
    the JAX package's draw loads into both packages with the same tensors;
    an official-size checkpoint is manifest-checked (a missing key raises)."""
    assert tm.MODEL_CONFIG["enc_dim"] == 1024 and tm.MODEL_CONFIG["dec_depth"] == 12
    specs = {name: list(shape) for name, shape, _, _ in tm.param_specs(tm.MODEL_CONFIG)}
    assert specs == tman.load_manifest("mast3r")
    j = write_checkpoint(tmp_path / "tiny.pth", TINY, 3)
    t = tm.Mast3rNet({**TINY, "weights_path": str(tmp_path / "tiny.pth")}, device="cpu")
    assert t.params.keys() == j.params.keys() == {n for n, _, _, _ in tm.param_specs(TINY)}
    jl = JNet({**TINY, "weights_path": str(tmp_path / "tiny.pth")})
    for k, v in jl.params.items():
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(v), err_msg=k)
    sd = dict(zero_checkpoint("mast3r"), mask_token=torch.zeros(1, 1024))
    torch.save({"model": sd}, tmp_path / "official.pth")
    net = tm.Mast3rNet({"weights_path": str(tmp_path / "official.pth")}, device="cpu")
    assert len(net.params) == len(tman.load_manifest("mast3r"))
    torch.save(zero_checkpoint("mast3r", drop=("dec_blocks2.11.norm3.weight",)), tmp_path / "short.pth")
    with pytest.raises(ValueError, match="manifest 'mast3r'.*dec_blocks2.11.norm3.weight"):
        tm.Mast3rNet({"weights_path": str(tmp_path / "short.pth")}, device="cpu")
    with pytest.raises(ValueError, match="unrecognized checkpoint keys"):
        tm.Mast3rNet(TINY, device="cpu").params_from_torch_state_dict({"head.weight": torch.zeros(1)})


def test_without_weights_at_official_width_the_matcher_raises(tmp_path, monkeypatch):
    """MissingWeightsError naming the official file (the JAX package raises
    a RuntimeError, of which it is one); below the official width the
    matcher draws seeded weights, as the JAX package's does; a registry
    name whose file is missing raises with its URL."""
    monkeypatch.setenv("MPSFM_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(MissingWeightsError, match=tm.FILE):
        get_dense_matcher("mast3r", {}, device="cpu")
    assert issubclass(MissingWeightsError, RuntimeError)
    m = tm.Mast3rMatcher(TINY, device="cpu")
    j = JMatcher(TINY)
    for k, v in j.net.params.items():
        np.testing.assert_array_equal(m.net.params[k].numpy(), np.asarray(v), err_msg=k)
    with pytest.raises(FileNotFoundError, match="MASt3R_ViTLarge.*naverlabs"):
        tm.Mast3rMatcher({"weights_path": "mast3r"}, device="cpu")


class FakeParser:
    def __init__(self, img_dir, names):
        self.img_dir, self.names = img_dir, names

    def image_names(self):
        return self.names

    def image_path(self, name):
        return self.img_dir / name

    def prior_inputs(self, name):
        return {}


def test_extract_pair_depths_writes_mast3r_pair_depth(tmp_path):
    """'depth' mode without sensor depth: both images of a pair take
    MASt3R's pointmap z and (1/conf)² variance from one forward of the
    pair, stored as the JAX package stores them (the JAX package's own
    test_extract_pair_depths_uses_matcher_pointmap on the port); the best
    pair's map read back equals the JAX package's within REL."""
    write_checkpoint(tmp_path / "m.pth", TINY, 3)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    names = ["a.png", "b.png", "c.png"]
    for n, im in zip(names, images(0) + images(5)[:1]):
        Image.fromarray(im).save(img_dir / n)
    conf = {"dense_matcher": "mast3r", "dense_matcher_conf": {**TINY, "weights_path": str(tmp_path / "m.pth")}}
    pairs = [("a.png", "b.png"), ("a.png", "c.png")]
    tex = TExtraction(conf, FakeParser(img_dir, names), tmp_path / "port", device="cpu")
    jex = JExtraction(conf, FakeParser(img_dir, names), tmp_path / "jax")
    tpath, jpath = tex.extract_pair_depths(pairs), jex.extract_pair_depths(pairs)
    assert isinstance(tex.dense_model, tm.Mast3rMatcher)
    for name in names:
        got = tio.get_mono_map_from_pairs(tpath, name, pairs)
        want = jio.get_mono_map_from_pairs(jpath, name, pairs)
        assert got is not None and got["depth"].shape == (48, 64) and (got["depth_variance"] > 0).all()
        assert got.keys() == want.keys(), name
        for k in want:
            x, y = np.asarray(want[k]), np.asarray(got[k])
            if x.dtype == bool:
                np.testing.assert_array_equal(x, y)
            else:
                assert np.abs(x - y).max() <= REL * np.abs(x).max(), (name, k)
