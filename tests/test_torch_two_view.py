"""The ViT, the DPT decoder, the two-view net (MASt3R class) and the warp
net (RoMa class) on the port against the JAX package's Flax modules, on
the CPU.

The JAX package initialises these from a Flax PRNGKey; the port cannot draw
the same numbers, so each test carries the JAX params across by
convert.flax_state_dict (convert.two_view_state_dict, warp_state_dict) and
feeds both the same numpy inputs from a seed. The ViT's hooks (with and
without the class token, the position embedding resized bilinearly without
antialiasing, down and up), the DPT decoder and heads (an odd patch grid,
whose average-pooled level the fusion aligns), TwoViewNet's outputs and
WarpNet's warp and certainty agree within 1e-4 of each output's largest
magnitude (the JAX package tests its converters at 1e-4,
tests/test_converters_dense.py). The matchers' keypoints equal the JAX
matchers' as sets (certainties within 1e-5); the pair depth within 1e-4
relative. A CroCo-named torch checkpoint loads in both packages alike; a
Flax msgpack file is refused naming the format.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction.nets.dpt import DPTDecoder as JDPT
from mpsfm_tpu.extraction.nets.dpt import Head as JHead
from mpsfm_tpu.extraction.nets.two_view import TwoViewMatcher as JTwoViewMatcher
from mpsfm_tpu.extraction.nets.two_view import TwoViewNet as JTwoViewNet
from mpsfm_tpu.extraction.nets.vit import ViT as JViT
from mpsfm_tpu.extraction.nets.warp import WarpMatcher as JWarpMatcher
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction.base import get_dense_matcher
from mpsfm_tpu_torch.extraction.nets import dpt, two_view, vit, warp

REL = 1e-4
TV = {"small": dict(dim=32, enc_depth=2, dec_depth=2, num_heads=2, feat=16, desc_dim=8),
      "deeper": dict(dim=48, enc_depth=3, dec_depth=5, num_heads=3, feat=12, desc_dim=6)}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(want, got, what):
    a, b = np.asarray(want), got.detach().numpy()
    assert a.shape == b.shape and np.isfinite(b).all(), what
    assert np.abs(a - b).max() <= REL * np.abs(a).max(), (what, np.abs(a - b).max(), np.abs(a).max())


def port(module, jparams):
    module.load_state_dict(convert.flax_state_dict(jax.tree.map(np.asarray, jparams)))
    return module.eval()


@pytest.mark.parametrize("with_cls,hw,grid", [(True, (48, 80), 24), (False, (64, 48), 2), (True, (32, 32), 2)])
def test_vit_hooks_equal_jax(with_cls, hw, grid):
    """Hooks at depths 0 and 2 of 3 (the last normed), the position
    embedding resized from a grid² (down from 24, up from 2, or as it is)."""
    kw = dict(dim=32, depth=3, num_heads=2, patch=16, hooks=(0, 2), with_cls=with_cls, pos_grid=grid)
    x = np.random.default_rng(0).normal(size=(2, *hw, 3)).astype(np.float32)
    jm = JViT(**kw)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    p = jax.tree.map(lambda a: a + 0.1 * np.random.default_rng(a.size).normal(size=a.shape).astype(np.float32), p)
    want = jm.apply(p, jnp.asarray(x))
    with torch.no_grad():
        got = port(vit.ViT(**kw), p)(torch.as_tensor(x))
    assert len(got) == 2
    for i, (a, b) in enumerate(zip(want, got)):
        close(a, b, f"hook {i}")


def test_dpt_decoder_and_head_equal_jax():
    """Four hooks on a 3×5 grid (the /2 level 1×2, fused up to 2×4 and
    aligned to the 3×5 skip), then a head."""
    rng = np.random.default_rng(1)
    feats = [rng.normal(size=(2, 3, 5, 24)).astype(np.float32) for _ in range(4)]
    jd, jh = JDPT(16), JHead(5, 16)
    pd = jd.init(jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats])
    fused = jd.apply(pd, [jnp.asarray(f) for f in feats])
    ph = jh.init(jax.random.PRNGKey(3), fused)
    want = jh.apply(ph, fused)
    with torch.no_grad():
        tf = port(dpt.DPTDecoder(24, 16), pd)([torch.as_tensor(f) for f in feats])
        got = port(dpt.Head(5, 16), ph)(tf)
    assert tf.shape == (2, 24, 40, 16)
    close(fused, tf, "decoder")
    close(want, got, "head")


def two_view_nets(conf, hw=(48, 64), seed=0):
    rng = np.random.default_rng(seed)
    xa, xb = (rng.normal(size=(1, *hw, 3)).astype(np.float32) for _ in range(2))
    jn = JTwoViewNet(**conf)
    p = jn.init(jax.random.PRNGKey(seed), jnp.asarray(xa), jnp.asarray(xb))
    return jn, p, port(two_view.TwoViewNet(**conf), p), xa, xb


@pytest.mark.slow
def test_deeper_two_view_net_equals_jax():
    """TV["deeper"]: a hook after every decoder block but the last
    (5 // 4 = 1, the last four kept), an 80×112 pair (a 5×7 grid). The
    default widths' forward is held in test_two_view_matcher_equals_jax."""
    jn, p, tn, xa, xb = two_view_nets(TV["deeper"], (80, 112))
    want = jn.apply(p, jnp.asarray(xa), jnp.asarray(xb))
    with torch.no_grad():
        got = tn(torch.as_tensor(xa), torch.as_tensor(xb))
    assert got.keys() == want.keys()
    for k in want:
        close(want[k], got[k], k)


def pair(seed, hw=(48, 64)):
    rng = np.random.default_rng(seed)
    return [(rng.random((*hw, 3)) * 255).astype(np.uint8) for _ in range(2)]


def assert_same_sets(a, b):
    """Keypoints of both images exactly as sets of pairs, certainties within 1e-5."""
    assert len(a["certainty"]) == len(b["certainty"]) > 0
    ka, kb = (np.concatenate([m["keypoints0"], m["keypoints1"]], 1) for m in (a, b))
    ia, ib = np.lexsort(ka.T[::-1]), np.lexsort(kb.T[::-1])
    np.testing.assert_array_equal(ka[ia], kb[ib])
    assert np.abs(a["certainty"][ia] - b["certainty"][ib]).max() <= 1e-5


@pytest.mark.parametrize("name", ["two_view", "mast3r_class"])
def test_two_view_matcher_equals_jax(tmp_path, name):
    """The JAX matcher with its net's params, the port's through
    get_dense_matcher from the same params as a .pth in the port's names:
    the net's outputs on the padded pair (TwoViewNet's forward), matches as
    sets (a uint8 pair of different sizes, then the max_matches cut and a
    certainty threshold binding), the pair depth, descriptor samples."""
    conf = {**TV["small"], "stride": 2}
    jn, p, _, xa, xb = two_view_nets(TV["small"])
    torch.save(convert.two_view_state_dict(jax.tree.map(np.asarray, p)), tmp_path / "tv.pth")
    jm = JTwoViewMatcher(conf)
    jm.params = p
    m = get_dense_matcher(name, {**conf, "weights_path": str(tmp_path / "tv.pth")}, device="cpu")
    assert isinstance(m, two_view.TwoViewMatcher)
    a, b = pair(0)
    imgs = (a, b[:40, :56])
    want, got = jm._forward(*imgs)[0], m._forward(*imgs)[0]
    assert got.keys() == want.keys()
    for k in want:
        close(want[k], got[k], k)
    assert_same_sets(jm(*imgs), m(*imgs))
    for key, val in (("max_matches", 15), ("certainty_threshold", 0.2)):
        jm.conf[key] = m.conf[key] = val
    cut = m(*imgs)
    assert_same_sets(jm(*imgs), cut)
    assert len(cut["certainty"]) == 15 and (cut["certainty"] > 0.2).all()
    pj, pt = jm.pair_depth(*imgs), m.pair_depth(*imgs)
    for key, sh in (("0", (48, 64)), ("1", (40, 56))):
        assert pt[key]["depth"].shape == sh
        np.testing.assert_array_equal(pt[key]["valid"], pj[key]["valid"])
        for f in ("depth", "variance"):
            assert np.abs(pt[key][f] - pj[key][f]).max() <= REL * np.abs(pj[key][f]).max(), (key, f)
    kps = np.array([[3.0, 4.5], [60.25, 30.0]])
    dj = jm.descriptors_at(jm._forward(*imgs)[0], kps, 0)
    assert np.abs(m.descriptors_at(m._forward(*imgs)[0], kps, 0) - dj).max() <= 1e-5


def test_reciprocal_nn_equals_jax():
    """On seeded maps with repeated descriptors (ties in both directions,
    first maximum wins) and a width not a multiple of the stride."""
    from mpsfm_tpu.extraction.nets.two_view import _reciprocal_nn as jnn

    rng = np.random.default_rng(7)
    dA = rng.normal(size=(10, 13, 4)).astype(np.float32)
    dB = rng.normal(size=(9, 11, 4)).astype(np.float32)
    dB[4:8, 4:8] = dA[:4, :4]  # equal descriptors: ties
    cA, cB = (rng.uniform(1, 3, size=d.shape[:2]).astype(np.float32) for d in (dA, dB))
    want = jnn(*(jnp.asarray(x) for x in (dA, dB, cA, cB)), 2)
    got = two_view._reciprocal_nn(*(torch.as_tensor(x) for x in (dA, dB, cA, cB)), 2)
    for k, (a, b) in enumerate(zip(want, got)):
        if b.dtype == torch.bool:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-5, k


def assert_same_warp_sets(a, b):
    """A's grid keypoints exactly, their warps into B within 1e-3 px and
    certainties within 1e-5, matched by A's keypoint."""
    assert len(a["certainty"]) == len(b["certainty"]) > 0
    ia, ib = np.lexsort(a["keypoints0"].T[::-1]), np.lexsort(b["keypoints0"].T[::-1])
    np.testing.assert_array_equal(a["keypoints0"][ia], b["keypoints0"][ib])
    assert np.abs(a["keypoints1"][ia] - b["keypoints1"][ib]).max() <= 1e-3
    assert np.abs(a["certainty"][ia] - b["certainty"][ib]).max() <= 1e-5


@pytest.mark.parametrize("name", ["warp", "roma_class"])
def test_warp_matcher_equals_jax(tmp_path, name):
    """The JAX matcher's params (drawn at its first pair) as a .pth in the
    port's names: WarpNet's warp and certainty on the padded pair, then the
    matches as sets, for two pair shapes and with the max_matches cut
    binding."""
    conf = {"feat": 16, "certainty_threshold": 0.3}
    jw = JWarpMatcher(conf)
    a, b = pair(2, (70, 90))
    jw(a, b)
    torch.save(convert.warp_state_dict(jax.tree.map(np.asarray, jw.params)), tmp_path / "warp.pth")
    m = get_dense_matcher(name, {**conf, "weights_path": str(tmp_path / "warp.pth")}, device="cpu")
    assert isinstance(m, warp.WarpMatcher)
    xa, xb = two_view.padded_pair(two_view.prep_rgb(a), two_view.prep_rgb(b), 32, "cpu")
    wj, cj = jw._fwd(jw.params, jnp.asarray(xa.numpy()), jnp.asarray(xb.numpy()))
    with torch.no_grad():
        wt, ct = m.net(xa, xb)
    close(wj, wt, "warp")
    close(cj, ct, "certainty")
    for imgs in ((a, b), (a[:64], b[:, :80])):
        assert_same_warp_sets(jw(*imgs), m(*imgs))
    for key, val in (("max_matches", 10), ("certainty_threshold", 0.0)):
        jw.conf[key] = m.conf[key] = val
    cut = m(a, b)
    assert len(cut["certainty"]) == 10
    assert_same_warp_sets(jw(a, b), cut)


def test_croco_named_checkpoint_loads_in_both_packages(tmp_path):
    """two_view_params_from_torch: the JAX package's draw written under
    CroCo/DUSt3R names (the inverse of its converter) gives both packages'
    matchers the same net."""
    conf = TV["small"]
    _, p, tn, _, _ = two_view_nets(conf, seed=5)
    own = convert.two_view_state_dict(jax.tree.map(np.asarray, p))
    names = {"self_attn.qkv": "attn.qkv", "self_attn.proj": "attn.proj", "norm_ctx": "norm_y",
             "cross_attn.q.": "cross_attn.projq.", "cross_attn.k.": "cross_attn.projk.",
             "cross_attn.v.": "cross_attn.projv.", "mlp_fc": "mlp.fc"}
    sd = {}
    for k, v in own.items():
        if k.startswith("encoder."):
            k = k.replace("patch_embed.", "patch_embed.proj.").replace("mlp_fc", "mlp.fc")
            k = k.replace("blocks_", "blocks.")
            if k == "encoder.pos_embed":
                v = v.reshape(1, -1, v.shape[-1])
        elif k.startswith("dec_"):
            i, rest = k[len("dec_"):].split(".", 1)
            for a, b in names.items():
                rest = rest.replace(a, b)
            k = f"dec_blocks.{i}.{rest}"
        sd[k] = v
    torch.save({"model": sd}, tmp_path / "croco.pth")
    conf = {**conf, "weights_path": str(tmp_path / "croco.pth")}
    jm, m = JTwoViewMatcher(conf), two_view.TwoViewMatcher(conf, device="cpu")
    assert m.net.state_dict().keys() == own.keys()
    for k, v in own.items():
        np.testing.assert_array_equal(m.net.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    assert_same_sets(jm(*pair(4)), m(*pair(4)))


def test_flax_files_are_refused_and_seeded_init_is_deterministic(tmp_path):
    (tmp_path / "tv.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="Flax .msgpack file"):
        two_view.TwoViewMatcher({"weights_path": str(tmp_path / "tv.msgpack")}, device="cpu")
    (tmp_path / "w.flax").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="Flax .flax file"):
        warp.WarpMatcher({"weights_path": str(tmp_path / "w.flax")}, device="cpu")
    a, b = two_view.TwoViewMatcher(TV["small"], device="cpu"), two_view.TwoViewMatcher(TV["small"], device="cpu")
    for (k, x), y in zip(a.net.state_dict().items(), b.net.state_dict().values()):
        assert torch.equal(x, y), k
    sd = a.net.state_dict()
    assert (sd["encoder.norm.weight"] == 1).all() and (sd["dec_0.cross_attn.q.bias"] == 0).all()
    assert 0.5 < float(sd["dec_0.mlp_fc1.weight"].std()) * 32 ** 0.5 < 1.5  # variance 1/fan_in
    out = a(*pair(6))
    assert np.isfinite(out["certainty"]).all() and out["keypoints0"].shape == out["keypoints1"].shape
