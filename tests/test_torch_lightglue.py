"""LightGlue on the port against the JAX package's, on the CPU.

At 64 dims × 4 heads × 3 layers in float32 (tests/test_converters.py's
test_lightglue_torch_parity size): the scores within 1e-4 of the JAX
forward, padded keypoint sets against unpadded ones, and the matches of
match_pairs and match_pairs_from_table equal to the JAX package's. In
bfloat16 the port's matches agree with the JAX package's bfloat16 matches
at least as often as the JAX package's bfloat16 matches agree with its
own float32 ones, measured on the same pairs (the JAX package's CPU graph
keeps fused intermediates in float32; the port rounds the parameters,
inputs and attention operands). The official layout round-trips through
normalize_torch_state_dict and the converters.
"""

import numpy as np
import pytest
import torch

import jax
from mpsfm_tpu.extraction.matchers.lightglue import LightGlue as JLightGlue
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction.manifest import check_state_dict, load_manifest
from mpsfm_tpu_torch.extraction.matchers import attention as tatt
from mpsfm_tpu_torch.extraction.matchers.lightglue import LightGlue

TOL = 1e-4  # tests/test_converters.py::test_lightglue_torch_parity
CONF = {"dim": 64, "num_heads": 4, "n_layers": 3}


@pytest.fixture(autouse=True)
def few_threads():
    """The tier-1 run shares the host's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def pair_sets(seed, dim=64, sizes=((300, 410), (170, 230), (700, 90), (512, 512))):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0, 600, (n0, 2)).astype(np.float32), rng.normal(size=(n0, dim)).astype(np.float32),
             (640, 480), rng.uniform(0, 600, (n1, 2)).astype(np.float32),
             rng.normal(size=(n1, dim)).astype(np.float32), (640, 480)) for n0, n1 in sizes]


def both(conf, seed=0):
    j = JLightGlue(conf)
    j.init_random(seed)
    t = LightGlue(conf, device="cpu")
    t.init_random(seed)
    return j, t


def inputs(seed, n0, n1, pad=None, dim=64):
    rng = np.random.default_rng(seed)
    k0 = rng.uniform(-1, 1, (1, n0, 2)).astype(np.float32)
    k1 = rng.uniform(-1, 1, (1, n1, 2)).astype(np.float32)
    d0 = rng.normal(size=(1, n0, dim)).astype(np.float32)
    d1 = rng.normal(size=(1, n1, dim)).astype(np.float32)
    P = pad or max(n0, n1)
    out = []
    for a, n in ((k0, n0), (k1, n1), (d0, n0), (d1, n1)):
        z = np.zeros((1, P if pad else n) + a.shape[2:], np.float32)
        z[:, :n] = a
        out.append(z)
    m0 = np.zeros((1, out[0].shape[1]), bool)
    m1 = np.zeros((1, out[1].shape[1]), bool)
    m0[:, :n0] = True
    m1[:, :n1] = True
    return out + [m0, m1]


@pytest.mark.parametrize("pad", [None, 80])
def test_scores_equal_jax_in_float32(pad):
    """The port's scores, unpadded or padded to 80 with masks, against the
    JAX forward of the unpadded sets."""
    j, t = both({**CONF, "dtype": "float32"})
    n0, n1 = 33, 47
    ref = np.asarray(j._forward(j.params, *inputs(0, n0, n1)))[0]
    n = tatt.KERNEL.launches
    got = t.forward(*(torch.as_tensor(a) for a in inputs(0, n0, n1, pad)))[0, :n0, :n1].numpy()
    assert tatt.KERNEL.launches == n  # CPU tensors take the plain version
    assert np.abs(got - ref).max() <= TOL


def test_match_pairs_equal_jax_in_float32():
    j, t = both({**CONF, "dtype": "float32"})
    pairs = pair_sets(1)
    for a, b in zip(j.match_pairs(pairs), t.match_pairs(pairs)):
        np.testing.assert_array_equal(a["matches0"], b["matches0"])
        assert np.abs(a["matching_scores0"] - b["matching_scores0"]).max() <= TOL
    assert sum((o["matches0"] >= 0).sum() for o in t.match_pairs(pairs)) > 0


@pytest.mark.parametrize("table_dtype", ["float32", "float16"])
def test_match_pairs_from_table_equal_jax(table_dtype):
    """The image-major route (one descriptor table, index gathers) in both
    table types; the float16 table rounds the descriptors in both packages."""
    j, t = both({**CONF, "dtype": "float32", "table_dtype": table_dtype})
    rng = np.random.default_rng(2)
    feats = [(rng.uniform(0, 600, (n, 2)).astype(np.float32), rng.normal(size=(n, 64)).astype(np.float32))
             for n in (300, 410, 170, 600)]
    whs = [(640, 480)] * 4
    idx = [(0, 1), (2, 3), (1, 2), (3, 0), (0, 2)]
    out_j = j.match_pairs_from_table(feats, whs, idx, chunk=4)
    out_t = t.match_pairs_from_table(feats, whs, idx, chunk=4)
    assert len(out_t) == len(idx)
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(a["matches0"], b["matches0"])
        assert np.abs(a["matching_scores0"] - b["matching_scores0"]).max() <= TOL


def test_bfloat16_matches_agree_with_jax_as_jax_agrees_with_itself():
    """Over four seeded pair sets (16 pairs, 6728 keypoints in image 0 of
    each): the share of matches0 entries the port's bfloat16 run shares
    with the JAX package's is at least the share the JAX package's
    bfloat16 run shares with its float32 run (measured on a CPU: 99.54%
    for the JAX package, 99.67% for the port; per seed 99.52 / 99.70 /
    99.29 / 99.64% against 99.88 / 99.76 / 99.41 / 99.64%)."""
    conf = {**CONF, "filter_threshold": 0.0}  # every mutual argmax counts
    runs = {}
    for name, dt in (("j32", "float32"), ("j16", "bfloat16"), ("t16", "bfloat16")):
        if name.startswith("j"):
            m = JLightGlue({**conf, "dtype": dt})
        else:
            m = LightGlue({**conf, "dtype": dt}, device="cpu")
        m.init_random(0)
        runs[name] = np.concatenate([o["matches0"] for s in (1, 2, 3, 4) for o in m.match_pairs(pair_sets(s))])
    jax_self = (runs["j16"] == runs["j32"]).mean()
    port_vs_jax = (runs["t16"] == runs["j16"]).mean()
    assert port_vs_jax >= jax_self, (port_vs_jax, jax_self)
    assert len(runs["t16"]) == 4 * sum(n0 for n0, _ in ((300, 410), (170, 230), (700, 90), (512, 512)))


def test_official_layout_round_trips():
    """JAX params -> the official state dict (convert) -> the port's
    params, equal; the same state dict back through the JAX package's
    params_from_torch_state_dict gives its arrays; the released naming
    (old module names, no input_proj) normalizes to the manifest's
    surface at the official size."""
    j, _ = both({**CONF, "dtype": "float32"})
    jp = jax.tree.map(np.asarray, j.params)
    sd = convert.lightglue_state_dict(jp, 3)
    back = JLightGlue.params_from_torch_state_dict({k: v.numpy() for k, v in sd.items()}, n_layers=3)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b)
    t = LightGlue({**CONF, "dtype": "float32"}, device="cpu")
    t.params = t.params_from_torch_state_dict(sd, n_layers=3)
    for blk in ("self_1", "cross_2"):
        for name in t.params[blk]:
            leaf = t.params[blk][name]
            want = jp[blk][name]
            if isinstance(leaf, dict):
                np.testing.assert_array_equal(leaf["w"].numpy(), want["w"])
            else:
                np.testing.assert_array_equal(leaf.numpy(), want)
    released = {}
    for k, v in load_manifest("lightglue").items():
        if k.startswith("input_proj"):
            continue
        for kind in ("self_attn", "cross_attn"):
            if k.startswith("transformers.") and f".{kind}." in k:
                i = k.split(".")[1]
                k = f"{kind}.{i}." + k.split(f".{kind}.", 1)[1]
        released[k] = torch.zeros(v)
    norm = LightGlue.normalize_torch_state_dict(released)
    check_state_dict(norm, "lightglue")
    assert torch.equal(norm["input_proj.weight"], torch.eye(256))


def test_official_checkpoint_loads_manifest_checked(tmp_path):
    """superpoint_lightglue.pth in the released layout at 256 × 4 × 9 loads
    through weights_path; a truncated one is refused with the diff."""
    t = LightGlue({"dtype": "float32"}, device="cpu")
    t.init_random(3)
    sd = convert.lightglue_state_dict(t.params, 9)
    path = tmp_path / "superpoint_lightglue.pth"
    torch.save({"state_dict": sd}, path)
    loaded = LightGlue({"weights_path": str(path)}, device="cpu")
    assert torch.equal(loaded.params["cross_8"]["to_v"]["w"], t.params["cross_8"]["to_v"]["w"])
    sd.pop("transformers.4.cross_attn.to_out.bias")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="transformers.4.cross_attn.to_out.bias"):
        LightGlue({"weights_path": str(path)}, device="cpu")


def test_attention_launch_count_and_buckets():
    """36 attention calls a forward of the official depth (9 layers × 2
    self + 2 cross), every bucket a power of two from 512."""
    calls = []
    from mpsfm_tpu_torch.extraction.matchers import lightglue as tlg

    orig = tlg.attention

    def spy(q, k, v, m, s):
        calls.append((q.shape, k.shape, q.dtype))
        return orig(q, k, v, m, s)

    t = LightGlue({"dim": 32, "num_heads": 2, "n_layers": 9}, device="cpu")
    t.init_random(0)
    tlg.attention = spy
    try:
        t.match_pairs(pair_sets(5, dim=32, sizes=((20, 600),)))
    finally:
        tlg.attention = orig
    assert len(calls) == 36 and {c[2] for c in calls} == {torch.bfloat16}
    assert {(c[0][1], c[1][1]) for c in calls} == {(512, 512), (1024, 1024), (512, 1024), (1024, 512)}
    assert [LightGlue._bucket(n) for n in (1, 512, 513, 6000)] == [512, 512, 1024, 8192]
