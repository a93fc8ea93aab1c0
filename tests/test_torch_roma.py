"""RoMa on the port against the JAX package's, on the CPU.

At tests/test_roma.py's TINY config and a second small config (the
position embedding resized from a 6² grid by DINOv2's bicubic rule, a
6×6 anchor grid, other correlation radii and block counts, a 168² input),
init_random(seed) gives both packages the same weights, and the forward's
flow and certainty logits agree within 5e-4 absolute (the JAX package's
own bound against its torch twin, tests/test_roma.py). The GP's posterior
mean, whose K_bb solve the port makes by Cholesky (cholesky_solve, on the
CPU its plain version) where the JAX package calls jnp.linalg.solve, agrees
within 1e-4 relative. RomaMatcher's keypoints and certainties equal the
JAX matcher's as sets. The official names round-trip through the two
files both packages load; official-size files that do not match their
manifests are refused; without weights at the official width the matcher
raises MissingWeightsError naming both files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction.nets.roma import RomaMatcher as JRomaMatcher
from mpsfm_tpu.extraction.nets.roma import RomaNet as JRomaNet
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.ba import cholesky
from mpsfm_tpu_torch.extraction import manifest as tman
from mpsfm_tpu_torch.extraction.base import get_dense_matcher
from mpsfm_tpu_torch.extraction.nets import roma as troma
from mpsfm_tpu_torch.extraction.priors import MissingWeightsError

from test_roma import TINY
from test_torch_dsine import zero_checkpoint

ATOL = 5e-4  # tests/test_roma.py: the JAX forward against its torch twin
GP_REL = 1e-4
SECOND = dict(
    vit_dim=24, vit_depth=1, vit_heads=3, vit_patch=14, pos_grid=6,
    gp_dim=6, feat_dim=10, dec_blocks=1, dec_heads=2,
    cls_res=6, kernel_T=0.2, sigma_noise=0.1,
    vgg_spec=(("C", 4), ("C", 4), "M", ("C", 6), "M", ("C", 8), "M", ("C", 10), "M"),
    scales=(
        ("16", 24, 10, 4, 1, 2, True),
        ("8", 10, 10, 4, 2, 1, True),
        ("4", 8, 6, 2, 1, 1, True),
        ("2", 6, 4, 2, 0, 2, True),
        ("1", 4, 3, 2, 0, 1, False),
    ),
    resolution=168,
)
CONFIGS = {"tiny": (TINY, 112), "second": (SECOND, 168)}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def nets(conf, seed):
    j = JRomaNet(conf)
    j.init_random(seed)
    t = troma.RomaNet(conf, device="cpu")
    t.init_random(seed)
    return j, t


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_equals_jax(name):
    conf, R = CONFIGS[name]
    j, t = nets(conf, 1)
    rng = np.random.default_rng(2)
    xa, xb = (rng.normal(size=(1, R, R, 3)).astype(np.float32) for _ in range(2))
    fj, cj = j._jit_fwd(j.params, jnp.asarray(xa), jnp.asarray(xb), (R, R))
    with torch.no_grad():
        ft, ct = t.forward(torch.as_tensor(xa), torch.as_tensor(xb))
    assert ft.shape == (1, R, R, 2) and ct.shape == (1, R, R)
    assert np.abs(np.asarray(fj) - ft.numpy()).max() <= ATOL
    assert np.abs(np.asarray(cj) - ct.numpy()).max() <= ATOL


@pytest.mark.parametrize("hw", [(8, 8), (16, 12)])
def test_gp_mean_by_cholesky_equals_jnp_solve(hw, monkeypatch):
    """The GP at batch 2 on seeded features: the port's posterior mean, its
    K_bb solve through cholesky_solve (on the CPU cholesky_solve_plain, once
    a batch item), within 1e-4 of the largest entry of the JAX package's
    jnp.linalg.solve mean."""
    j, t = nets(TINY, 4)
    rng = np.random.default_rng(5)
    h, w = hw
    C = TINY["gp_dim"]
    xa, xb = (rng.normal(size=(2, h, w, C)).astype(np.float32) for _ in range(2))
    calls = []
    plain = cholesky.cholesky_solve_plain

    def spy(S, rhs):
        calls.append(S.shape)
        return plain(S, rhs)

    monkeypatch.setattr(cholesky, "cholesky_solve_plain", spy)
    want = np.asarray(jax.jit(j._gp)(j.params, jnp.asarray(xa), jnp.asarray(xb)))
    got = t._gp(t.params, torch.as_tensor(xa), torch.as_tensor(xb)).numpy()
    assert calls == [(h * w, h * w)] * 2
    assert np.abs(got - want).max() <= GP_REL * np.abs(want).max()


def images(seed, hw=(60, 80)):
    rng = np.random.default_rng(seed)
    return [(rng.random((*hw, 3)) * 255).astype(np.uint8) for _ in range(2)]


def assert_same_sets(a, b):
    """Keypoints of A exactly, keypoints of B within 1e-3 px and certainties
    within 1e-5, matched by A's keypoint."""
    assert len(a["certainty"]) == len(b["certainty"]) > 0
    ia = np.lexsort(a["keypoints0"].T[::-1])
    ib = np.lexsort(b["keypoints0"].T[::-1])
    np.testing.assert_array_equal(a["keypoints0"][ia], b["keypoints0"][ib])
    assert np.abs(a["keypoints1"][ia] - b["keypoints1"][ib]).max() <= 1e-3
    assert np.abs(a["certainty"][ia] - b["certainty"][ib]).max() <= 1e-5


@pytest.mark.parametrize("over", [{"sample_thresh": 0.0, "nms_radius": 2},
                                  {"sample_thresh": 0.3, "nms_radius": 1, "max_matches": 25}])
def test_matcher_equals_jax_as_sets(over):
    """The TINY matcher (working resolution 224) on a uint8 pair and on the
    gray float pair Extraction hands it, NMS radius 2 with every peak kept,
    and radius 1 with a threshold and the max_matches cut binding."""
    conf = {**TINY, **over}
    jm, tm = JRomaMatcher(conf), troma.RomaMatcher(conf, device="cpu")
    for imgs in (images(0), [im.mean(-1).astype(np.float32) / 255 for im in images(1, (50, 70))]):
        a, b = jm(*imgs), tm(*imgs)
        assert_same_sets(a, b)
        if "max_matches" in over:  # the cut binds: more peaks pass the threshold than it keeps
            uncut = troma.RomaMatcher({**conf, "max_matches": 10**6}, device="cpu")(*imgs)
            assert len(b["certainty"]) == over["max_matches"] < len(uncut["certainty"])


def write_jax_files(d, conf, seed):
    j = JRomaNet(conf)
    j.init_random(seed)
    outdoor, dinov2 = convert.roma_state_dicts({k: np.asarray(v) for k, v in j.params.items()})
    torch.save(outdoor, d / "roma_outdoor.pth")
    torch.save({"model": dinov2}, d / "dinov2_vitl14_pretrain.pth")
    return j, {"weights_path": str(d / "roma_outdoor.pth"),
               "dinov2_weights_path": str(d / "dinov2_vitl14_pretrain.pth")}


def test_official_names_round_trip(tmp_path):
    """The JAX package's draw as the two official files: get_dense_matcher
    ("roma") loads the same tensors in the port, the JAX package loads the
    files too, and both match alike."""
    j, files = write_jax_files(tmp_path, TINY, 6)
    m = get_dense_matcher("roma", {**TINY, **files, "sample_thresh": 0.0, "nms_radius": 2}, device="cpu")
    assert isinstance(m, troma.RomaMatcher) and m.net.params.keys() == j.params.keys()
    for k, v in j.params.items():
        np.testing.assert_array_equal(m.net.params[k].numpy(), np.asarray(v), err_msg=k)
    jm = JRomaMatcher({**TINY, **files, "sample_thresh": 0.0, "nms_radius": 2})
    assert len(jm.net.params) == len(j.params)
    assert_same_sets(jm(*images(3)), m(*images(3)))


def test_official_size_files_are_checked_against_their_manifests(tmp_path):
    """roma_outdoor.pth against roma-outdoor, dinov2_vitl14_pretrain.pth
    (with its mask_token, which no forward reads) against roma-dinov2."""
    dinov2 = dict(zero_checkpoint("roma-dinov2"), mask_token=torch.zeros(1, 1024))
    torch.save(zero_checkpoint("roma-outdoor"), tmp_path / "outdoor.pth")
    torch.save(dinov2, tmp_path / "dinov2.pth")
    files = {"weights_path": str(tmp_path / "outdoor.pth"), "dinov2_weights_path": str(tmp_path / "dinov2.pth")}
    net = troma.RomaNet(files, device="cpu")
    n = len(tman.load_manifest("roma-outdoor")) + len(tman.load_manifest("roma-dinov2"))
    assert len(net.params) == n and "dinov2.mask_token" not in net.params
    torch.save(zero_checkpoint("roma-outdoor", drop=("decoder.gps.16.pos_conv.weight",)), tmp_path / "short.pth")
    with pytest.raises(ValueError, match="manifest 'roma-outdoor'.*decoder.gps.16.pos_conv.weight"):
        troma.RomaNet({**files, "weights_path": str(tmp_path / "short.pth")}, device="cpu")
    torch.save(zero_checkpoint("roma-dinov2", reshape={"pos_embed": (1, 1 + 16 * 16, 1024)}), tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="manifest 'roma-dinov2'.*shape mismatch"):
        troma.RomaNet({**files, "dinov2_weights_path": str(tmp_path / "bad.pth")}, device="cpu")


def test_without_weights_the_matcher_raises_missing_weights(tmp_path, monkeypatch):
    """At the official width: no file, or roma_outdoor.pth without the
    DINOv2 file, raises MissingWeightsError naming both files; a registry
    name whose file is missing raises with its URL."""
    monkeypatch.setenv("MPSFM_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(MissingWeightsError, match="roma_outdoor.pth.*dinov2_vitl14_pretrain.pth"):
        get_dense_matcher("roma", {}, device="cpu")
    torch.save(zero_checkpoint("roma-outdoor"), tmp_path / "outdoor.pth")
    with pytest.raises(MissingWeightsError, match="roma_outdoor.pth.*dinov2_vitl14_pretrain.pth"):
        troma.RomaMatcher({"weights_path": str(tmp_path / "outdoor.pth")}, device="cpu")
    with pytest.raises(FileNotFoundError, match="roma_outdoor.pth.*github.com/Parskatt"):
        troma.RomaMatcher({"weights_path": "roma-outdoor"}, device="cpu")
