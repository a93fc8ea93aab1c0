"""The dense NCC matcher on the port against the JAX package, on the CPU
(mpsfm_tpu_torch/extraction/matchers/dense_ncc.py against
mpsfm_tpu/extraction/matchers/dense_ncc.py).

Inputs are smooth random images made from numpy seeds (a coarse uniform
field, cubic-upsampled, as tests/test_dense_retrieval_masks.py makes
them), the second a shifted, noisy copy of the first. The port computes
the NCC scores in another float order than XLA, so an argmax over near-
equal scores may pick another candidate: the flows are held equal at >=
99% of the grid points (FLOW_SHARE; the flips are counted), the
certainties within 1e-5 where the flows are equal. On these inputs no flow
flips. At 120×160 the matcher pads both images to 128×160, which changes
the grid, the pyramid's zero borders and the patches near them.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction.matchers import dense_ncc as jncc
from mpsfm_tpu_torch.extraction.matchers import dense_ncc as tncc

FLOW_SHARE, CERT_TOL = 0.99, 1e-5
SHAPES = [(96, 128), (120, 160)]


@pytest.fixture(autouse=True)
def few_threads():
    """The tier-1 run shares the host's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def pair(shape, seed=0, shift=(3, 6), noise=0.02):
    """(A, B) float32 images of `shape`: A a smooth random field, B A moved by
    shift (rows, columns) plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    H, W = shape
    base = rng.uniform(0, 1, (H // 5, W // 5)).astype(np.float32)
    A = cv2.resize(base, (W, H), interpolation=cv2.INTER_CUBIC)
    B = np.roll(A, shift, axis=(0, 1)) + rng.normal(0, noise, A.shape).astype(np.float32)
    return A, B.astype(np.float32)


def padded(A, B):
    """Both images zero-padded to a multiple of 32, as DenseNCCMatcher pads them."""
    Hb, Wb = (-(-A.shape[0] // 32) * 32, -(-A.shape[1] // 32) * 32)
    out = []
    for im in (A, B):
        p = np.zeros((Hb, Wb), np.float32)
        p[: im.shape[0], : im.shape[1]] = im
        out.append(p)
    return out


def flows_agree(fj, ft, cj, ct):
    """Share of equal flows; max certainty gap where equal."""
    same = (np.asarray(fj) == np.asarray(ft)).all(1)
    gap = float(np.abs(np.asarray(cj) - np.asarray(ct))[same].max()) if same.any() else np.inf
    return float(same.mean()), gap


@pytest.mark.parametrize("shape", SHAPES)
def test_pyr_down_equals_jax(shape):
    A, _ = padded(*pair(shape))
    ref = np.asarray(jncc._pyr_down(jnp.asarray(A)))
    got = tncc._pyr_down(torch.as_tensor(A)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_patch_table_equals_clipped_patches():
    """A row of the patch table is the JAX package's _patches_at at the
    same centre, borders and corners included."""
    A, _ = pair((40, 52), seed=3)
    ys = np.array([0, 0, 1, 2, 17, 39, 39, 38, 20], np.int32)
    xs = np.array([0, 51, 2, 50, 25, 0, 51, 3, 1], np.int32)
    ref = np.asarray(jncc._patches_at(jnp.asarray(A), jnp.asarray(ys), jnp.asarray(xs), 7))
    table = tncc._patch_table(torch.as_tensor(A), 7)
    flat = np.clip(ys, 0, A.shape[0] - 1) * A.shape[1] + np.clip(xs, 0, A.shape[1] - 1)
    got = table[torch.as_tensor(flat).long()].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


@pytest.mark.parametrize("R", [3, 16])
def test_refine_level_equals_jax(R):
    """One level's windowed search from a random start flow."""
    A, B = padded(*pair((96, 128), seed=1))
    rng = np.random.default_rng(2)
    ys, xs = np.meshgrid(np.arange(7, 89, 8, dtype=np.int32), np.arange(7, 121, 8, dtype=np.int32), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    flow = rng.integers(-4, 5, (len(ys), 2)).astype(np.int32)
    fj, sj = jncc._refine_level(jnp.asarray(A), jnp.asarray(B), jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(flow),
                                7, R)
    tA, tB = (tncc._patch_table(torch.as_tensor(im), 7) for im in (A, B))
    ft, st = tncc._refine_level(tA, tB, B.shape, torch.as_tensor(ys), torch.as_tensor(xs), torch.as_tensor(flow), R)
    assert ft.dtype == torch.int32
    share, gap = flows_agree(fj, ft, sj, st)
    assert share >= FLOW_SHARE and gap <= CERT_TOL, (share, gap)


@pytest.mark.parametrize("shape", SHAPES)
def test_ncc_flow_equals_jax(shape):
    A, B = padded(*pair(shape))
    gj, fj, cj = (np.asarray(x) for x in jncc.ncc_flow(jnp.asarray(A), jnp.asarray(B)))
    gt, ft, ct = (x.numpy() for x in tncc.ncc_flow(torch.as_tensor(A), torch.as_tensor(B)))
    assert np.array_equal(gj, gt) and ft.dtype == np.float32 and ct.dtype == np.float32
    share, gap = flows_agree(fj, ft, cj, ct)
    assert share >= FLOW_SHARE and gap <= CERT_TOL, (share, gap)
    # the pair's shift is found: the flow at the grid points away from the borders
    inner = (gj[:, 0] > 24) & (gj[:, 0] < A.shape[1] - 24) & (gj[:, 1] > 24) & (gj[:, 1] < A.shape[0] - 24)
    assert (np.abs(ft[inner] - [6, 3]).max(1) <= 1).mean() > 0.9


def test_ncc_flow_chunked_equals_whole(monkeypatch):
    """The search over chunks of the grid gives the flow of one block."""
    A, B = (torch.as_tensor(x) for x in padded(*pair((96, 128), seed=4)))
    whole = tncc.ncc_flow(A, B)
    monkeypatch.setattr(tncc, "BLOCK_BYTES", 7 * 49 * 4 * 33 * 33)  # 7 grid points a chunk at the coarse level
    parts = tncc.ncc_flow(A, B)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_dense_matcher_equals_jax(shape):
    """DenseNCCMatcher: the same selected grid points (padding, validity,
    certainty threshold, top max_matches) and matches."""
    A, B = pair(shape, seed=5)
    conf = {"certainty_threshold": 0.5, "max_matches": 100}
    oj = jncc.DenseNCCMatcher(conf)(A, B)
    ot = tncc.DenseNCCMatcher(conf, device="cpu")(A, B)
    assert len(oj["certainty"]) == len(ot["certainty"]) == 100
    for k in ("keypoints0", "keypoints1"):
        assert ot[k].dtype == oj[k].dtype and np.array_equal(ot[k], oj[k])
    np.testing.assert_allclose(ot["certainty"], oj["certainty"], atol=CERT_TOL)


def test_assign_flow_to_keypoints_equals_jax():
    """The anchoring (host numpy and scipy in both packages): exact."""
    rng = np.random.default_rng(6)
    A, B = padded(*pair((96, 128), seed=6))
    grid, flow, cert = (x.numpy() for x in tncc.ncc_flow(torch.as_tensor(A), torch.as_tensor(B)))
    kpsA = rng.uniform(0, [128, 96], (300, 2))
    kpsB = np.concatenate([kpsA[:200] + [6, 3] + rng.normal(0, 0.5, (200, 2)), rng.uniform(0, [128, 96], (80, 2))])
    oj = jncc.assign_flow_to_keypoints(grid, flow, cert, kpsA, kpsB)
    ot = tncc.assign_flow_to_keypoints(grid, flow, cert, kpsA, kpsB)
    assert (ot["matches0"] >= 0).sum() > 50
    for k in ("matches0", "matching_scores0"):
        assert ot[k].dtype == oj[k].dtype and np.array_equal(ot[k], oj[k])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dense_ncc_recovers_translation(pkg, rng):
    """tests/test_dense_retrieval_masks.py's case on both packages."""
    base = rng.uniform(0, 1, (40, 50)).astype(np.float32)
    imgA = cv2.resize(base, (256, 192), interpolation=cv2.INTER_CUBIC)
    shift = 10
    imgB = np.roll(imgA, shift, axis=1)
    conf = {"certainty_threshold": 0.6}
    m = jncc.DenseNCCMatcher(conf) if pkg == "jax" else tncc.DenseNCCMatcher(conf, device="cpu")
    out = m(imgA, imgB)
    assert len(out["certainty"]) > 100
    flow = out["keypoints1"] - out["keypoints0"]
    good = (np.abs(flow[:, 0] - shift) < 2) & (np.abs(flow[:, 1]) < 2)
    assert good.mean() > 0.8, good.mean()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dense_ncc_rejects_unrelated(pkg, rng):
    imgA = rng.uniform(0, 1, (128, 160)).astype(np.float32)
    imgB = rng.uniform(0, 1, (128, 160)).astype(np.float32)
    conf = {"certainty_threshold": 0.6}
    m = jncc.DenseNCCMatcher(conf) if pkg == "jax" else tncc.DenseNCCMatcher(conf, device="cpu")
    out = m(imgA, imgB)
    # forward-backward check should kill most random matches
    assert len(out["certainty"]) < 60


def test_dense_matcher_refuses_the_cpu_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tncc.DenseNCCMatcher()
