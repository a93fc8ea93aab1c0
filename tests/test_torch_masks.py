"""Sky masks and the guided filter on the port against the JAX package and
OpenCV, on the CPU (mpsfm_tpu_torch/extraction/masks.py and
guided_filter.py against mpsfm_tpu/extraction/masks.py and
guided_filter.py, which call OpenCV).

Each filter of the heuristic is held to OpenCV's function at 1e-5 (Sobel,
the 25-tap Gaussian blur, the 5×5 close) or exactly (the Gaussian's
weights, the reflect-101 indices, the top-connected selection against
connectedComponents' labels); the heuristic's mask bit for bit on
tests/test_dense_retrieval_masks.py's image and at >= 99.9% of the pixels
of seeded 240×320 images with a sky band (MASK_SHARE). The guided
upsample within 1e-9 of the JAX package's float64 (GUIDED_TOL), OpenCV's
INTER_LINEAR within 1e-12 (float64) and 1e-6 (float32); pyrDown bit-equal
to OpenCV's on uint8. The onnx path with the fake session: the net's
input within 1e-4 (SESSION_TOL), the mask at >= 99.9% (chip_smoke.py's
FakeSkySession, the JAX test's session stub). Then the JAX
package's behavioural tests of the guided filter and the onnx path on the
port.
"""

import cv2
import numpy as np
import pytest
import torch

import chip_smoke
from mpsfm_tpu.extraction import guided_filter as jgf
from mpsfm_tpu.extraction import masks as jmasks
from mpsfm_tpu_torch.extraction import guided_filter as tgf
from mpsfm_tpu_torch.extraction import masks as tmasks

FILTER_TOL, MASK_SHARE, GUIDED_TOL, SESSION_TOL = 1e-5, 0.999, 1e-9, 1e-4


@pytest.fixture(autouse=True)
def few_threads():
    """The tier-1 run shares the host's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reference_image():
    """tests/test_dense_retrieval_masks.py's test_sky_mask_heuristic image."""
    img = np.zeros((80, 100, 3), np.float32)
    img[:30] = [0.55, 0.65, 0.95]  # bright blue sky on top
    img[30:] = np.random.default_rng(0).uniform(0, 0.5, (50, 100, 3))  # textured ground
    return img


def band_image(seed, hw=(240, 320)):
    """A textured ground under a bright-blue band of a seeded height, with a
    little noise on the sky."""
    rng = np.random.default_rng(seed)
    H, W = hw
    img = rng.uniform(0, 0.5, (H, W, 3)).astype(np.float32)
    h = int(rng.integers(40, 120))
    img[:h] = np.array([0.5, 0.6, 0.9], np.float32) + rng.normal(0, 0.003, (h, W, 3)).astype(np.float32)
    return img


def gray(seed=0, hw=(61, 83)):
    return np.random.default_rng(seed).uniform(0, 1, hw).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 5, 13, 40])
def test_reflect101_equals_opencv(n):
    lo = hi = 12
    ref = [cv2.borderInterpolate(i, n, cv2.BORDER_REFLECT_101) for i in range(-lo, n + hi)]
    assert tmasks.reflect101(n, lo, hi, "cpu").tolist() == ref


def test_sobel_equals_opencv():
    g = gray()
    for kx, ky, dx, dy in (([-1.0, 0, 1], [1.0, 2, 1], 1, 0), ([1.0, 2, 1], [-1.0, 0, 1], 0, 1)):
        ref = cv2.Sobel(g, cv2.CV_32F, dx, dy, ksize=3)
        got = tmasks.separable(torch.as_tensor(g), kx, ky).numpy()
        np.testing.assert_allclose(got, ref, atol=FILTER_TOL)


def test_gaussian_blur_equals_opencv():
    assert np.array_equal(tmasks.gaussian_kernel(3.0), cv2.getGaussianKernel(25, 3, cv2.CV_32F).ravel())
    g = gray(1, (50, 70)) * 0.1
    k = tmasks.gaussian_kernel(3.0)
    ref = cv2.GaussianBlur(g, (0, 0), 3)
    np.testing.assert_allclose(tmasks.separable(torch.as_tensor(g), k, k).numpy(), ref, atol=FILTER_TOL)


def top_selection_cv2(cand):
    """The JAX package's selection: the components whose label appears in
    the top three rows."""
    _, labels = cv2.connectedComponents(cand.astype(np.uint8), connectivity=4)
    top = set(np.unique(labels[:3])) - {0}
    return np.isin(labels, list(top)) & cand


def serpentine(H=60, W=41):
    """A one-pixel corridor snaking down from the top row: its far end is
    ~H·W/4 steps of the flood fill away."""
    m = np.zeros((H, W), bool)
    for r in range(0, H, 2):
        m[r, 1:-1] = True
        m[r + 1 if r + 1 < H else r, 1 if (r // 2) % 2 else W - 2] = True
    return m


@pytest.mark.parametrize("case", ["random", "serpentine", "empty", "full"])
def test_top_connected_equals_components(case):
    rng = np.random.default_rng(7)
    cand = {"random": rng.uniform(0, 1, (120, 160)) < 0.58, "serpentine": serpentine(),
            "empty": np.zeros((30, 40), bool), "full": np.ones((30, 40), bool)}[case]
    got = tmasks.top_connected(torch.as_tensor(cand)).numpy()
    assert np.array_equal(got, top_selection_cv2(cand))


def test_close_equals_opencv():
    rng = np.random.default_rng(8)
    m = rng.uniform(0, 1, (64, 90)) < 0.3
    m[:2] = True
    m[:, -1] = True
    ref = cv2.morphologyEx(m.astype(np.uint8), cv2.MORPH_CLOSE, np.ones((5, 5), np.uint8)) > 0
    assert np.array_equal(tmasks.close5(torch.as_tensor(m)).numpy(), ref)


def test_sky_mask_heuristic_bit_equal_on_the_reference_image():
    img = reference_image()
    ref = jmasks.sky_mask_heuristic(img)
    got = tmasks.sky_mask_heuristic(img, device="cpu")
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)
    # uint8 input (scaled by 1/255) and a gray image
    u8 = (img * 255).astype(np.uint8)
    assert np.array_equal(tmasks.sky_mask_heuristic(u8, device="cpu").numpy(), jmasks.sky_mask_heuristic(u8))
    g = img.mean(-1)
    assert np.array_equal(tmasks.sky_mask_heuristic(g, device="cpu").numpy(), jmasks.sky_mask_heuristic(g))


@pytest.mark.parametrize("seed", range(4))
def test_sky_mask_heuristic_on_sky_bands(seed):
    img = band_image(seed)
    ref = jmasks.sky_mask_heuristic(img)
    got = tmasks.sky_mask_heuristic(img, device="cpu").numpy()
    assert (got == ref).mean() >= MASK_SHARE
    assert ref[:30].mean() < 0.1 and ref[-60:].mean() > 0.9  # the case masks its sky


def test_sky_mask_heuristic_behaviour_on_the_port():
    """test_sky_mask_heuristic's assertions on the port."""
    img = reference_image()
    mask = tmasks.sky_mask_heuristic(img, device="cpu").numpy()
    assert mask[50:].mean() > 0.9  # ground valid
    assert mask[:25].mean() < 0.3  # sky masked
    assert tmasks.SkyMask(device="cpu")(img).shape == (80, 100)


@pytest.mark.parametrize("shapes", [((7, 9), (20, 31)), ((100, 130), (61, 70)), ((240, 320), (320, 320)),
                                    ((32, 32), (256, 256)), ((5, 3), (2, 2))])
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_linear_equals_opencv(shapes, channels):
    (h, w), (H, W) = shapes
    X = np.random.default_rng(h * w).uniform(0, 1, (h, w) if channels is None else (h, w, channels))
    for dt, tol in ((np.float64, 1e-12), (np.float32, 1e-6)):
        ref = cv2.resize(X.astype(dt), (W, H), interpolation=cv2.INTER_LINEAR)
        got = tgf.resize_linear(torch.as_tensor(X.astype(dt)), (H, W)).numpy()
        assert got.dtype == dt
        np.testing.assert_allclose(got, ref, atol=tol)


def test_down2_and_resize_equal_jax():
    X = np.random.default_rng(9).uniform(0, 1, (61, 70, 3))
    np.testing.assert_allclose(tgf._down2(torch.as_tensor(X)).numpy(), jgf._down2(X), atol=1e-15)
    np.testing.assert_allclose(tgf._resize(torch.as_tensor(X), (9, 11)).numpy(), jgf._resize(X, (9, 11)), atol=1e-14)
    P = np.random.default_rng(10).uniform(0, 1, (48, 40))
    np.testing.assert_allclose(tgf._smooth_up(torch.as_tensor(P), (301, 257)).numpy(), jgf._smooth_up(P, (301, 257)),
                               atol=1e-14)


def guide_case():
    """test_guided_upsample_follows_guide_edges's inputs."""
    H, W = 256, 256
    edge = 131
    guide = np.zeros((H, W, 3))
    guide[:edge] = [0.55, 0.65, 0.9]
    guide[edge:] = [0.25, 0.2, 0.15]
    guide = np.clip(guide + np.random.default_rng(0).normal(0, 0.01, guide.shape), 0, 1)
    hl, wl = 32, 32
    yy = np.arange(hl)[:, None] * (H / hl)
    prob_low = 1.0 / (1.0 + np.exp((yy - (edge + 10)) / 12.0)) * np.ones((hl, wl))
    return guide, prob_low, edge


def test_guided_upsample_equals_jax():
    guide, prob, _ = guide_case()
    ref = jgf.guided_upsample(guide, prob, kernel_size=64)
    got = tgf.guided_upsample(torch.as_tensor(guide), torch.as_tensor(prob), 64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, atol=GUIDED_TOL)
    # the onnx path's shapes: a 320×320 float32 probability against a 701×800 guide at kernel 256
    rng = np.random.default_rng(11)
    img, p = rng.uniform(0, 1, (701, 800, 3)), rng.uniform(0, 1, (320, 320)).astype(np.float32)
    np.testing.assert_allclose(tgf.guided_upsample(torch.as_tensor(img), torch.as_tensor(p), 256).numpy(),
                               jgf.guided_upsample(img, p, 256), atol=GUIDED_TOL)
    c = rng.uniform(0.01, 1, (320, 320))
    np.testing.assert_allclose(tgf.probability_to_confidence(torch.as_tensor(c)).numpy(),
                               jgf.probability_to_confidence(c), atol=0)


def test_guided_upsample_follows_guide_edges_on_the_port():
    """tests/test_dense_retrieval_masks.py's case on the port."""
    guide, prob_low, edge = guide_case()
    H, W = guide.shape[:2]
    up = tgf.guided_upsample(torch.as_tensor(guide), torch.as_tensor(prob_low), 64).numpy()
    bil = cv2.resize(prob_low, (W, H), interpolation=cv2.INTER_LINEAR)
    gt = np.zeros((H, W))
    gt[:edge] = 1.0
    err_guided = np.abs((up > 0.5).astype(float) - gt).mean()
    err_bilinear = np.abs((bil > 0.5).astype(float) - gt).mean()
    assert err_guided < 0.5 * err_bilinear, (err_guided, err_bilinear)
    assert err_guided < 0.02


@pytest.mark.parametrize("hw", [(97, 131), (480, 640), (701, 800), (5, 7), (1, 4)])
def test_pyr_down_bit_equal_to_opencv(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    ref = cv2.pyrDown(img)
    got = tmasks.pyr_down(torch.as_tensor(img)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, ref)


def onnx_image(hw=(701, 800)):
    """test_skymask_onnx_pipeline_with_fake_session's image (>= 640 a side
    exercises pyrDown): bright sky over the top 3/7, dark ground, noise."""
    return chip_smoke.onnx_image(np.random.default_rng(1), hw)


@pytest.mark.parametrize("hw", [(701, 800), (1300, 1400), (500, 700)])
def test_onnx_path_equals_jax(hw):
    img = onnx_image(hw=hw)
    sj, st = chip_smoke.FakeSkySession(), chip_smoke.FakeSkySession()
    ref = jmasks.SkyMask({"backend": "onnx"}, session=sj)(img)
    got = tmasks.SkyMask({"backend": "onnx"}, session=st, device="cpu")(img)
    assert np.abs(st.seen - sj.seen).max() <= SESSION_TOL
    assert got.dtype == bool and got.shape == hw and (got == ref).mean() >= MASK_SHARE


def test_skymask_onnx_pipeline_with_fake_session_on_the_port():
    """test_skymask_onnx_pipeline_with_fake_session's case on the port."""
    sess = chip_smoke.FakeSkySession()
    mask = tmasks.SkyMask({"backend": "onnx"}, session=sess, device="cpu")(onnx_image())
    assert sess.seen is not None  # the session was actually fed
    assert mask.shape == (701, 800) and mask.dtype == bool
    assert mask[340:].mean() > 0.9  # ground kept (True = not sky)
    assert mask[:260].mean() < 0.1  # sky removed


def test_onnx_without_a_session_needs_onnxruntime(monkeypatch):
    """As in the JAX package: the onnx backend without a session imports
    onnxruntime, which raises where it is absent (this host has none)."""
    import importlib.util

    if importlib.util.find_spec("onnxruntime") is None:
        with pytest.raises(ImportError):
            jmasks.SkyMask({"backend": "onnx"})
        with pytest.raises(ImportError):
            tmasks.SkyMask({"backend": "onnx"}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmasks.SkyMask()
