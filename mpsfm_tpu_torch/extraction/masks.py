"""Sky masking backends (port of mpsfm_tpu/extraction/masks.py).

The reference runs an ONNX sky-segmentation net + guided upsampling
(mpsfm/extraction/imagewise/mask/models/skyseg.py). Backends here:
``onnx`` when onnxruntime + a model file exist (or a session is given),
and ``heuristic`` — a dependency-free classifier (bright, low-texture,
sky-connected-from-top regions) that covers the common outdoor failure
mode (keypoints and depth priors on sky) without weights. Returns the
reference's convention: True = NOT sky (valid).

The JAX package's module calls OpenCV; here every filter is a torch op on
the mask's device, with OpenCV's border rules: Sobel and the Gaussian
blur reflect-101 (`reflect101`), the 5×5 close never lets a pixel outside
the image win, and pyrDown is integer arithmetic, bit for bit OpenCV's on
uint8. In place of connectedComponents, the components that touch the
top rows are a flood fill (`top_connected`): the candidates of rows 0-2
grow by 4-neighbour steps confined to the candidates until nothing
changes, which selects exactly the pixels whose component label appears
in the top three rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.guided_filter import guided_upsample, resize_linear

FILL_CHECK_EVERY = 16  # flood-fill steps between reads of the stop condition
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=64)
def reflect101(n: int, lo: int, hi: int, device):
    """Indices of positions -lo .. n-1+hi into n samples, reflected about
    the edge samples without repeating them (OpenCV's BORDER_REFLECT_101,
    folded again for pads longer than the axis). Built once per shape and
    device."""
    idx = np.arange(-lo, n + hi)
    if n == 1:
        return torch.zeros(len(idx), dtype=torch.long, device=device)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    idx = np.where(idx >= n, period - idx, idx)
    return torch.as_tensor(idx, device=device)


@functools.lru_cache(maxsize=16)
def _taps(weights: tuple, device):
    """A filter's float32 taps on `device`, uploaded once."""
    return torch.tensor(weights, dtype=torch.float32, device=device)


def _pad101(x, r):
    """(H, W) tensor padded by r on each side, reflect-101."""
    H, W = x.shape
    return x.index_select(0, reflect101(H, r, r, x.device)).index_select(1, reflect101(W, r, r, x.device))


def separable(x, kx, ky):
    """OpenCV's sepFilter2D of a (H, W) float32 tensor with a reflect-101
    border: kx along the rows, then ky along the columns (correlation)."""
    r = len(kx) // 2
    xp = _pad101(x, r)[None, None]
    kx = _taps(tuple(float(v) for v in np.asarray(kx, np.float32)), x.device)
    ky = _taps(tuple(float(v) for v in np.asarray(ky, np.float32)), x.device)
    out = F.conv2d(xp, kx.reshape(1, 1, 1, -1))
    return F.conv2d(out, ky.reshape(1, 1, -1, 1))[0, 0]


def gaussian_kernel(sigma: float):
    """OpenCV's Gaussian kernel for ksize (0, 0) on float32 images: ksize =
    round(8σ + 1) | 1 taps, the weights normalised in float64, then float32."""
    n = int(np.floor(sigma * 8 + 1 + 0.5)) | 1
    x = np.arange(n) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (k * (1.0 / k.sum())).astype(np.float32)


def top_connected(candidate):
    """The candidate pixels 4-connected, within the candidates, to a
    candidate of rows 0-2: a flood fill by 3×3-cross max-pooling, read for
    its stop every FILL_CHECK_EVERY steps."""
    cand = candidate.float()[None, None]
    reach = cand.clone()
    reach[..., 3:, :] = 0
    while True:
        before = reach
        for _ in range(FILL_CHECK_EVERY):
            grown = torch.maximum(F.max_pool2d(reach, (3, 1), 1, (1, 0)), F.max_pool2d(reach, (1, 3), 1, (0, 1)))
            reach = grown * cand
        if torch.equal(reach, before):
            return reach[0, 0] > 0


def close5(mask):
    """5×5 morphological close (dilate, then erode) of a bool mask; pixels
    outside the image never win (OpenCV's default morphology border)."""
    x = mask.float()[None, None]
    x = F.max_pool2d(x, 5, 1, 2)
    x = -F.max_pool2d(-x, 5, 1, 2)
    return x[0, 0] > 0


def sky_candidates(img, brightness_thresh=0.55, texture_thresh=0.02):
    """The heuristic's candidate sky pixels of a (H,W,3) or (H,W) float32
    tensor in [0, 1]: bright and untextured, or blue-ish and nearly so."""
    if img.ndim == 3:
        gray = img.mean(-1)
        # sky tends to be blue-ish and bright
        blueness = img[..., 2] - 0.5 * (img[..., 0] + img[..., 1])
    else:
        gray = img
        blueness = torch.zeros_like(gray)
    gx = separable(gray, [-1.0, 0.0, 1.0], [1.0, 2.0, 1.0])
    gy = separable(gray, [1.0, 2.0, 1.0], [-1.0, 0.0, 1.0])
    k = gaussian_kernel(3.0)
    texture = separable(gx.abs() + gy.abs(), k, k)

    candidate = (gray > brightness_thresh) & (texture < texture_thresh)
    candidate |= (blueness > 0.08) & (texture < texture_thresh * 2)
    return candidate


def sky_mask_heuristic(image_rgb, brightness_thresh=0.55, texture_thresh=0.02, device="cuda"):
    """image_rgb: (H,W,3) or (H,W), a tensor (kept on its device) or an
    array (moved to `device`, the card unless the caller asks for the CPU).
    Returns bool (H,W) on that device, True = valid (non-sky)."""
    if not torch.is_tensor(image_rgb):
        image_rgb = torch.as_tensor(np.asarray(image_rgb), device=resolve_device(device))
    img = image_rgb.to(torch.float32)
    img = torch.where(img.max() > 1.5, img / 255.0, img)  # a uint8-range image, without a read on the host
    candidate = sky_candidates(img, brightness_thresh, texture_thresh)
    # keep only components connected to the top rows (sky touches the top)
    sky = close5(top_connected(candidate))
    return ~sky


def pyr_down_ladder(img):
    """The onnx path's pyrDown ladder: halve while both sides are >= 640."""
    while img.shape[0] >= 640 and img.shape[1] >= 640:
        img = pyr_down(img)
    return img


def pyr_down(img):
    """OpenCV's pyrDown of a (H, W[, C]) uint8 tensor: the 5×5 [1, 4, 6, 4,
    1]² / 256 blur at every second pixel, reflect-101, in integer
    arithmetic rounded as (Σ w·x + 128) >> 8; ((H+1)/2, (W+1)/2) out."""
    x = img.to(torch.int32)
    w = (1, 4, 6, 4, 1)
    for dim in (1, 0):
        n = x.shape[dim]
        m = (n + 1) // 2
        src = reflect101(n, 2, 2, x.device)
        out = None
        for j in range(5):  # output i reads padded positions 2i + j, j = 0 .. 4
            term = w[j] * x.index_select(dim, src[j: j + 2 * m: 2])
            out = term if out is None else out + term
        x = out
    return ((x + 128) >> 8).to(torch.uint8)


class SkyMask:
    """Sky masks on `device`. backend 'onnx' takes an injectable `session`
    (the onnxruntime interface: get_inputs(), run(None, feed)); without one
    it opens conf['onnx_path'] with onnxruntime, which raises if absent."""

    default_conf = {"backend": "heuristic", "onnx_path": None, "thresh": 0.5}

    def __init__(self, conf=None, session=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        self.device = resolve_device(device)
        self._session = session  # injectable for tests (fake onnx session)
        if self._session is None and self.conf["backend"] == "onnx":
            import onnxruntime  # noqa: F401 — raises if unavailable

            self._session = onnxruntime.InferenceSession(self.conf["onnx_path"])

    def __call__(self, image_rgb: np.ndarray) -> np.ndarray:
        if self._session is not None:
            return self._onnx(image_rgb)
        return sky_mask_heuristic(image_rgb, device=self.device).cpu().numpy()

    @staticmethod
    def _net_input(original):
        """The (1, 3, 320, 320) float32 input of the net for a (H, W, 3)
        uint8 tensor: the pyrDown ladder, INTER_LINEAR to 320×320, ImageNet
        normalisation."""
        x = resize_linear(pyr_down_ladder(original).to(torch.float32), (320, 320))
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
        x = (x / 255.0 - mean) / std
        return x.permute(2, 0, 1)[None].contiguous()

    def _onnx(self, image_rgb):
        """Reference skyseg pipeline EXACTLY (skyseg.py:148-212): pyrDown
        while >=640, 320x320 ImageNet-normalized inference, min-max output
        normalization, confidence-weighted GUIDED upsampling against the
        full-res image (kernel 256), mask = prob <= thresh (True = not
        sky). The net runs in the session on the host; the rest on the
        device."""
        original = torch.as_tensor(np.asarray(image_rgb), device=self.device)
        if original.ndim == 2:
            original = torch.stack([original] * 3, -1)
        inp = self._net_input(original).cpu().numpy()
        out = self._session.run(None, {self._session.get_inputs()[0].name: inp})[0]
        out = torch.as_tensor(np.asarray(out).squeeze(), device=self.device)
        # reference min-max normalization (run_inference, skyseg.py:166-172)
        out = (out - out.min()) / torch.clamp(out.max() - out.min(), min=1e-12)
        prob = guided_upsample(original.to(torch.float64) / 255.0, out, 256)
        return (prob <= self.conf["thresh"]).cpu().numpy()  # True = not sky
