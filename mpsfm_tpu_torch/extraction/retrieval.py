"""NetVLAD global descriptors for retrieval (port of
mpsfm_tpu/extraction/retrieval.py).

The reference's NetVLAD (mpsfm/extraction/imagewise/features/models/
netvlad.py: VGG16 conv5 backbone + NetVLAD pooling + PCA whitening,
Pitts30K weights) on the device, with the matconvnet .mat and the torch
export loaders. Parameters are a dict of tensors: conv{i} {w (O,I,3,3),
b}, assign_w (K,D), assign_b, centers (K,D), whiten_w (4096, D·K),
whiten_b, preproc_mean (3,). The image resize before the net is OpenCV's
INTER_LINEAR (guided_filter.resize_linear), which the card's host has
without OpenCV.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.extraction.guided_filter import resize_linear
from mpsfm_tpu_torch.extraction.manifest import check_state_dict
from mpsfm_tpu_torch.extraction.weights import maybe_resolve

# VGG16 conv layers up to conv5_3: (channels, max pool after)
_VGG_LAYOUT = [
    (64, False), (64, True), (128, False), (128, True),
    (256, False), (256, False), (256, True),
    (512, False), (512, False), (512, True),
    (512, False), (512, False), (512, False),  # conv5_1..5_3 no final pool
]
_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]  # torchvision indices of the convs


def vgg16_features(params, img):
    """img (B,H,W,3) in [0,1] RGB -> conv5_3 features (B,h,w,512).

    As the reference NetVLAD (netvlad.py:118-141): the input scaled to
    0-255 and the checkpoint's averageImage mean subtracted (std 1); the
    trunk stops at conv5_3 before its ReLU and pool."""
    mean = params.get("preproc_mean")
    x = img * 255.0 - (mean if mean is not None else 0.0)
    x = x.permute(0, 3, 1, 2)
    last = len(_VGG_LAYOUT) - 1
    for i, (_, pool) in enumerate(_VGG_LAYOUT):
        x = F.conv2d(x, params[f"conv{i}"]["w"], params[f"conv{i}"]["b"], padding=1)
        if i != last:
            x = F.relu(x)
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return x.permute(0, 2, 3, 1)


def netvlad_pool(params, feats):
    """NetVLAD aggregation: feats (B,h,w,D) -> (B, D*K) (netvlad.py:18-40):
    descriptors normalized over D, a bias-free soft assignment, residuals
    to the centers, intra-normalization per cluster, flattened d-major."""
    B, h, w, D = feats.shape
    x = feats.reshape(B, h * w, D)
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
    logits = torch.einsum("bnd,kd->bnk", x, params["assign_w"])
    if "assign_b" in params:
        logits = logits + params["assign_b"]
    assign = torch.softmax(logits, -1)  # (B,N,K)
    resid = x[:, :, None, :] - params["centers"][None, None]  # (B,N,K,D)
    vlad = torch.einsum("bnk,bnkd->bkd", assign, resid)
    vlad = vlad / torch.clamp(torch.linalg.vector_norm(vlad, dim=-1, keepdim=True), min=1e-12)
    vlad = vlad.transpose(1, 2).reshape(B, -1)  # (B, D*K), d-major
    return vlad / torch.clamp(torch.linalg.vector_norm(vlad, dim=-1, keepdim=True), min=1e-12)


class NetVLAD:
    default_conf = {"weights_path": None, "whiten_dim": 4096, "resize_max": 640}

    def __init__(self, conf=None, device="cuda"):
        self.conf = {**self.default_conf, **(conf or {})}
        self.device = resolve_device(device)
        self.params = None
        wp = maybe_resolve(self.conf.get("weights_path"))
        if wp:
            self.params = self.load_weights(wp)

    def _to_device(self, tree):
        return {k: self._to_device(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v, np.float32),
                                                                                   device=self.device)
                for k, v in tree.items()}

    def load_weights(self, path):
        """The Pitts30K matconvnet .mat checkpoint (the reference's format)
        or a torch state dict in the reference-wrapper naming (backbone.N /
        netvlad.score_proj, netvlad.centers / whiten), manifest-checked."""
        if str(path).endswith(".mat"):
            return self._to_device(self._load_mat(path))
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        check_state_dict(sd, "netvlad", where=str(path))
        return self._to_device(self.params_from_torch_state_dict(sd))

    @staticmethod
    def params_from_torch_state_dict(sd):
        """Reference-wrapper torch naming -> the param dict (host numpy)."""
        sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
        params = {f"conv{i}": {"w": sd[f"backbone.{ti}.weight"], "b": sd[f"backbone.{ti}.bias"]}
                  for i, ti in enumerate(_CONV_IDX)}
        # score_proj is a bias-free Conv1d with kernel (K, D, 1)
        params["assign_w"] = sd["netvlad.score_proj.weight"][:, :, 0]
        if "netvlad.score_proj.bias" in sd:
            params["assign_b"] = sd["netvlad.score_proj.bias"]
        params["centers"] = sd["netvlad.centers"].T  # (D,K) -> (K,D)
        if "whiten.weight" in sd:
            params["whiten_w"] = sd["whiten.weight"]  # (4096, D*K)
            params["whiten_b"] = sd["whiten.bias"]
        if "preproc_mean" in sd:
            params["preproc_mean"] = sd["preproc_mean"].reshape(3)
        return params

    @staticmethod
    def _load_mat(path):
        """Parse the matconvnet Pitts30K_struct.mat as the reference does
        (netvlad.py:73-121): conv weights SxSxIxO at layers 0..28, NetVLAD
        assignment + centers at layer 30 (centers negated), whitening
        1x1xINxOUT at layer 33, averageImage preprocessing."""
        from scipy.io import loadmat

        mat = loadmat(path, struct_as_record=False, squeeze_me=True)
        layers = mat["net"].layers
        params = {}
        for i, li in enumerate(_CONV_IDX):
            w = np.asarray(layers[li].weights[0], np.float32)  # S,S,I,O
            b = np.asarray(layers[li].weights[1], np.float32).reshape(-1)
            if w.ndim == 3:
                w = w[:, :, None, :]
            params[f"conv{i}"] = {"w": np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))), "b": b}
        score_w = np.asarray(layers[30].weights[0], np.float32)  # (D,K)
        center_w = -np.asarray(layers[30].weights[1], np.float32)  # (D,K)
        params["assign_w"] = score_w.T  # (K,D)
        params["centers"] = center_w.T  # (K,D)
        w = np.asarray(layers[33].weights[0], np.float32)  # 1,1,IN,OUT
        params["whiten_w"] = w.reshape(w.shape[-2], w.shape[-1]).T  # (OUT,IN)
        params["whiten_b"] = np.asarray(layers[33].weights[1], np.float32).reshape(-1)
        avg = np.asarray(mat["net"].meta.normalization.averageImage, np.float32)
        params["preproc_mean"] = avg.reshape(-1)[:3]
        return params

    def init_random(self, seed=0, K=64, D=512):
        """The JAX package's init_random: the same numpy draws in the same
        order (its HWIO kernels transposed), so both packages get the same
        weights from one seed."""
        rng = np.random.default_rng(seed)
        params = {}
        c_in = 3
        for i, (ch, _) in enumerate(_VGG_LAYOUT):
            w = rng.normal(scale=0.05, size=(3, 3, c_in, ch)).astype(np.float32)
            params[f"conv{i}"] = {"w": np.ascontiguousarray(w.transpose(3, 2, 0, 1)), "b": np.zeros(ch, np.float32)}
            c_in = ch
        params["assign_w"] = rng.normal(scale=0.1, size=(K, D)).astype(np.float32)
        params["assign_b"] = np.zeros(K, np.float32)
        params["centers"] = rng.normal(size=(K, D)).astype(np.float32)
        self.params = self._to_device(params)

    def forward(self, img):
        """img (B,H,W,3) in [0,1], H and W multiples of 32 -> (B, D·K) or
        whitened (B, 4096) unit descriptors."""
        p = self.params
        with torch.no_grad():
            v = netvlad_pool(p, vgg16_features(p, img))
            if "whiten_w" in p:
                v = v @ p["whiten_w"].T + p["whiten_b"]
                v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)
        return v

    def prepare(self, image_rgb: np.ndarray):
        """The image as the net takes it: in [0, 1], at most resize_max a
        side (OpenCV's INTER_LINEAR), zero-padded to multiples of 32, as a
        (1, H, W, 3) float32 tensor on the device."""
        img = image_rgb.astype(np.float32) / 255.0 if image_rgb.dtype == np.uint8 else image_rgb
        x = torch.as_tensor(np.ascontiguousarray(img, np.float32), device=self.device)
        m = self.conf["resize_max"]
        if m and max(img.shape[:2]) > m:
            s = m / max(img.shape[:2])
            x = resize_linear(x, (int(img.shape[0] * s), int(img.shape[1] * s)))
        H, W = x.shape[:2]
        return F.pad(x, (0, 0, 0, -(-W // 32) * 32 - W, 0, -(-H // 32) * 32 - H))[None]

    def __call__(self, image_rgb: np.ndarray):
        assert self.params is not None, "load weights or init_random() first"
        return self.forward(self.prepare(image_rgb))[0].cpu().numpy()
