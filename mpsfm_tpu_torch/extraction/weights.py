"""Checkpoint resolution: the registry of the official files and where the
port looks for them (the loader half of mpsfm_tpu/extraction/weights.py).

A conf's ``weights_path`` is a file path or a registry name; a name is
looked for in the ``models_dir`` given, then in $MPSFM_WEIGHTS_DIR, then in
./local/weights. The port never downloads: a missing file raises with the
registry's URL, so the user can fetch it out of band and put it there
(MPSFM_ALLOW_DOWNLOAD, which lets the JAX package fetch it, does nothing
here).
"""

from __future__ import annotations

import os
from pathlib import Path

_GDRIVE = "https://drive.google.com/uc?export=download&id="

# name -> (filename, url); the JAX package's registry (the reference's own download sources)
WEIGHT_REGISTRY: dict[str, tuple[str, str]] = {
    "superpoint": (
        "superpoint_v1.pth",
        "https://github.com/magicleap/SuperGluePretrainedNetwork/raw/master/models/weights/superpoint_v1.pth",
    ),
    "lightglue": (
        "superpoint_lightglue.pth",
        "https://github.com/cvg/LightGlue/releases/download/v0.1_arxiv/superpoint_lightglue.pth",
    ),
    "netvlad": (
        "Pitts30K_struct.mat",
        "https://cvg-data.inf.ethz.ch/hloc/netvlad/Pitts30K_struct.mat",
    ),
    "metric3dv2-small": (
        "metric_depth_vit_small_800k.pth",
        "https://huggingface.co/JUGGHM/Metric3D/resolve/main/metric_depth_vit_small_800k.pth",
    ),
    "metric3dv2-large": (
        "metric_depth_vit_large_800k.pth",
        "https://huggingface.co/JUGGHM/Metric3D/resolve/main/metric_depth_vit_large_800k.pth",
    ),
    "metric3dv2-giant2": (
        "metric_depth_vit_giant2_800k.pth",
        "https://huggingface.co/JUGGHM/Metric3D/resolve/main/metric_depth_vit_giant2_800k.pth",
    ),
    "depthpro": (
        "depth_pro.pt",
        "https://ml-site.cdn-apple.com/models/depth-pro/depth_pro.pt",
    ),
    "depthanythingv2-vitl": (
        "depth_anything_v2_metric_vkitti_vitl.pth",
        "https://huggingface.co/depth-anything/Depth-Anything-V2-Metric-VKITTI-Large/resolve/main/depth_anything_v2_metric_vkitti_vitl.pth",
    ),
    "dsine": ("dsine.pth", _GDRIVE + "1u8TdKXkR7-0zzRRcx-3x3rPN7gvAAM9N"),
    "skyseg": ("skyseg.onnx", _GDRIVE + "1jJpcRXAHaTR1zk4xD1kVYXtnO1-C982K"),
    "mast3r": (
        "MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth",
        "https://download.europe.naverlabs.com/ComputerVision/MASt3R/MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth",
    ),
    "roma-outdoor": (
        "roma_outdoor.pth",
        "https://github.com/Parskatt/storage/releases/download/roma/roma_outdoor.pth",
    ),
    "dinov2-vitl14": (
        "dinov2_vitl14_pretrain.pth",
        "https://dl.fbaipublicfiles.com/dinov2/dinov2_vitl14/dinov2_vitl14_pretrain.pth",
    ),
}


def default_models_dir() -> Path:
    """The first place searched without a ``models_dir``: $MPSFM_WEIGHTS_DIR
    when it is set, else ./local/weights."""
    env = os.environ.get("MPSFM_WEIGHTS_DIR")
    if env:
        return Path(env)
    return Path.cwd() / "local" / "weights"


def search_dirs(models_dir=None) -> list[Path]:
    """Where a registry name's file is looked for, in order: ``models_dir``,
    $MPSFM_WEIGHTS_DIR, ./local/weights (each once)."""
    out = []
    for d in (models_dir, os.environ.get("MPSFM_WEIGHTS_DIR"), Path.cwd() / "local" / "weights"):
        if d and Path(d) not in out:
            out.append(Path(d))
    return out


def resolve_weights(name: str, models_dir: str | os.PathLike | None = None) -> Path:
    """The local checkpoint path of a registry ``name`` (or a direct
    filesystem path). A registered file that is in none of the places
    searched raises FileNotFoundError with its URL; nothing is fetched."""
    p = Path(name)
    if p.exists():
        return p
    if name not in WEIGHT_REGISTRY:
        raise KeyError(
            f"'{name}' is neither an existing file nor a registered weight "
            f"name; known: {sorted(WEIGHT_REGISTRY)}"
        )
    fname, url = WEIGHT_REGISTRY[name]
    search = search_dirs(models_dir)
    for d in search:
        cand = d / fname
        if cand.exists():
            return cand
    target = search[0] / fname
    raise FileNotFoundError(
        f"checkpoint '{fname}' for '{name}' not found in {', '.join(map(str, search))}. "
        "This package never downloads (MPSFM_ALLOW_DOWNLOAD does nothing here): fetch it "
        f"yourself from {url} and put it at {target}, or in $MPSFM_WEIGHTS_DIR"
    )


def maybe_resolve(weights_path):
    """Loader-side hook: a ``weights_path`` conf value may be a direct
    path OR a registry name ('lightglue', 'metric3dv2-giant2', ...).
    Unknown strings pass through unchanged so torch.load raises its own
    clear error for genuinely bad paths; a registry name whose file is
    missing raises with its URL (the JAX package passes it through to
    torch.load)."""
    if not weights_path:
        return weights_path
    try:
        return str(resolve_weights(str(weights_path)))
    except KeyError:
        return str(weights_path)
