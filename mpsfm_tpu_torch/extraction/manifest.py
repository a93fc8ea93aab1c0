"""Checkpoint manifests: pinned key->shape inventories of the official
checkpoint files the neural extraction consumes (host copy of
mpsfm_tpu/extraction/manifest.py).

The repository ships no weights, so the nets are held against their JAX
twins on seeded weights; the manifests close the load-and-go gap: the day
a real checkpoint appears, `check_state_dict` diffs it against the pinned
inventory and reports every missing / unexpected / shape-mismatched key up
front, instead of failing somewhere inside a forward pass.

The pinned files live in `mpsfm_tpu_torch/extraction/manifests/<name>.json`
as {key: [dims...]}, byte-equal copies of the JAX package's for the nets
the port runs (superpoint, lightglue, netvlad, metric3dv2-{small,large,
giant2}, dsine, roma-outdoor, roma-dinov2, mast3r, depthanythingv2-vitl,
depthpro);
the small classic nets also have closed-form manifest functions here.

Official files covered: superpoint_v1.pth, superpoint_lightglue.pth,
metric_depth_vit_{small,large,giant2}_800k.pth, Pitts30K VGG16-NetVLAD
(torch export), dsine.pth (v02_kappa), roma_outdoor.pth and
dinov2_vitl14_pretrain.pth (each file against its own manifest),
MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth,
depth_anything_v2_metric_vkitti_vitl.pth and DepthPro in HuggingFace's
DepthProForDepthEstimation naming (apple/DepthPro-hf; 1410 keys, 951.9 M
parameters).
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np

MANIFEST_DIR = Path(__file__).parent / "manifests"


# ------------------------------------------------------------ builders
def superpoint_manifest():
    """magicleap superpoint_v1.pth layout (features/superpoint.py)."""
    chans = {
        "conv1a": (1, 64), "conv1b": (64, 64), "conv2a": (64, 64),
        "conv2b": (64, 64), "conv3a": (64, 128), "conv3b": (128, 128),
        "conv4a": (128, 128), "conv4b": (128, 128),
    }
    man = {}
    for name, (i, o) in chans.items():
        man[f"{name}.weight"] = [o, i, 3, 3]
        man[f"{name}.bias"] = [o]
    for name, (i, o, k) in {
        "convPa": (128, 256, 3), "convPb": (256, 65, 1),
        "convDa": (128, 256, 3), "convDb": (256, 256, 1),
    }.items():
        man[f"{name}.weight"] = [o, i, k, k]
        man[f"{name}.bias"] = [o]
    return man


def lightglue_manifest(n_layers=9, dim=256, num_heads=4, input_dim=256):
    """superpoint_lightglue.pth layout, after normalize_torch_state_dict's
    renames (matchers/lightglue.py)."""
    D, H = dim, num_heads

    def dense(man, prefix, i, o):
        man[f"{prefix}.weight"] = [o, i]
        man[f"{prefix}.bias"] = [o]

    man = {}
    dense(man, "input_proj", input_dim, D)
    man["posenc.Wr.weight"] = [D // H // 2, 2]
    for l in range(n_layers):
        base = f"transformers.{l}"
        dense(man, f"{base}.self_attn.Wqkv", D, 3 * D)
        dense(man, f"{base}.self_attn.out_proj", D, D)
        dense(man, f"{base}.self_attn.ffn.0", 2 * D, 2 * D)
        man[f"{base}.self_attn.ffn.1.weight"] = [2 * D]
        man[f"{base}.self_attn.ffn.1.bias"] = [2 * D]
        dense(man, f"{base}.self_attn.ffn.3", 2 * D, D)
        dense(man, f"{base}.cross_attn.to_qk", D, D)
        dense(man, f"{base}.cross_attn.to_v", D, D)
        dense(man, f"{base}.cross_attn.to_out", D, D)
        dense(man, f"{base}.cross_attn.ffn.0", 2 * D, 2 * D)
        man[f"{base}.cross_attn.ffn.1.weight"] = [2 * D]
        man[f"{base}.cross_attn.ffn.1.bias"] = [2 * D]
        dense(man, f"{base}.cross_attn.ffn.3", 2 * D, D)
    dense(man, f"log_assignment.{n_layers - 1}.final_proj", D, D)
    dense(man, f"log_assignment.{n_layers - 1}.matchability", D, 1)
    return man


def netvlad_manifest(K=64, D=512):
    """Torch export of the Pitts30K VGG16-NetVLAD (retrieval.py)."""
    vgg = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    man = {}
    c_in = 3
    for ch, ti in zip(vgg, conv_idx):
        man[f"backbone.{ti}.weight"] = [ch, c_in, 3, 3]
        man[f"backbone.{ti}.bias"] = [ch]
        c_in = ch
    man["netvlad.score_proj.weight"] = [K, D, 1]
    man["netvlad.centers"] = [D, K]
    man["whiten.weight"] = [4096, D * K]
    man["whiten.bias"] = [4096]
    man["preproc_mean"] = [3]
    return man


BUILTIN = {
    "superpoint": superpoint_manifest,
    "lightglue": lightglue_manifest,
    "netvlad": netvlad_manifest,
}


# ------------------------------------------------------------ IO + diff
def load_manifest(name):
    path = MANIFEST_DIR / f"{name}.json"
    if path.exists():
        with open(path) as f:
            return json.load(f)
    if name in BUILTIN:
        return {k: list(v) for k, v in BUILTIN[name]().items()}
    raise FileNotFoundError(f"no checkpoint manifest '{name}' in {MANIFEST_DIR}")


def _shape(v):
    """Shape of a numpy array, a tensor or a shape given as a tuple/list."""
    if isinstance(v, (tuple, list)):
        return [int(d) for d in v]
    return [int(d) for d in (v.shape if hasattr(v, "shape") else np.shape(v))]


def manifest_from_params(params, prefix=""):
    """Flat official-named param dict -> {key: shape list}."""
    return {prefix + k: _shape(v) for k, v in params.items()}


def diff_state_dict(sd, manifest):
    """sd: {key: array, tensor or shape tuple}. Returns dict of
    missing / unexpected / mismatched ({key: (got, want)})."""
    got = {k: _shape(v) for k, v in sd.items()}
    missing = sorted(k for k in manifest if k not in got)
    unexpected = sorted(k for k in got if k not in manifest)
    mismatched = {
        k: (got[k], list(manifest[k]))
        for k in got
        if k in manifest and got[k] != list(manifest[k])
    }
    return {"missing": missing, "unexpected": unexpected, "mismatched": mismatched}


def check_state_dict(sd, name, where="", ignore_unexpected=True):
    """Diff a loaded checkpoint against the pinned manifest. Raises
    ValueError on missing or shape-mismatched keys (full diff in the
    message — the load-and-go contract); unexpected keys only warn by
    default (checkpoints often carry optimizer/aux entries the loaders
    skip)."""
    d = diff_state_dict(sd, load_manifest(name))
    msg = []
    if d["missing"]:
        msg.append(f"missing {len(d['missing'])} keys, e.g. {d['missing'][:6]}")
    if d["mismatched"]:
        ex = list(d["mismatched"].items())[:4]
        msg.append(f"shape mismatch on {len(d['mismatched'])} keys, e.g. {ex}")
    if msg:
        raise ValueError(
            f"checkpoint does not match manifest '{name}'{' for ' + where if where else ''}: "
            + "; ".join(msg)
        )
    if d["unexpected"]:
        text = (
            f"checkpoint has {len(d['unexpected'])} keys outside manifest "
            f"'{name}', e.g. {d['unexpected'][:6]}"
        )
        if not ignore_unexpected:
            raise ValueError(text)
        warnings.warn(text)
    return d


def convert_checked(converter, sd, name, where=""):
    """Run a checkpoint converter with the manifest diff attached to any
    failure, then manifest-check the converted params: a truncated or
    shape-mismatched checkpoint raises a ValueError that names the
    manifest and shows the raw checkpoint's key surface, not a bare
    KeyError deep inside the converter."""
    try:
        params = converter(sd)
    except Exception as e:  # noqa: BLE001 — re-raised with the diagnosis attached
        keys = sorted(sd) if isinstance(sd, dict) else []
        raise ValueError(
            f"checkpoint conversion failed for manifest '{name}'"
            f"{' at ' + where if where else ''}: {type(e).__name__}: {e}. "
            f"Raw checkpoint has {len(keys)} keys, e.g. {keys[:6]} — "
            "likely a truncated download or a different model variant."
        ) from e
    check_state_dict(params, name, where=where)
    return params
