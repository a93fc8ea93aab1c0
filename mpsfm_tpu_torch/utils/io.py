"""HDF5 cache IO (port of mpsfm_tpu/utils/io.py) — same schema as the
reference (mpsfm/utils/io.py) so artifacts interchange for parity testing:
features (keypoints/descriptors with `uncertainty` attr), matches
(matches0/matching_scores0), mono maps (depth/variance/normals...), masks,
pair-name canonicalization. h5py and OpenCV are imported by the functions
that use them, never by importing this module."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def names_to_pair(name0: str, name1: str, separator: str = "/") -> str:
    return separator.join((name0.replace("/", "-"), name1.replace("/", "-")))


def names_to_pair_old(name0: str, name1: str) -> str:
    return names_to_pair(name0, name1, separator="_")


def read_image(path, grayscale: bool = False) -> np.ndarray:
    import cv2

    mode = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
    image = cv2.imread(str(path), mode)
    if image is None:
        raise ValueError(f"Cannot read image {path}.")
    if not grayscale and len(image.shape) == 3:
        image = image[:, :, ::-1]
    return image


def list_h5_names(path) -> list[str]:
    import h5py

    names = []
    with h5py.File(str(path), "r", libver="latest") as fd:

        def visit_fn(_, obj):
            if isinstance(obj, h5py.Dataset):
                names.append(obj.parent.name.strip("/"))

        fd.visititems(visit_fn)
    return list(set(names))


def write_features(path, name, keypoints, descriptors=None, scores=None, uncertainty=1.0, image_size=None, as_half=True):
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(path), "a", libver="latest") as fd:
        if name in fd:
            del fd[name]
        grp = fd.create_group(name)
        dt = np.float16 if as_half else np.float32
        grp.create_dataset("keypoints", data=np.asarray(keypoints, dt))
        grp["keypoints"].attrs["uncertainty"] = uncertainty
        if descriptors is not None:
            grp.create_dataset("descriptors", data=np.asarray(descriptors, dt))
        if scores is not None:
            grp.create_dataset("scores", data=np.asarray(scores, dt))
        if image_size is not None:
            grp.create_dataset("image_size", data=np.asarray(image_size))


def get_keypoints(path, name, return_uncertainty=False):
    import h5py

    with h5py.File(str(path), "r", libver="latest") as hfile:
        dset = hfile[name]["keypoints"]
        p = dset.__array__().astype(np.float64)
        uncertainty = dset.attrs.get("uncertainty")
    if return_uncertainty:
        return p, uncertainty
    return p


def get_descriptors(path, name):
    import h5py

    with h5py.File(str(path), "r", libver="latest") as hfile:
        return hfile[name]["descriptors"].__array__().astype(np.float32)


def find_pair(hfile, name0: str, name1: str):
    """(pair key, reversed) of a pair in an open HDF5 file."""
    for pair, rev in (
        (names_to_pair(name0, name1), False),
        (names_to_pair(name1, name0), True),
        (names_to_pair_old(name0, name1), False),
        (names_to_pair_old(name1, name0), True),
    ):
        if pair in hfile:
            return pair, rev
    raise ValueError(f"Could not find pair {(name0, name1)}")


def write_matches(path, name0, name1, matches0, scores0):
    """matches0: (N0,) index into kps1 or -1; scores0: (N0,)."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(path), "a", libver="latest") as fd:
        pair = names_to_pair(name0, name1)
        if pair in fd:
            del fd[pair]
        grp = fd.create_group(pair)
        grp.create_dataset("matches0", data=np.asarray(matches0, np.int32))
        grp.create_dataset("matching_scores0", data=np.asarray(scores0, np.float16))


def get_matches(path, name0, name1):
    import h5py

    with h5py.File(str(path), "r", libver="latest") as hfile:
        pair, reverse = find_pair(hfile, name0, name1)
        matches = hfile[pair]["matches0"].__array__()
        scores = hfile[pair]["matching_scores0"].__array__()
    idx = np.where(matches != -1)[0]
    matches = np.stack([idx, matches[idx]], -1)
    if reverse:
        matches = np.flip(matches, -1)
    scores = scores[idx]
    return matches, scores


def write_mono_map(path, name, data: dict):
    """data keys per reference: depth, depth_variance, valid, normals,
    normals_variance, (depth2/... for flip passes)."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(path), "a", libver="latest") as fd:
        key = str(Path(name).name)
        if key in fd:
            del fd[key]
        grp = fd.create_group(key)
        for k, v in data.items():
            grp.create_dataset(k, data=np.asarray(v))


def get_mono_map_from_pairs(path, name, pairs):
    """Per-pair two-view depth cache (MASt3R 'depth' mode): each pair group
    holds a depth/valid/variance triplet per image; pick the pair with the
    best mean confidence (reference utils/io.py:17-42)."""
    import h5py

    cname = str(Path(name).name)
    best = None
    best_score = -np.inf
    with h5py.File(str(path), "r") as f:
        for pair in pairs:
            if cname not in pair:
                continue
            key = f"{names_to_pair(*pair)}/{cname}"
            if key not in f:
                continue
            g = f[key]
            depth = g["depth"][:]
            valid = g["valid"][:]
            var = g["variance"][:]
            score = float((1.0 / var[valid]).mean()) if valid.any() else -np.inf
            if score > best_score:
                best_score = score
                best = {"depth": depth, "valid": valid, "depth_variance": var}
    return best


def write_pair_mono_map(path, name0, name1, per_image: dict):
    """per_image: image name -> {depth, valid, variance}."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(path), "a") as f:
        base = names_to_pair(name0, name1)
        for img_name, data in per_image.items():
            key = f"{base}/{str(Path(img_name).name)}"
            if key in f:
                del f[key]
            grp = f.create_group(key)
            for k, v in data.items():
                grp.create_dataset(k, data=np.asarray(v))


def get_mono_map(path, name):
    import h5py

    with h5py.File(str(path), "r") as f:
        key = str(Path(name).name)
        if key not in f:
            return None
        return {k: v[:] for k, v in f[key].items()}


def write_mask(path, name, mask):
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(path), "a") as fd:
        if name in fd:
            del fd[name]
        fd.create_group(name).create_dataset("mask", data=np.asarray(mask))


def get_mask(path, name):
    import h5py

    with h5py.File(str(path), "r") as file:
        return file[name]["mask"][:]


def read_pairs(path) -> list[tuple[str, str]]:
    pairs = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 2:
                pairs.append(tuple(parts))
    # unique regardless of order
    seen, out = set(), []
    for a, b in pairs:
        key = frozenset((a, b))
        if key not in seen and a != b:
            seen.add(key)
            out.append((a, b))
    return out


def write_pairs(path, pairs):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for a, b in pairs:
            f.write(f"{a} {b}\n")
