"""Cache and image IO (port of mpsfm_tpu/utils/io.py) — same schema as the
reference (mpsfm/utils/io.py) so artifacts interchange for parity testing:
features (keypoints/descriptors with `uncertainty` attr), matches
(matches0/matching_scores0), mono maps (depth/variance/normals...), masks,
pair-name canonicalization.

Two things differ from the JAX package, so that the main path runs on a
host with neither OpenCV, h5py nor PyYAML:

* PNG images are decoded here with zlib and numpy (`decode_png`), on every
  device; other image formats still go through OpenCV, imported when read.
* Every artifact lives in a store picked by its path's suffix
  (`open_store`): `.h5` is an HDF5 file (h5py, imported when opened; the
  JAX package's format, read by either package), `.npyd` a directory with
  one `.npy` file per dataset and one JSON file of attributes per group or
  dataset (`NpyStore`), holding the same groups, datasets, dtypes and
  attributes.
"""

from __future__ import annotations

import json
import shutil
import struct
import zlib
from pathlib import Path

import numpy as np

# the store format by name (a pipeline conf's `cache_format`) -> the suffix that selects it
STORE_SUFFIX = {"h5": ".h5", "npy": ".npyd"}


def names_to_pair(name0: str, name1: str, separator: str = "/") -> str:
    return separator.join((name0.replace("/", "-"), name1.replace("/", "-")))


def names_to_pair_old(name0: str, name1: str) -> str:
    return names_to_pair(name0, name1, separator="_")


# ---------- PNG ----------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel (no palettes)


def _unfilter_rows(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Filters 0-2, row by row: each row is one numpy step."""
    out = np.empty((rows.shape[0], rows.shape[1] - 1), np.uint8)
    prior = np.zeros(out.shape[1], np.uint8)
    for y, f in enumerate(ftype):
        raw = rows[y, 1:]
        if f == 0:
            out[y] = raw
        elif f == 1:  # sub: a running sum of each byte lane, mod 256
            out[y] = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint64).astype(np.uint8).reshape(-1)
        else:
            out[y] = raw + prior  # up; uint8 wraps mod 256
        prior = out[y]
    return out


def _unfilter_diagonals(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Every filter, by anti-diagonals. Byte (y, x) is predicted from its
    left neighbour a = (y, x - bpp), the one above b = (y - 1, x) and c =
    (y - 1, x - bpp), so the pixels on one anti-diagonal y + x/bpp = d
    depend only on the two diagonals before: the loop runs over the height
    + width diagonals, each a numpy step over its pixels and their bpp byte
    lanes. The image is held skewed, q[d, y], so that a diagonal and its
    neighbours are slices."""
    height, width = rows.shape[0], (rows.shape[1] - 1) // bpp
    # padded coordinates Y = y + 1, X = x + 1 (row 0 and column 0 are the zeros PNG assumes), d = Y + X
    yy, xx = np.meshgrid(np.arange(1, height + 1), np.arange(1, width + 1), indexing="ij")
    raw = np.zeros((height + width + 1, height + 1, bpp), np.int16)
    raw[yy + xx, yy] = rows[:, 1:].reshape(height, width, bpp)
    q = np.zeros_like(raw)
    ft = ftype[:, None]
    for d in range(2, height + width + 1):
        lo, hi = max(1, d - width), min(height, d - 1) + 1
        a, b, c = q[d - 1, lo:hi], q[d - 1, lo - 1:hi - 1], q[d - 2, lo - 1:hi - 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ft[lo - 1:hi - 1], (0, a, b, (a + b) >> 1, paeth))
        q[d, lo:hi] = (raw[d, lo:hi] + pred) & 0xFF
    return q[yy + xx, yy].astype(np.uint8).reshape(height, width * bpp)


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    -> (height, stride) uint8: row by row where no row is averaged or
    Paeth-filtered, else by anti-diagonals."""
    if len(data) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(data, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    ftype = rows[:, 0].astype(np.intp)
    if height and ftype.max() > 4:
        raise ValueError(f"PNG row filter {ftype.max()} is not one of 0-4")
    if height and ftype.max() >= 3:
        return _unfilter_diagonals(rows, ftype, bpp)
    return _unfilter_rows(rows, ftype, bpp)


def decode_png(data: bytes) -> np.ndarray:
    """A non-interlaced PNG of 8 or 16 bits a sample, grayscale (type 0),
    gray + alpha (4), RGB (2) or RGBA (6) -> (H, W) or (H, W, C) array in
    the file's channel order, uint8 or uint16."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG: colour type {ctype}, bit depth {depth}, interlace {interlace}")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    img = px.view(">u2").astype(np.uint16) if depth == 16 else px
    img = img.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _to_gray8(img: np.ndarray) -> np.ndarray:
    """What OpenCV's IMREAD_GRAYSCALE gives for a decoded PNG: 16 bits kept
    to their high byte; colour through libpng's rgb_to_gray at OpenCV's
    weights (0.299, 0.587), 15-bit fixed point truncated, gray pixels kept."""
    if img.dtype == np.uint16:
        if img.ndim == 3:
            raise ValueError("16-bit colour PNGs are not supported")
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    if img.shape[-1] == 2:  # gray + alpha
        return img[..., 0].copy()
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    gray = (9797 * r + 19234 * g + 3737 * b) >> 15
    return np.where((r == g) & (g == b), r, gray).astype(np.uint8)


def _to_rgb8(img: np.ndarray) -> np.ndarray:
    """What OpenCV's IMREAD_COLOR gives for a decoded PNG, as RGB."""
    if img.dtype == np.uint16:
        if img.ndim == 3:
            raise ValueError("16-bit colour PNGs are not supported")
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.shape[-1] == 2:
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def read_png(path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())


def image_size(path) -> tuple[int, int]:
    """(width, height) of an image: a PNG's from its header, without
    decoding it; other formats through read_image."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        with open(path, "rb") as f:
            head = f.read(24)
        if head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
            raise ValueError(f"{path} is not a PNG file")
        return struct.unpack(">II", head[16:24])
    h, w = read_image(path).shape[:2]
    return w, h


def read_image(path, grayscale: bool = False) -> np.ndarray:
    """An image as uint8, (H, W) gray or (H, W, 3) RGB, as the JAX package's
    read_image gives it through OpenCV. PNG is decoded here; other formats
    import OpenCV."""
    path = Path(path)
    if path.suffix.lower() == ".png":
        img = read_png(path)
        return _to_gray8(img) if grayscale else _to_rgb8(img)
    import cv2

    mode = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
    image = cv2.imread(str(path), mode)
    if image is None:
        raise ValueError(f"Cannot read image {path}.")
    if not grayscale and len(image.shape) == 3:
        image = image[:, :, ::-1]
    return image


def read_depth_png(path) -> np.ndarray:
    """A single-channel PNG at its own bit depth (OpenCV's IMREAD_ANYDEPTH)."""
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"depth PNG {path} has {img.shape[-1]} channels, not 1")
    return img


def read_intrinsics(path) -> dict:
    """intrinsics.yaml: camera id -> {params, images}. JSON text (YAML's
    flow subset, which both packages read) is parsed with json; anything
    else imports PyYAML."""
    text = Path(path).read_text()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text)


# ---------- the artifact store ----------


def _attr_value(v):
    return v.item() if isinstance(v, np.generic) else v


class _NpyAttrs(dict):
    """Attributes of one group or dataset, written to its JSON file on
    every change."""

    def __init__(self, path: Path):
        self._path = path
        super().__init__(json.loads(path.read_text()) if path.exists() else {})

    def __setitem__(self, key, value):
        super().__setitem__(key, _attr_value(value))
        self._path.write_text(json.dumps(self))


class NpyDataset:
    def __init__(self, path: Path):
        self._path = path

    @property
    def attrs(self):
        return _NpyAttrs(self._path.with_suffix(".attrs.json"))

    def __array__(self, dtype=None, copy=None):
        a = np.load(self._path)
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, idx):
        return np.load(self._path)[idx]


class NpyGroup:
    """A group of the directory store: a directory, with its datasets as
    `<name>.npy`, their attributes as `<name>.attrs.json` and its own as
    `.attrs.json`. Keys may be paths ("a/b") as in h5py."""

    def __init__(self, path: Path):
        self._path = path

    @property
    def attrs(self):
        return _NpyAttrs(self._path / ".attrs.json")

    def _find(self, key):
        p = self._path / key
        if p.is_dir():
            return NpyGroup(p)
        if p.with_name(p.name + ".npy").is_file():
            return NpyDataset(p.with_name(p.name + ".npy"))
        return None

    def __contains__(self, key):
        return self._find(key) is not None

    def __getitem__(self, key):
        obj = self._find(key)
        if obj is None:
            raise KeyError(key)
        return obj

    def __delitem__(self, key):
        obj = self[key]
        if isinstance(obj, NpyGroup):
            shutil.rmtree(obj._path)
        else:
            obj._path.unlink()
            obj._path.with_suffix(".attrs.json").unlink(missing_ok=True)

    def keys(self):
        names = set()
        for p in self._path.iterdir():
            if p.is_dir():
                names.add(p.name)
            elif p.name.endswith(".npy"):
                names.add(p.name[:-4])
        return sorted(names)

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def create_group(self, key):
        p = self._path / key
        if p.exists() or p.with_name(p.name + ".npy").exists():
            raise ValueError(f"{key} already exists in {self._path}")
        p.mkdir(parents=True)
        return NpyGroup(p)

    def create_dataset(self, key, data, **_storage):
        """_storage: h5py's compression options, which this format has not."""
        p = self._path / key
        p.parent.mkdir(parents=True, exist_ok=True)
        np.save(p.with_name(p.name + ".npy"), np.asarray(data), allow_pickle=False)
        return NpyDataset(p.with_name(p.name + ".npy"))

    def group_names_with_datasets(self):
        return sorted({str(p.parent.relative_to(self._path)) for p in self._path.rglob("*.npy")})


class NpyStore(NpyGroup):
    """The directory store's root, opened like h5py.File (modes r, a, w)."""

    def __init__(self, path, mode="r"):
        path = Path(path)
        if mode == "w" and path.exists():
            shutil.rmtree(path)
        if mode == "r" and not path.is_dir():
            raise FileNotFoundError(path)
        path.mkdir(parents=True, exist_ok=True)
        super().__init__(path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass


def open_store(path, mode="r"):
    """The artifact store at `path`, by its suffix: `.h5` an h5py.File,
    `.npyd` an NpyStore."""
    path = Path(path)
    if path.suffix == STORE_SUFFIX["h5"]:
        import h5py

        return h5py.File(str(path), mode, libver="latest")
    if path.suffix == STORE_SUFFIX["npy"]:
        return NpyStore(path, mode)
    raise ValueError(f"{path}: a store's suffix is one of {sorted(STORE_SUFFIX.values())}")


def store_path(directory, stem: str, fmt: str) -> Path:
    """`directory/stem` with the suffix of store format `fmt` (h5 | npy)."""
    if fmt not in STORE_SUFFIX:
        raise ValueError(f"cache_format {fmt!r} is not one of {sorted(STORE_SUFFIX)}")
    return Path(directory) / (stem + STORE_SUFFIX[fmt])


def is_group(obj) -> bool:
    """A group (h5py.Group/File or NpyGroup), not a dataset."""
    return hasattr(obj, "keys")


def pair_keys(path) -> set[str]:
    """The "name0/name1" keys of a pair store (two levels of groups)."""
    with open_store(path, "r") as f:
        return {f"{a}/{b}" for a in f.keys() if is_group(f[a]) for b in f[a].keys()}


def list_h5_names(path) -> list[str]:
    """Names of the groups that hold a dataset, in either store."""
    with open_store(path, "r") as fd:
        if isinstance(fd, NpyStore):
            return fd.group_names_with_datasets()
        names = []

        def visit_fn(_, obj):
            if not is_group(obj):
                names.append(obj.parent.name.strip("/"))

        fd.visititems(visit_fn)
    return list(set(names))


def write_features(path, name, keypoints, descriptors=None, scores=None, uncertainty=1.0, image_size=None, as_half=True):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open_store(path, "a") as fd:
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
    with open_store(path, "r") as hfile:
        dset = hfile[name]["keypoints"]
        p = np.asarray(dset).astype(np.float64)
        uncertainty = dset.attrs.get("uncertainty")
    if return_uncertainty:
        return p, uncertainty
    return p


def get_descriptors(path, name):
    with open_store(path, "r") as hfile:
        return np.asarray(hfile[name]["descriptors"]).astype(np.float32)


def find_pair(hfile, name0: str, name1: str):
    """(pair key, reversed) of a pair in an open store."""
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
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open_store(path, "a") as fd:
        pair = names_to_pair(name0, name1)
        if pair in fd:
            del fd[pair]
        grp = fd.create_group(pair)
        grp.create_dataset("matches0", data=np.asarray(matches0, np.int32))
        grp.create_dataset("matching_scores0", data=np.asarray(scores0, np.float16))


def get_matches(path, name0, name1):
    with open_store(path, "r") as hfile:
        pair, reverse = find_pair(hfile, name0, name1)
        matches = np.asarray(hfile[pair]["matches0"])
        scores = np.asarray(hfile[pair]["matching_scores0"])
    idx = np.where(matches != -1)[0]
    matches = np.stack([idx, matches[idx]], -1)
    if reverse:
        matches = np.flip(matches, -1)
    scores = scores[idx]
    return matches, scores


def write_mono_map(path, name, data: dict):
    """data keys per reference: depth, depth_variance, valid, normals,
    normals_variance, (depth2/... for flip passes)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open_store(path, "a") as fd:
        key = str(Path(name).name)
        if key in fd:
            del fd[key]
        grp = fd.create_group(key)
        for k, v in data.items():
            grp.create_dataset(k, data=np.asarray(v))


def get_mono_map(path, name):
    with open_store(path, "r") as f:
        key = str(Path(name).name)
        if key not in f:
            return None
        return {k: v[:] for k, v in f[key].items()}


def get_mono_map_from_pairs(path, name, pairs):
    """Per-pair two-view depth cache (MASt3R 'depth' mode): each pair group
    holds a depth/valid/variance triplet per image; pick the pair with the
    best mean confidence (reference utils/io.py:17-42)."""
    cname = str(Path(name).name)
    best = None
    best_score = -np.inf
    with open_store(path, "r") as f:
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
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open_store(path, "a") as f:
        base = names_to_pair(name0, name1)
        for img_name, data in per_image.items():
            key = f"{base}/{str(Path(img_name).name)}"
            if key in f:
                del f[key]
            grp = f.create_group(key)
            for k, v in data.items():
                grp.create_dataset(k, data=np.asarray(v))


def mono_names(path) -> set[str]:
    """The image names of a mono-map store."""
    with open_store(path, "r") as f:
        return set(f.keys())


def write_mask(path, name, mask):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open_store(path, "a") as fd:
        if name in fd:
            del fd[name]
        fd.create_group(name).create_dataset("mask", data=np.asarray(mask))


def get_mask(path, name):
    with open_store(path, "r") as file:
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
