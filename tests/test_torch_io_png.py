"""The port's image and artifact IO on a host without OpenCV, h5py or
PyYAML (mpsfm_tpu_torch/utils/io.py):

- the PNG decoder against cv2.imread bit for bit: 8-bit gray, RGB and
  RGBA and 16-bit gray written by cv2.imwrite (read as grayscale, as
  colour and, for depth, at their own bit depth), each of the five row
  filters forced through a hand-made file, Paeth on one-row and
  one-column images, and chip_smoke.py's PNG writer (Paeth on every row)
  read back by both; the size from the header alone;
- the intrinsics in their JSON form, read alike by the port and PyYAML,
  and read (with a JSON conf) where PyYAML is missing;
- the directory store (cache_format npy) against HDF5, field by field:
  the same groups, datasets, dtypes and attributes for features, matches,
  mono maps, pair depth, masks, the TVG cache and the depth output.
"""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest
import yaml

import chip_smoke
import mpsfm_tpu.utils.io as jio
from mpsfm_tpu_torch.utils import io as tio

SHAPES = [(1, 1), (7, 13), (48, 64), (121, 97)]


def _write_cv2(path, img):
    assert cv2.imwrite(str(path), img)
    return path


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "gray16"])
@pytest.mark.parametrize("hw", SHAPES)
def test_png_decoder_equals_cv2(tmp_path, rng, kind, hw):
    """cv2.imwrite's files (adaptive filters) read by the port as the JAX
    package reads them through OpenCV: grayscale and RGB, bit for bit."""
    h, w = hw
    if kind == "gray16":
        img = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    else:
        ch = {"gray": (), "rgb": (3,), "rgba": (4,)}[kind]
        img = rng.integers(0, 256, (h, w, *ch), dtype=np.uint8)
        if kind != "gray":  # smooth regions too, where filters 1-4 win
            img[h // 2:] = np.cumsum(img[h // 2:], axis=1, dtype=np.uint8) // 3
    path = _write_cv2(tmp_path / f"{kind}.png", img)
    assert tio.image_size(path) == (w, h)  # from the header alone
    for gray in (True, False):
        ours, ref = tio.read_image(path, gray), jio.read_image(path, gray)
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        assert np.array_equal(ours, ref), (kind, gray)
    if kind in ("gray", "gray16"):
        assert np.array_equal(tio.read_depth_png(path), cv2.imread(str(path), cv2.IMREAD_ANYDEPTH))


def _filtered_png(img, ftype, channels, depth):
    """PNG bytes of img (uint8 rows as bytes) with every row forced to
    filter `ftype` (0 none, 1 sub, 2 up, 3 average, 4 Paeth), or each row
    its own filter (ftype None: row y takes y % 5)."""
    rows = (img.astype(">u2") if depth == 16 else img).reshape(img.shape[0], -1).view(np.uint8).astype(np.int64)
    h, stride = rows.shape
    bpp = channels * depth // 8
    out, prior = [], np.zeros(stride, np.int64)
    for y in range(h):
        f = y % 5 if ftype is None else ftype
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 0:
            pred = np.zeros_like(x)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(bytes([f]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prior = x
    ctype = {1: 0, 3: 2, 4: 6}[channels]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, ctype, 0, 0, 0)
    data = zlib.compress(b"".join(out))
    # the image data split over two IDAT chunks, as encoders may write it
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", data[:7]) + chunk(b"IDAT", data[7:])
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, None], ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("fmt", [(1, 8), (3, 8), (4, 8), (1, 16)], ids=["gray", "rgb", "rgba", "gray16"])
def test_png_decoder_each_filter(tmp_path, rng, ftype, fmt):
    """Each row filter forced through a hand-made file: the port decodes
    the pixels written, as OpenCV does."""
    channels, depth = fmt
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    img = rng.integers(0, 1 << depth, shape, dtype=np.uint16 if depth == 16 else np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, ftype, channels, depth))
    assert np.array_equal(tio.read_png(path), img)
    ref = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(tio.read_png(path), ref if channels == 1 else ref[..., [2, 1, 0, 3][:channels]])
    for gray in (True, False):
        assert np.array_equal(tio.read_image(path, gray), jio.read_image(path, gray))


@pytest.mark.parametrize("hw", [(1, 1), (1, 9), (9, 1)])
@pytest.mark.parametrize("fmt", [(1, 8), (3, 8), (4, 8), (1, 16)], ids=["gray", "rgb", "rgba", "gray16"])
def test_png_decoder_paeth_on_thin_images(tmp_path, rng, hw, fmt):
    """A single row or column, Paeth-filtered: the anti-diagonals of one
    pixel each, where Paeth reduces to sub (first row) or up (first
    column)."""
    channels, depth = fmt
    shape = hw if channels == 1 else (*hw, channels)
    img = rng.integers(0, 1 << depth, shape, dtype=np.uint16 if depth == 16 else np.uint8)
    path = tmp_path / "t.png"
    path.write_bytes(_filtered_png(img, 4, channels, depth))
    assert np.array_equal(tio.read_png(path), img)
    for gray in (True, False):
        assert np.array_equal(tio.read_image(path, gray), jio.read_image(path, gray))


def test_png_decoder_refuses_what_it_does_not_read(tmp_path):
    img = np.zeros((4, 5, 3), np.uint16)
    cv2.imwrite(str(tmp_path / "c16.png"), img)
    with pytest.raises(ValueError, match="16-bit colour"):
        tio.read_image(tmp_path / "c16.png", True)
    with pytest.raises(ValueError, match="not a PNG"):
        tio.decode_png(b"GIF89a")
    pal = (b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR" + struct.pack(">IIBBBBB", 1, 1, 8, 3, 0, 0, 0)
           + b"\0\0\0\0")
    with pytest.raises(ValueError, match="colour type 3"):
        tio.decode_png(pal)


def test_chip_smoke_png_writer_reads_back(tmp_path, rng):
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    (tmp_path / "w.png").write_bytes(chip_smoke.png_gray(img))
    data = zlib.decompress((tmp_path / "w.png").read_bytes()[41:-16])  # one IDAT after the IHDR
    assert set(np.frombuffer(data, np.uint8).reshape(37, 54)[:, 0]) == {4}  # every row Paeth-filtered
    assert np.array_equal(cv2.imread(str(tmp_path / "w.png"), cv2.IMREAD_UNCHANGED), img)
    assert np.array_equal(tio.read_image(tmp_path / "w.png", True), img)


def test_json_intrinsics_read_alike(tmp_path):
    """chip_smoke's intrinsics.yaml is JSON: the port reads it with json,
    PyYAML (the JAX package's reader) reads the same; YAML text still goes
    through PyYAML."""
    chip_smoke.render_rgbd_dir(tmp_path / "s", seed=1, n_images=2, img_wh=(40, 30), focal=35.0, baseline=0.3,
                               wedge=False)
    path = tmp_path / "s" / "intrinsics.yaml"
    ours = tio.read_intrinsics(path)
    assert ours == yaml.safe_load(path.read_text()) == {"1": {"params": [35.0, 35.0, 20.0, 15.0], "images": "all"}}
    ypath = tmp_path / "y.yaml"
    ypath.write_text(yaml.safe_dump({1: {"params": [1.0, 2.0, 3.0, 4.0], "images": ["a.png"]}}))
    assert tio.read_intrinsics(ypath) == {1: {"params": [1.0, 2.0, 3.0, 4.0], "images": ["a.png"]}}


def test_json_text_needs_no_yaml(tmp_path, monkeypatch):
    """With PyYAML missing (as on the card's host), JSON intrinsics and a
    JSON conf still load; YAML text then raises instead of being guessed."""
    import sys

    from mpsfm_tpu_torch.config import load_cfg

    (tmp_path / "conf.json").write_text(json.dumps(chip_smoke.PIPELINE_CONF))
    (tmp_path / "i.yaml").write_text('{"1": {"params": [1, 2, 3, 4], "images": "all"}}')
    (tmp_path / "y.yaml").write_text("a: 1\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert load_cfg(tmp_path / "conf.json").to_dict() == chip_smoke.PIPELINE_CONF
    assert tio.read_intrinsics(tmp_path / "i.yaml")["1"]["params"] == [1, 2, 3, 4]
    with pytest.raises(ImportError):
        load_cfg(tmp_path / "y.yaml")


def _fields(store, key=""):
    """{path: (dtype, shape, values) or attrs} of every dataset and group
    attribute under key in an open store."""
    out = {}
    node = store[key] if key else store
    attrs = dict(node.attrs)
    if attrs:
        out[key + "@"] = {k: (v.item() if isinstance(v, np.generic) else v) for k, v in attrs.items()}
    for k in node.keys():
        sub = f"{key}/{k}" if key else k
        if tio.is_group(node[k]):
            out.update(_fields(store, sub))
        else:
            a = np.asarray(node[k])
            out[sub] = (a.dtype, a.shape, a)
            da = dict(node[k].attrs)
            if da:
                out[sub + "@"] = {n: (v.item() if isinstance(v, np.generic) else v) for n, v in da.items()}
    return out


def test_store_holds_the_hdf5_fields(tmp_path, rng):
    """Every artifact written through the port's io functions into an .h5
    file and into an .npyd directory: the same groups, datasets, dtypes,
    shapes, values and attributes, read back alike."""
    from mpsfm_tpu_torch.estimators.two_view import TwoViewGeometry
    from mpsfm_tpu_torch.geometry.rotations import Rigid3d
    from mpsfm_tpu_torch.scene.correspondences import _TvgCache

    kps, desc, sc = rng.uniform(0, 100, (30, 2)), rng.normal(size=(30, 8)), rng.uniform(size=30)
    m0, s0 = np.where(rng.uniform(size=30) < 0.6, rng.integers(0, 25, 30), -1), rng.uniform(size=30)
    mono = {"depth": rng.uniform(1, 5, (6, 8)), "valid": rng.uniform(size=(6, 8)) > 0.3,
            "normals": rng.normal(size=(6, 8, 3)).astype(np.float32)}
    per = {n: {"depth": rng.uniform(1, 5, (4, 5)), "valid": np.ones((4, 5), bool),
               "variance": rng.uniform(0.1, 1, (4, 5))} for n in ("im0.jpg", "im1.jpg")}
    tvg = TwoViewGeometry(2, rng.integers(0, 30, (12, 2)), Rigid3d(rng.normal(size=4), rng.normal(size=3)), 3.5,
                          rng.normal(size=(3, 3)), 12)
    stores = {}
    for fmt in ("h5", "npy"):
        def p(stem):
            return tio.store_path(tmp_path / fmt, stem, fmt)

        tio.write_features(p("f"), "a/im0.jpg", kps, desc, sc, uncertainty=0.5, image_size=(640, 480))
        tio.write_features(p("f"), "im1.jpg", kps[:4], desc[:4], sc[:4], uncertainty=1.5)
        tio.write_matches(p("m"), "im0.jpg", "im1.jpg", m0, s0)
        tio.write_mono_map(p("d"), "dir/im0.jpg", mono)
        tio.write_pair_mono_map(p("pd"), "im0.jpg", "im1.jpg", per)
        tio.write_mask(p("k"), "im0.jpg", mono["valid"])
        cache = _TvgCache(p("tvg"))
        cache.put("im0.jpg", "im1.jpg", "digest0", tvg)
        cache.close()
        stores[fmt] = {}
        for stem in ("f", "m", "d", "pd", "k", "tvg"):
            with tio.open_store(p(stem)) as f:
                stores[fmt][stem] = _fields(f)
        assert sorted(tio.list_h5_names(p("f"))) == ["a/im0.jpg", "im1.jpg"]
        assert tio.pair_keys(p("m")) == {"im0.jpg/im1.jpg"}
        assert tio.mono_names(p("d")) == {"im0.jpg"}
        got = _TvgCache(p("tvg")).get("im0.jpg", "im1.jpg", "digest0")
        assert got.config == 2 and np.array_equal(got.inlier_matches, tvg.inlier_matches) and got.num_inliers == 12
        assert _TvgCache(p("tvg")).get("im0.jpg", "im1.jpg", "other") is None
    h5, npy = stores["h5"], stores["npy"]
    assert h5.keys() == npy.keys()
    for stem in h5:
        assert h5[stem].keys() == npy[stem].keys(), stem
        for k, a in h5[stem].items():
            b = npy[stem][k]
            if k.endswith("@"):
                assert a == b, (stem, k)
            else:
                assert a[0] == b[0] and a[1] == b[1] and np.array_equal(a[2], b[2]), (stem, k)


def test_store_is_picked_by_suffix(tmp_path):
    """The format comes from the path's suffix (and a conf's cache_format
    names the suffix); an unknown one raises, nothing is guessed."""
    assert tio.store_path(tmp_path, "x", "h5").suffix == ".h5"
    assert tio.store_path(tmp_path, "x", "npy").suffix == ".npyd"
    with pytest.raises(ValueError, match="cache_format"):
        tio.store_path(tmp_path, "x", "hdf")
    with pytest.raises(ValueError, match="suffix"):
        tio.open_store(tmp_path / "x.zip", "a")
    with tio.open_store(tmp_path / "s.npyd", "a") as f:
        f.create_group("g").create_dataset("v", data=np.arange(3))
        f["g"].attrs["n"] = np.int64(3)
    with tio.open_store(tmp_path / "s.npyd", "w") as f:  # "w" truncates, as h5py does
        assert f.keys() == []
    with pytest.raises(FileNotFoundError):
        tio.open_store(tmp_path / "none.npyd", "r")
