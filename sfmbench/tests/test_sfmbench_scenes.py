"""The renderer: the same (seed, scene) gives the same images, another seed
or scene other textures."""

import numpy as np
import torch

from sfmb import scenes

TRAFFIC = {"width": 96, "height": 72, "focal": 80.0, "baseline": 0.18, "wedge": True, "texture_res": 128}


def test_same_seed_same_scene(tmp_path):
    a = scenes.make_scene(tmp_path / "a", 2**31 + 17, 0, TRAFFIC, 2, torch.device("cpu"))
    b = scenes.make_scene(tmp_path / "b", 2**31 + 17, 0, TRAFFIC, 2, torch.device("cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a["images"], b["images"]))
    assert (tmp_path / "a" / "images" / "im00.png").read_bytes() == (tmp_path / "b" / "images" / "im00.png").read_bytes()


def test_other_seed_or_scene_other_textures(tmp_path):
    a = scenes.make_scene(tmp_path / "a", 5, 0, TRAFFIC, 2, torch.device("cpu"))
    b = scenes.make_scene(tmp_path / "b", 6, 0, TRAFFIC, 2, torch.device("cpu"))
    c = scenes.make_scene(tmp_path / "c", 5, 1, TRAFFIC, 2, torch.device("cpu"))
    assert not np.array_equal(a["images"][0], b["images"][0])
    assert not np.array_equal(a["images"][0], c["images"][0])
    assert a["images"][0].shape == (72, 96, 3) and a["images"][0].dtype == np.uint8


def test_png_is_read_back_exactly(tmp_path):
    from mpsfm_tpu_torch.utils.io import read_image

    a = scenes.make_scene(tmp_path / "a", 9, 0, TRAFFIC, 1, torch.device("cpu"))
    assert np.array_equal(read_image(tmp_path / "a" / "images" / "im00.png"), a["images"][0])
