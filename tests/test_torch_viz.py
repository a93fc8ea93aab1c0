"""utils/viz.py and vars.py in the port against the JAX package's.

On twin reconstructions (tests/synthetic.PlaneScene's, registered at its
true poses with points, carried across by convert.reconstruction), at a
point budget above and below the scene's points (the subsample's draw):
write_scene_html and write_ply write the JAX package's bytes, and the
pipeline writes 3d.html at verbose >= 1 only. The scene lists are equal.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu import vars as jvars
from mpsfm_tpu.utils import viz as jviz
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch import vars as tvars
from mpsfm_tpu_torch.utils import viz as tviz

from synthetic import PlaneScene
from test_torch_scene import _triangulate_matches


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def twins():
    rj, _, matches, gt = PlaneScene(rng=np.random.default_rng(0), n_images=5, n_points=200).build(with_priors=False)
    _triangulate_matches(rj, matches, gt, stride=2)
    rj.deregister_image(4)
    return rj, convert.reconstruction(rj)


@pytest.mark.parametrize("budget", [None, 37])
def test_scene_html_and_ply_are_the_jax_bytes(twins, tmp_path, budget):
    rj, rt = twins
    kw = {} if budget is None else {"max_points": budget}
    for writer in ("write_scene_html", "write_ply"):
        pj = getattr(jviz, writer)(rj, tmp_path / "jax" / writer, **kw)
        pt = getattr(tviz, writer)(rt, tmp_path / "port" / writer, **kw)
        assert pt.read_bytes() == pj.read_bytes() and len(pt.read_bytes()) > 1000, writer
    assert rt.num_points3D() > 37


def test_pipeline_writes_3d_html_at_verbose_1(tmp_path):
    """reconstruct's outputs: 3d.html at verbose 1, none at 0 (the JAX
    package's pipeline.py:110-112), on the e2e scene's classical conf."""
    from synthetic import render_scene_dir

    from mpsfm_tpu_torch.pipeline import reconstruct

    rng = np.random.default_rng(0)
    scene = PlaneScene(rng=rng, n_images=3, n_points=0, img_wh=(320, 240), focal=260.0, baseline=0.3)
    data = render_scene_dir(scene, tmp_path / "scene", rng=rng, depth_noise=0.01)
    conf = {"matches_mode": "sparse+measured", "cache_format": "npy",
            "extractors": {"features": "classical", "matcher": "nn", "pairs_type": "exhaustive", "resize_max": 0,
                           "feature_conf": {"max_keypoints": 512}},
            "mapper": {"int_covs": False, "ba": {"max_iters": 5, "dist_ba": "off"}, "registration": {"num_hyp": 64}}}
    for verbose in (0, 1):
        out = tmp_path / f"out{verbose}"
        rec, _ = reconstruct(data, conf=conf, sfm_outputs_dir=out, verbose=verbose, device="cpu")
        assert (out / "3d.html").exists() == bool(verbose)
    html = (out / "3d.html").read_text()
    assert html.startswith("<!DOCTYPE html>") and '"cameras"' in html and rec.num_reg_images() >= 2


def test_scene_lists_equal_jax():
    names = [n for n in dir(jvars) if n.isupper()]
    assert names == [n for n in dir(tvars) if n.isupper()] and len(names) == 5
    for n in names:
        assert getattr(tvars, n) == getattr(jvars, n), n
