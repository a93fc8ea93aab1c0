"""Extraction on the port against the JAX package, on the CPU: the
classical detector, the mutual-NN matcher, the pair generators, the
measured priors, SimpleParser and the Extraction facade's caches.

The classical detector is held to the JAX function two ways. Against the
JAX function run op by op (jax.disable_jit) it agrees everywhere: the same
keypoints (as sets), within 1e-3 px, descriptors within 1e-4, scores
within 1e-4 relative. Against the JAX package's compiled function (what
its pipeline runs) the keypoint sets agree just as well, but XLA's fusion
moves the float32 values of the orientation histogram by an ulp, and the
histogram's parabolic refinement (its denominator hl - 2hp + hr is
negative at a peak and clamped to 1e-12) turns the angle into peak ± half
a bin by the sign of hl - hr: where the two neighbours of the peak are
equal to float32 order, the angle flips by a bin and the descriptor moves
by up to ~1e-2. The JAX package disagrees with itself, compiled against op
by op, at those keypoints (2-6% of them on the renders and the noise
images); the port is held within 1e-4 of the compiled function wherever
the JAX package agrees with itself within half of that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpsfm_tpu.extraction.features.classical as jc
from mpsfm_tpu.datasets.simple import SimpleParser as JParser
from mpsfm_tpu.extraction import pairs as jpairs
from mpsfm_tpu.extraction import priors as jpriors
from mpsfm_tpu.extraction.base import Extraction as JExtraction
from mpsfm_tpu.extraction.matchers.nn import MutualNNMatcher as JMatcher
from mpsfm_tpu.utils import io as jio
from mpsfm_tpu_torch.datasets.simple import SimpleParser as TParser
from mpsfm_tpu_torch.extraction import base as tbase
from mpsfm_tpu_torch.extraction import pairs as tpairs
from mpsfm_tpu_torch.extraction import priors as tpriors
from mpsfm_tpu_torch.extraction.base import Extraction as TExtraction
from mpsfm_tpu_torch.extraction.features.classical import ClassicalFeatures as TFeatures
from mpsfm_tpu_torch.extraction.features.classical import detect_describe
from mpsfm_tpu_torch.extraction.matchers.nn import MutualNNMatcher as TMatcher
from mpsfm_tpu_torch.utils import io as tio

from synthetic import PlaneScene, render_scene_dir
from test_extraction import checkerboard

# the Shi-Tomasi response min-eigenvalue cancels digits: 8.1e-6 relative between sum orders (noise image)
KP_TOL, DESC_TOL, SCORE_REL, COMMON = 1e-3, 1e-4, 1e-4, 0.99


@pytest.fixture(autouse=True)
def few_threads():
    """The tier-1 run shares the host's cores among its workers: torch's CPU
    ops take two threads in these tests, so that the workers do not
    oversubscribe the cores (results agree across thread counts to the
    tolerances below)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """tests/test_pipeline_e2e.py's render: 5 images of 320×240."""
    rng = np.random.default_rng(0)
    scene = PlaneScene(rng=rng, n_images=5, n_points=0, img_wh=(320, 240), focal=260.0, baseline=0.3)
    return render_scene_dir(scene, tmp_path_factory.mktemp("e2e") / "scene", rng=rng, depth_noise=0.01)


def corner_images():
    """The images of tests/test_extraction.py's detector tests."""
    import cv2

    base = np.random.default_rng(0).uniform(0, 1, (40, 50)).astype(np.float32)
    img1 = cv2.resize(base, (200, 160), interpolation=cv2.INTER_CUBIC)
    return {"checkerboard": (checkerboard(), 256), "noise": (img1, 512), "noise_shifted": (np.roll(img1, 12, 1), 512)}


def jax_features(img, max_kps, compiled):
    args = (jnp.asarray(img, jnp.float32), max_kps, 4, 1e-6, 8)
    if compiled:
        out = jc._detect_describe(*args)
    else:
        with jax.disable_jit():
            out = jc._detect_describe(*args)
    kps, vals, desc, valid = (np.asarray(x) for x in out)
    return kps[valid], vals[valid], desc[valid]


def pair_up(ka, kb):
    """For each of ka's keypoints, the nearest of kb's and its offset."""
    d = np.linalg.norm(ka[:, None] - kb[None], axis=-1)
    return d.argmin(1), d.min(1)


def compare(ref, ours):
    """(share of ref's keypoints that ours has within KP_TOL, largest offset
    of those, per-keypoint descriptor gap, largest relative score gap)."""
    nn, off = pair_up(ref[0], ours[0])
    common = off <= KP_TOL
    gap = np.abs(ref[2][common] - ours[2][nn[common]]).max(1)
    score = np.abs(ref[1][common] - ours[1][nn[common]]) / np.abs(ref[1][common])
    return common.mean(), off[common].max(), gap, score.max(), nn, common


def check_detector(img, max_kps):
    ours = TFeatures({"max_keypoints": max_kps}, device="cpu")(img)
    ours = (ours["keypoints"], ours["scores"], ours["descriptors"])
    eager, compiled = jax_features(img, max_kps, False), jax_features(img, max_kps, True)
    # op by op: everything agrees
    share, off, gap, score, _, _ = compare(eager, ours)
    assert len(ours[0]) == len(eager[0])
    assert share >= COMMON and off <= KP_TOL and gap.max() <= DESC_TOL and score <= SCORE_REL, (share, off, gap.max(),
                                                                                                score)
    # compiled: the same sets; descriptors wherever the JAX package agrees with itself
    share, off, gap, score, nn, common = compare(compiled, ours)
    assert share >= COMMON and off <= KP_TOL and score <= SCORE_REL, (share, off, score)
    enn, eoff = pair_up(compiled[0], eager[0])
    self_gap = np.abs(compiled[2] - eager[2][enn]).max(1)[common]
    # where the JAX package agrees with itself within half the tolerance (94-98% of the keypoints of
    # the noise images and the renders; 16-23 of ~800 on a render flip)
    stable = self_gap <= DESC_TOL / 2
    assert gap[stable].max() <= DESC_TOL, gap[stable].max()
    assert stable.mean() >= 0.9, stable.mean()
    return dict(share=share, off=off, desc_stable=gap[stable].max(), unstable=int((~stable).sum()), n=len(ours[0]))


@pytest.mark.parametrize("name", ["noise", "noise_shifted"])
def test_classical_features_match_jax_on_corner_images(name):
    img, max_kps = corner_images()[name]
    check_detector(img, max_kps)
    # no ties among the kept responses: torch.topk's order among equal values cannot matter here
    vals = TFeatures({"max_keypoints": max_kps}, device="cpu")(img)["scores"]
    assert len(np.unique(vals)) == len(vals)


def test_classical_features_on_the_checkerboard():
    """The checkerboard's corners are exact plateaus of the response: two
    or four pixels tie, and non-maximum suppression keeps all of them or
    one by the last ulp of the convolution's sums (XLA's keep the ties,
    F.conv2d's break some). The JAX package then spends its quota on
    duplicate pixels (192 keypoints at 45 positions), the port on fewer
    (132 at 54): every position of the JAX package's is one of the
    port's, within 1e-3 px."""
    img, max_kps = corner_images()["checkerboard"]
    ours = TFeatures({"max_keypoints": max_kps}, device="cpu")(img)["keypoints"]
    for compiled in (False, True):
        ref = np.unique(np.round(jax_features(img, max_kps, compiled)[0], 4), axis=0)
        _, off = pair_up(ref, ours)
        assert off.max() <= KP_TOL and len(np.unique(np.round(ours, 4), axis=0)) >= len(ref)


@pytest.mark.parametrize("index", [0, 3])
def test_classical_features_match_jax_on_the_e2e_render(scene_dir, index):
    img = tio.read_image(scene_dir / "images" / f"im{index:02d}.png", True).astype(np.float32) / 255
    out = check_detector(img, 1024)
    assert out["n"] > 500


def test_classical_features_batch_equals_one_by_one(scene_dir):
    """One batched call over same-shape images gives each image's own
    features up to the convolutions' sum order (a batch takes another CPU
    algorithm): the same keypoints within 1e-3 px, scores within 1e-4
    relative."""
    imgs = [tio.read_image(scene_dir / "images" / f"im{i:02d}.png", True).astype(np.float32) / 255 for i in range(3)]
    model = TFeatures({"max_keypoints": 512}, device="cpu")
    for a, b in zip(model.batch(imgs), [model(im) for im in imgs]):
        share, off, _, score, _, _ = compare((b["keypoints"], b["scores"], b["descriptors"]),
                                             (a["keypoints"], a["scores"], a["descriptors"]))
        assert len(a["keypoints"]) == len(b["keypoints"]) and share == 1.0 and off <= KP_TOL and score <= SCORE_REL
    out = detect_describe(torch.as_tensor(np.stack(imgs)), 1000, 4, 1e-6)
    assert out[0].shape == (3, 1000, 2) and out[2].shape == (3, 1000, 256)


def test_nn_matcher_matches_jax(scene_dir, rng):
    """Mutual NN with the ratio test, with a distance test, with neither:
    the port's matches equal the JAX package's, scores within 1e-6."""
    model = TFeatures({"max_keypoints": 1024}, device="cpu")
    d = [model(tio.read_image(scene_dir / "images" / f"im{i:02d}.png", True).astype(np.float32) / 255)["descriptors"]
         for i in (0, 1)]
    u = rng.normal(size=(300, 64)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    cases = [(d[0], d[1]), (d[1], d[0]), (u, u[::-1].copy()), (u[:1], u[1:40]), (u[:5], u[5:6])]
    for conf in ({}, {"ratio_threshold": 0.0}, {"ratio_threshold": 0.8, "distance_threshold": 0.7}):
        for a, b in cases:
            j, t = JMatcher(conf)(a, b), TMatcher(conf, device="cpu")(a, b)
            assert np.array_equal(j["matches0"], t["matches0"]), conf
            assert np.abs(j["matching_scores0"] - t["matching_scores0"]).max() <= 1e-6
    assert (TMatcher(device="cpu")(d[0], d[1])["matches0"] >= 0).sum() > 200
    empty = TMatcher(device="cpu")(u[:0], u)
    assert empty["matches0"].shape == (0,)


def test_pairs_equal_jax(rng):
    names = [f"im{i:02d}.png" for i in range(30)]
    assert tpairs.pairs_exhaustive(names) == jpairs.pairs_exhaustive(names)
    for overlap in (1, 2, 10):
        for quadratic in (True, False):
            assert tpairs.pairs_sequential(names, overlap, quadratic) == jpairs.pairs_sequential(names, overlap,
                                                                                                quadratic)
    descs = rng.normal(size=(30, 64))
    for k in (1, 5, 40):
        assert tpairs.pairs_from_retrieval(names, descs, k, device="cpu") == jpairs.pairs_from_retrieval(names, descs,
                                                                                                         k)


def test_measured_priors_equal_jax(rng):
    """normals_from_depth, the measured and the oracle backends: numpy
    copies, equal to 1e-12."""
    depth = rng.uniform(2, 5, (30, 40))
    depth[3, 4] = 0.0
    intr = (50.0, 52.0, 20.0, 15.0)
    assert np.abs(tpriors.normals_from_depth(depth, *intr) - jpriors.normals_from_depth(depth, *intr)).max() <= 1e-12
    for backend in ("measured", "oracle"):
        kw = {"depth_measured": depth, "intrinsics": intr} if backend == "measured" else {
            "depth_gt": depth, "normals_gt": rng.normal(size=(30, 40, 3)), "noise": 0.01}
        j = jpriors.get_prior_backend(backend)(None, **kw)
        t = tpriors.get_prior_backend(backend)(None, **kw)
        assert j.keys() == t.keys()
        for k in j:
            assert np.abs(np.asarray(j[k], np.float64) - np.asarray(t[k], np.float64)).max() <= 1e-12, (backend, k)
    with pytest.raises(tpriors.MissingWeightsError, match="depthpro"):  # the official width, no checkpoint
        tpriors.get_prior_backend("depthpro", device="cpu")(None)


def test_simple_parser_equals_jax(scene_dir, tmp_path):
    """Names, intrinsics, the Reconstruction skeleton and the prior inputs,
    .npy depth and 16-bit PNG depth (millimetres) alike."""
    import cv2

    j, t = JParser(scene_dir), TParser(scene_dir)
    assert j.image_names() == t.image_names()
    jr, tr = j.build_reconstruction(), t.build_reconstruction()
    assert jr.cameras.keys() == tr.cameras.keys()
    for cid, cam in jr.cameras.items():
        other = tr.cameras[cid]
        assert np.array_equal(cam.params, other.params)
        assert (cam.width, cam.height, cam.int_width, cam.int_height) == (other.width, other.height, other.int_width,
                                                                          other.int_height)
    assert {i: (im.name, im.camera_id) for i, im in jr.images.items()} == {
        i: (im.name, im.camera_id) for i, im in tr.images.items()}
    for name in j.image_names():
        a, b = j.prior_inputs(name), t.prior_inputs(name)
        assert a["intrinsics"] == b["intrinsics"] and np.array_equal(a["depth_measured"], b["depth_measured"])
    # 16-bit PNG depth
    (tmp_path / "images").mkdir()
    (tmp_path / "depth").mkdir()
    cv2.imwrite(str(tmp_path / "images" / "a.png"), np.zeros((6, 8), np.uint8))
    cv2.imwrite(str(tmp_path / "depth" / "a.png"), np.arange(48, dtype=np.uint16).reshape(6, 8) * 1000)
    (tmp_path / "intrinsics.yaml").write_text('{"1": {"params": [9, 9, 4, 3], "images": "all"}}')
    a, b = JParser(tmp_path).prior_inputs("a.png"), TParser(tmp_path).prior_inputs("a.png")
    assert np.array_equal(a["depth_measured"], b["depth_measured"]) and b["depth_measured"][5, 7] == 47.0


CONF = {"features": "classical", "matcher": "nn", "feature_conf": {"max_keypoints": 256}, "resize_max": 0,
        "matches_mode": "sparse+measured"}


def _loaded(ex, pairs):
    kps, matches, scores = ex.load_correspondence_inputs(pairs)
    mono = {n: ex.load_mono(n) for n in kps}
    return kps, matches, scores, mono


def _same(a, b):
    kps_a, m_a, s_a, mono_a = a
    kps_b, m_b, s_b, mono_b = b
    assert kps_a.keys() == kps_b.keys() and m_a.keys() == m_b.keys() and s_a.keys() == s_b.keys()
    for n in kps_a:
        assert np.array_equal(kps_a[n], kps_b[n])
        assert mono_a[n].keys() == mono_b[n].keys() and all(np.array_equal(mono_a[n][k], mono_b[n][k])
                                                            for k in mono_a[n])
    for k in m_a:
        assert np.array_equal(m_a[k], m_b[k]) and np.array_equal(s_a[frozenset(k)], s_b[frozenset(k)])


class NotCalled:
    def __call__(self, *a, **k):
        raise AssertionError("extraction ran although its cache was complete")

    batch = __call__


def test_extraction_caches_read_across_packages(scene_dir, tmp_path, monkeypatch):
    """The port's Extraction writes HDF5 caches that the JAX package's
    Extraction reads without extracting again, and the reverse; the
    directory store holds what the HDF5 files hold."""
    jparser, tparser = JParser(scene_dir), TParser(scene_dir)
    # port writes, JAX reads
    tex = TExtraction(CONF, tparser, tmp_path / "port", device="cpu")
    pairs = tex.extract_pairs()
    tex.extract_features()
    tex.extract_matches(pairs)
    tex.use_measured()
    jex = JExtraction(CONF, jparser, tmp_path / "port", models={"features": NotCalled(), "matcher": NotCalled()})
    assert jex.extract_pairs() == pairs
    jex.extract_features()
    jex.extract_matches(pairs)
    jex.paths["depth"] = tmp_path / "port" / "depth-measured.h5"
    _same(_loaded(tex, pairs), _loaded(jex, pairs))
    assert jio.get_keypoints(jex.paths["sfeats"], "im00.png", return_uncertainty=True)[1] == 1.5
    # JAX writes, port reads
    jex = JExtraction({**CONF, "sharded_inference": False}, jparser, tmp_path / "jax")
    jpairs_ = jex.extract_pairs()
    jex.extract_features()
    jex.extract_matches(jpairs_)
    jex.use_measured()
    with monkeypatch.context() as m:  # the port's models raise if they are built
        m.setitem(tbase.FEATURE_MODELS, "classical", lambda *a, **k: NotCalled())
        m.setitem(tbase.MATCHER_MODELS, "nn", lambda *a, **k: NotCalled())
        tex = TExtraction(CONF, tparser, tmp_path / "jax", device="cpu")
        tex.extract_features()
        tex.extract_matches(tex.extract_pairs())
    tex.paths["depth"] = tmp_path / "jax" / "depth-measured.h5"
    _same(_loaded(jex, jpairs_), _loaded(tex, jpairs_))
    # the directory store: the same inputs as the HDF5 files (features, matches, measured priors)
    npy = TExtraction({**CONF, "cache_format": "npy"}, tparser, tmp_path / "npy", device="cpu")
    npy.extract_features()
    npy.extract_matches(npy.extract_pairs())
    npy.use_measured()
    h5 = TExtraction(CONF, tparser, tmp_path / "port", device="cpu")
    h5.paths["depth"] = tmp_path / "port" / "depth-measured.h5"
    _same(_loaded(h5, pairs), _loaded(npy, pairs))


def test_extraction_refuses_what_is_not_ported(scene_dir, tmp_path):
    """Every backend is ported; without weights at the official width the
    vit_mono prior, the mast3r dense matcher and the depthanythingv2-outdoor
    prior raise MissingWeightsError (vit_mono's run at tiny widths is
    test_depthpro_and_vit_mono_stores_equal_jax), and at tests/test_mast3r.py's TINY width (the
    seeded draw both packages take) and on a tiny DepthAnythingV2
    checkpoint the run writes the JAX package's dense store (as sets) and
    depth store (within 1e-4 relative). DSINE and RoMa are ported: without
    weights, dsine-kappa-fc normals fall back to the depth-derived normals
    (the JAX package's store: no normals2) and the roma matcher raises
    MissingWeightsError naming both of its files."""
    from mpsfm_tpu.extraction.nets.depth_anything import DepthAnythingV2 as JDA2
    from mpsfm_tpu_torch import convert
    from test_mast3r import TINY
    from test_torch_depth_anything import METRIC

    parser = TParser(scene_dir)
    pair = [("im00.png", "im01.png")]
    with pytest.raises(tpriors.MissingWeightsError, match="vit_mono"):
        TExtraction({"depth": "vit_mono"}, parser, tmp_path / "c", device="cpu").extract_mono()
    with pytest.raises(tpriors.MissingWeightsError, match="MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth"):
        TExtraction({"dense_matcher": "mast3r"}, parser, tmp_path / "c", device="cpu").extract_dense_matches(pair)
    with pytest.raises(tpriors.MissingWeightsError, match="depthanythingv2-outdoor"):
        TExtraction({"depth": "depthanythingv2-outdoor"}, parser, tmp_path / "c", device="cpu").extract_mono()
    conf = {"dense_matcher": "mast3r", "dense_matcher_conf": TINY}
    tpath = TExtraction(conf, parser, tmp_path / "mast3r", device="cpu").extract_dense_matches(pair)
    jpath = JExtraction(conf, JParser(scene_dir), tmp_path / "mast3r-jax").extract_dense_matches(pair)
    (k0t, k1t, ct), (k0j, k1j, cj) = (tio.get_dense_pair(p, *pair[0]) for p in (tpath, jpath))
    kt, kj = np.concatenate([k0t, k1t], 1), np.concatenate([k0j, k1j], 1)
    it, ij = np.lexsort(kt.T[::-1]), np.lexsort(kj.T[::-1])
    assert len(it) == len(ij) > 0
    np.testing.assert_array_equal(kt[it], kj[ij])
    assert np.abs(ct[it] - cj[ij]).max() <= 1e-5
    j = JDA2(METRIC)
    j.init_random(0)
    torch.save(convert.depth_anything_state_dict({k: np.asarray(v) for k, v in j.params.items()}),
               tmp_path / "da2.pth")
    conf = {"depth": "depthanythingv2-outdoor", "depth_conf": {**METRIC, "weights_path": str(tmp_path / "da2.pth")}}
    tex = TExtraction(conf, parser, tmp_path / "da2", device="cpu")
    jex = JExtraction(conf, JParser(scene_dir), tmp_path / "da2-jax")
    tex.extract_mono()
    jex.extract_mono()
    for name in parser.image_names():
        got, want = tio.get_mono_map(tex.paths["depth"], name), jio.get_mono_map(jex.paths["depth"], name)
        assert got.keys() == want.keys() and "normals" in got
        for k in want:
            x, y = np.asarray(want[k]), np.asarray(got[k])
            tol = 1e-3 if k == "normals" else 1e-4 * np.abs(x).max()
            assert np.abs(x.astype(np.float64) - y).max() <= tol, (name, k)
    conf = {"depth": "measured", "normals": "dsine-kappa-fc", "normals_conf": {"weights_path": None}}
    tex = TExtraction(conf, parser, tmp_path / "dsine", device="cpu")
    jex = JExtraction(conf, JParser(scene_dir), tmp_path / "dsine-jax")
    tex.extract_mono()
    jex.extract_mono()
    for name in parser.image_names():
        got, want = tio.get_mono_map(tex.paths["depth"], name), jio.get_mono_map(jex.paths["depth"], name)
        assert got.keys() == want.keys() and "normals" in got and "normals2" not in got
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12, err_msg=k)
    with pytest.raises(tpriors.MissingWeightsError, match="roma_outdoor.pth.*dinov2_vitl14_pretrain.pth"):
        TExtraction({"dense_matcher": "roma"}, parser, tmp_path / "c", device="cpu").extract_dense_matches(
            [("im00.png", "im01.png")])
    assert tbase.Extraction({}, parser, tmp_path / "c", device="cpu").load_mask("im00.png") is None


@pytest.mark.parametrize("backend", ["depthpro", "vit_mono"])
def test_depthpro_and_vit_mono_stores_equal_jax(scene_dir, tmp_path, backend):
    """The two priors that raised before slice 17, at tiny widths on one
    checkpoint both packages load: DepthPro at tests/test_torch_depth_pro.py's
    TINY (the port's draw, its last layer's bias 1), MonoViT at
    tests/test_torch_mono.py's NET (the Flax init in the timm naming, with
    resize_long and flip-consistency). The depth stores of extract_mono
    hold the same keys, every map within 1e-4 of its largest value (the
    depth and its variance as the inverse depth they come from where the
    net is DepthPro), the validity masks equal."""
    from mpsfm_tpu.extraction.nets.mono import MonoViT as JMonoViT
    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.extraction.nets.depth_pro import DepthPro
    from mpsfm_tpu_torch.extraction.nets.train_mono import save_mono_params
    from test_torch_depth_pro import INVERSE, TINY as DP_TINY
    from test_torch_mono import NET

    if backend == "depthpro":
        net = DepthPro(DP_TINY, device="cpu")
        sd = convert.depth_pro_state_dict({k: v.numpy() for k, v in net.init_random(0).items()})
        sd["head.layers.4.bias"] = torch.ones(1)
        torch.save(sd, tmp_path / "depth_pro.pt")
        conf = {"depth": "depthpro", "depth_conf": {**DP_TINY, "weights_path": str(tmp_path / "depth_pro.pt")}}
        inverse = INVERSE
    else:
        params = JMonoViT(**NET).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        save_mono_params(convert.mono_state_dict(params), tmp_path / "mono.pth")
        conf = {"depth": "vit_mono", "depth_conf": {**NET, "weights_path": str(tmp_path / "mono.pth"),
                                                     "resize_long": 160, "flip_consistency": True}}
        inverse = {}
    parser = TParser(scene_dir)
    tex = TExtraction(conf, parser, tmp_path / "port", device="cpu")
    jex = JExtraction(conf, JParser(scene_dir), tmp_path / "jax")
    tex.extract_mono()
    jex.extract_mono()
    for name in parser.image_names()[:2]:
        got, want = tio.get_mono_map(tex.paths["depth"], name), jio.get_mono_map(jex.paths["depth"], name)
        assert got.keys() == want.keys() and {"depth", "depth_variance", "normals", "valid"} <= set(got)
        for k in want:
            x, y = np.asarray(want[k]), np.asarray(got[k])
            if x.dtype == bool:
                np.testing.assert_array_equal(x, y, err_msg=k)
                continue
            inv = inverse.get(k, lambda a: a)
            x, y = inv(x.astype(np.float64)), inv(y.astype(np.float64))
            assert np.abs(x - y).max() <= 1e-4 * np.abs(x).max(), (name, k)
