"""The port's checkpoint manifests and weight resolution
(mpsfm_tpu_torch/extraction/manifest.py, weights.py).

The pinned manifests the port reads are byte-equal copies of the JAX
package's, and the port's own parameter builders (init_random, the
magicleap module, the LightGlue converter) produce exactly their key sets
and shapes; the diff and check behave as the JAX package's; a registered
checkpoint that is missing raises with its URL and is never fetched.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu.extraction import manifest as jman
from mpsfm_tpu.extraction import weights as jweights
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction import manifest as tman
from mpsfm_tpu_torch.extraction import weights as tweights

PORTED = ["superpoint", "lightglue", "netvlad", "metric3dv2-small", "metric3dv2-large", "metric3dv2-giant2", "dsine",
          "roma-outdoor", "roma-dinov2", "mast3r", "depthanythingv2-vitl", "depthpro"]


@pytest.mark.parametrize("name", PORTED)
def test_manifest_is_a_byte_equal_copy(name):
    assert (tman.MANIFEST_DIR / f"{name}.json").read_bytes() == (jman.MANIFEST_DIR / f"{name}.json").read_bytes()
    assert tman.load_manifest(name) == jman.load_manifest(name)


@pytest.mark.parametrize("name", ["superpoint", "lightglue", "netvlad"])
def test_builtin_builders_match_the_pinned_files(name):
    assert {k: list(v) for k, v in tman.BUILTIN[name]().items()} == tman.load_manifest(name)


def test_superpoint_module_and_lightglue_init_random_give_the_manifests():
    from mpsfm_tpu_torch.extraction.features.superpoint import SuperPointNet
    from mpsfm_tpu_torch.extraction.matchers.lightglue import LightGlue

    assert tman.manifest_from_params(SuperPointNet().state_dict()) == tman.load_manifest("superpoint")
    lg = LightGlue({"dim": 256, "num_heads": 4, "n_layers": 9}, device="cpu")
    lg.init_random(0)
    assert tman.manifest_from_params(convert.lightglue_state_dict(lg.params, 9)) == tman.load_manifest("lightglue")


def test_netvlad_init_random_gives_the_manifest_but_the_whitening():
    """init_random draws the backbone and the NetVLAD layer (no whitening,
    no mean), as the JAX package's does."""
    from mpsfm_tpu_torch.extraction.retrieval import _CONV_IDX, NetVLAD

    nv = NetVLAD(device="cpu")
    nv.init_random(0)
    p = nv.params
    sd = {f"backbone.{ti}.{s}": p[f"conv{i}"][n] for i, ti in enumerate(_CONV_IDX) for s, n in (("weight", "w"),
                                                                                                 ("bias", "b"))}
    sd["netvlad.score_proj.weight"] = p["assign_w"][:, :, None]
    sd["netvlad.centers"] = p["centers"].T
    man = tman.load_manifest("netvlad")
    assert tman.manifest_from_params(sd) == {k: v for k, v in man.items()
                                             if not k.startswith(("whiten", "preproc"))}


@pytest.mark.parametrize("enc,tag", [("vit_small_reg", "small"), ("vit_large_reg", "large"),
                                     ("vit_giant2_reg", "giant2")])
def test_metric3d_init_random_names_and_shapes_are_the_manifests(enc, tag):
    """param_shapes is what init_random draws, name for name; at small the
    draws themselves."""
    from mpsfm_tpu_torch.extraction.nets.metric3d import Metric3Dv2, param_shapes

    net = Metric3Dv2({"encoder": enc}, device="cpu")
    want = tman.load_manifest(f"metric3dv2-{tag}")
    assert {name: list(shape) for name, shape, _, _ in param_shapes(net.conf)} == want
    if tag == "small":
        assert tman.manifest_from_params(net.init_random(0)) == want


def test_diff_and_check_state_dict_as_the_jax_package():
    sd = {k: torch.zeros(v) for k, v in tman.load_manifest("superpoint").items()}
    assert tman.diff_state_dict(sd, tman.load_manifest("superpoint")) == {"missing": [], "unexpected": [],
                                                                          "mismatched": {}}
    tman.check_state_dict(sd, "superpoint")
    broken = dict(sd)
    broken.pop("convDb.weight")
    with pytest.raises(ValueError, match="convDb.weight"):
        tman.check_state_dict(broken, "superpoint")
    broken = dict(sd, **{"conv1a.weight": torch.zeros(64, 3, 3, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tman.check_state_dict(broken, "superpoint")
    extra = dict(sd, **{"optimizer.step": torch.zeros(1)})
    with pytest.warns(UserWarning):
        tman.check_state_dict(extra, "superpoint")
    with pytest.raises(ValueError):
        tman.check_state_dict(extra, "superpoint", ignore_unexpected=False)
    # the same diff as the JAX package's on numpy arrays
    arrays = {k: np.zeros(v, np.float32) for k, v in tman.load_manifest("lightglue").items()}
    arrays.pop("posenc.Wr.weight")
    arrays["input_proj.weight"] = np.zeros((3, 3), np.float32)
    assert tman.diff_state_dict(arrays, tman.load_manifest("lightglue")) == jman.diff_state_dict(
        arrays, jman.load_manifest("lightglue"))


def test_registry_equals_the_jax_registry():
    assert tweights.WEIGHT_REGISTRY == jweights.WEIGHT_REGISTRY


def test_missing_checkpoint_raises_with_its_url_and_never_downloads(tmp_path, monkeypatch):
    monkeypatch.setenv("MPSFM_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("MPSFM_ALLOW_DOWNLOAD", "1")  # the JAX package would fetch; the port does not
    fetched = []
    monkeypatch.setattr("urllib.request.urlretrieve", lambda *a, **k: fetched.append(a))
    url = tweights.WEIGHT_REGISTRY["lightglue"][1]
    with pytest.raises(FileNotFoundError) as e:
        tweights.resolve_weights("lightglue")
    assert url in str(e.value) and "never downloads" in str(e.value) and str(tmp_path) in str(e.value)
    with pytest.raises(FileNotFoundError, match="superpoint_v1.pth"):
        tweights.maybe_resolve("superpoint")
    assert fetched == [] and list(tmp_path.iterdir()) == []


def test_resolution_order_and_passthrough(tmp_path, monkeypatch):
    env_dir, arg_dir = tmp_path / "env", tmp_path / "arg"
    env_dir.mkdir()
    arg_dir.mkdir()
    monkeypatch.setenv("MPSFM_WEIGHTS_DIR", str(env_dir))
    (env_dir / "superpoint_v1.pth").write_bytes(b"x")
    assert tweights.resolve_weights("superpoint") == env_dir / "superpoint_v1.pth"
    (arg_dir / "superpoint_v1.pth").write_bytes(b"y")
    assert tweights.resolve_weights("superpoint", models_dir=arg_dir) == arg_dir / "superpoint_v1.pth"
    direct = tmp_path / "any.pth"
    direct.write_bytes(b"z")
    assert tweights.resolve_weights(str(direct)) == direct
    assert tweights.maybe_resolve("superpoint") == str(env_dir / "superpoint_v1.pth")
    assert tweights.maybe_resolve("no/such/file.pth") == "no/such/file.pth"
    assert tweights.maybe_resolve(None) is None
    with pytest.raises(KeyError, match="registered"):
        tweights.resolve_weights("no-such-net")
    monkeypatch.delenv("MPSFM_WEIGHTS_DIR")
    monkeypatch.chdir(tmp_path)
    assert tweights.default_models_dir() == tmp_path / "local" / "weights"


def test_registry_name_is_searched_in_the_env_dir_then_local_weights(tmp_path, monkeypatch):
    """With $MPSFM_WEIGHTS_DIR set, a file only in ./local/weights is still
    found; the search lists both places."""
    env_dir, local = tmp_path / "env", tmp_path / "local" / "weights"
    env_dir.mkdir()
    local.mkdir(parents=True)
    monkeypatch.setenv("MPSFM_WEIGHTS_DIR", str(env_dir))
    monkeypatch.chdir(tmp_path)
    (local / "superpoint_lightglue.pth").write_bytes(b"x")
    assert tweights.resolve_weights("lightglue") == local / "superpoint_lightglue.pth"
    assert tweights.search_dirs() == [env_dir, local]
    with pytest.raises(FileNotFoundError) as e:
        tweights.resolve_weights("netvlad")
    assert str(env_dir) in str(e.value) and str(local) in str(e.value)


def test_convert_checked_attaches_the_diff():
    def converter(sd):
        return {k: sd[k] for k in ("encoder.cls_token",)}

    with pytest.raises(ValueError, match="conversion failed for manifest 'metric3dv2-small'.*KeyError"):
        tman.convert_checked(converter, {"other": 1}, "metric3dv2-small")
    with pytest.raises(ValueError, match="does not match manifest 'metric3dv2-small'"):
        tman.convert_checked(converter, {"encoder.cls_token": torch.zeros(1, 1, 384)}, "metric3dv2-small")
