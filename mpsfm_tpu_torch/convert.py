"""State of the JAX package, given as numpy arrays, turned into the port's.

What carries over is the state the JAX package hands between its device
programs, its cameras and poses, the depth-consistency check's grids and
per-pair rows, the scene's host state, and the weights of the neural
extraction (SuperPoint, LightGlue, NetVLAD, Metric3Dv2, DSINE, RoMa, MASt3R,
DepthAnythingV2, DepthPro, the two-view and warp nets, MonoViT), as the checkpoint layouts the
port loads. Each device converter takes host arrays, e.g.
`{k: np.asarray(v) for k, v in nt._asdict().items()}` of a JAX NamedTuple,
and returns tensors on `device` (the card unless the caller asks for the
CPU; no GPU raises, see `resolve_device`); `reconstruction` builds the
port's host-side Reconstruction, `image_priors` the per-image prior
state attached to it and `correspondences` its verified pairs.
"""

from __future__ import annotations

import copy
from dataclasses import fields

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.ba.dense import DenseBAData
from mpsfm_tpu_torch.ba.schur_sparse import BlockSchurTables, tables_to
from mpsfm_tpu_torch.ba.solver import BAData
from mpsfm_tpu_torch.geometry.projection import Camera
from mpsfm_tpu_torch.geometry.rotations import Rigid3d
from mpsfm_tpu_torch.integration.bini import BiniInputs, BiniParams
from mpsfm_tpu_torch.mapper.depth_consistency import pair_rows
from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Pose, Reconstruction


def _f32(a, dev):
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def dense_ba_data(arrays: dict, device="cuda") -> DenseBAData:
    """mpsfm_tpu.ba.dense.DenseBAData fields -> DenseBAData of float32 tensors."""
    dev = resolve_device(device)
    return DenseBAData(**{f: _f32(arrays[f], dev) for f in DenseBAData._fields})


def ba_data(arrays: dict, device="cuda") -> BAData:
    """mpsfm_tpu.ba.solver.BAData fields -> BAData: float fields float32,
    index fields (integer arrays) int64, absent optional tables None; the
    block-sparse Schur tables `bs` (any object with BlockSchurTables'
    fields, e.g. the JAX package's) by schur_sparse.tables_to."""
    dev = resolve_device(device)
    bs = arrays.get("bs")
    if bs is not None:
        bs = tables_to(BlockSchurTables(*(getattr(bs, f) for f in BlockSchurTables._fields)), dev)

    def conv(a):
        if a is None:
            return None
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a.astype(np.int64), device=dev)
        return _f32(a, dev)

    return BAData(**{f: conv(arrays.get(f)) for f in BAData._fields if f != "bs"}, bs=bs)


def parts(jparts: dict) -> dict:
    """mpsfm_tpu.parallel.dist_ba.partition_ba_data's parts -> the port's:
    the same layout ("repl" and "shard" dicts of arrays, "n_bs_buckets"
    when the block-Schur tables exist), every array a numpy copy; the
    port's solve_ba_block_sharded uploads each rank's shard itself."""
    out = {key: {k: np.array(v) for k, v in jparts[key].items()} for key in ("repl", "shard")}
    if "n_bs_buckets" in jparts:
        out["n_bs_buckets"] = int(jparts["n_bs_buckets"])
    return out


def bini_inputs(arrays: dict, device="cuda") -> BiniInputs:
    """mpsfm_tpu.integration.bini.BiniInputs fields, (H,W) or (B,H,W) each
    -> BiniInputs of float32 tensors of the same shapes."""
    dev = resolve_device(device)
    return BiniInputs(**{f: _f32(arrays[f], dev) for f in BiniInputs._fields})


def bini_params(fields: dict) -> BiniParams:
    """mpsfm_tpu.integration.bini.BiniParams fields -> BiniParams (host scalars)."""
    return BiniParams(**{f: fields[f] for f in BiniParams._fields if f in fields})


def anchor_state(anch, prev, cov, pairs, device="cuda"):
    """Arguments of bini_gate_solve_batch_anchors: anchor rows anch (B,6,Ka),
    gate state prev (B,2), point covariances cov (Pc,3,3) and the cached
    (z0 (H,W), stat8 (8,H,W)) pair of each lane -> (anch, prev, cov, pairs)
    as float32 tensors."""
    dev = resolve_device(device)
    return (
        _f32(anch, dev),
        _f32(prev, dev),
        _f32(cov, dev),
        [(_f32(z0, dev), _f32(stat8, dev)) for z0, stat8 in pairs],
    )


def camera(fields: dict, device="cuda") -> Camera:
    """mpsfm_tpu.geometry.projection.Camera fields (fx, fy, cx, cy as arrays,
    width and height as ints) -> Camera of float32 tensors."""
    dev = resolve_device(device)
    return Camera(*(_f32(fields[f], dev) for f in ("fx", "fy", "cx", "cy")),
                  int(fields.get("width", 0)), int(fields.get("height", 0)))


def rigid(quat, t, device="cuda") -> Rigid3d:
    """A pose (quat (..., 4) wxyz, t (..., 3)) -> Rigid3d of float32 tensors."""
    dev = resolve_device(device)
    return Rigid3d(_f32(quat, dev), _f32(t, dev))


def dc_inputs(query, refs, device="cuda"):
    """The arguments of depth_consistency._bundle_counts (all but c and the
    threshold) for a query image against refs of one grid shape, as the JAX
    checker's check_bundle_depth_consistency builds them: each image is
    (depth (H, W), variance (H, W) already divided by prior_std_multiplier²,
    K (3, 3) at grid scale, quat, t) with a cam_from_world pose, and every
    factor is 1. Returns (d_q, var_q, K_q, fac_q (2,), d_r (B, H, W), var_r,
    K_r (B, 3, 3), rows (B, 32)) on `device`."""
    dev = resolve_device(device)
    rows = pair_rows(query[3:], [r[3:] for r in refs])
    return (*(_f32(a, dev) for a in query[:3]), _f32(np.ones(2), dev),
            *(_f32(np.stack([r[i] for r in refs]), dev) for i in range(3)), _f32(rows, dev))


def reconstruction(rec) -> Reconstruction:
    """The host state of a JAX package Reconstruction, read duck-typed
    (plain attributes, numpy arrays and `rec.tracks[pid]`), as the port's
    Reconstruction: every camera field; every image field (keypoints,
    pose, registered, point3D_ids, ...; attributes set outside the
    dataclass, such as priors, are not carried); and the point pool, where
    every slot below the pool's high-water mark keeps its point id, xyz and
    track in the same observation order, so alive, track_len, point3D_ids
    and observations() equal the source's. A dead slot is allocated with a
    one-observation placeholder on a keypoint that no point observes, and
    the placeholders are deleted at the end, highest id first: the next
    added points take the lowest free ids first, which need not be the
    source's free-list order."""
    out = Reconstruction()
    for cam in rec.cameras.values():
        out.add_camera(HostCamera(**{f.name: copy.deepcopy(getattr(cam, f.name)) for f in fields(HostCamera)}))
    for im in rec.images.values():
        kw = {f.name: copy.deepcopy(getattr(im, f.name)) for f in fields(ImageRecord)}
        if im.pose is not None:
            kw["pose"] = Pose(np.array(im.pose.q, np.float64), np.array(im.pose.t, np.float64))
        kw["point3D_ids"] = np.full(len(im.point3D_ids), -1, np.int64)  # filled by the point adds below
        out.add_image(ImageRecord(**kw))

    unobserved = ((imid, int(kp)) for imid, im in rec.images.items()
                  for kp in np.flatnonzero(np.asarray(im.point3D_ids) < 0))
    holes = []
    for pid in range(int(rec._num_points)):
        if rec.alive[pid]:
            track = rec.tracks[pid]
        else:
            track = [next(unobserved, None)]
            if track[0] is None:
                raise ValueError("reconstruction: too few unobserved keypoints to hold the pool's dead slots")
            holes.append(pid)
        got = out.add_point3D(np.asarray(rec.xyz[pid], np.float64), track)
        if got != pid:
            raise ValueError(f"reconstruction: slot {pid} of the source came out as {got}; its tracks disagree "
                             "with its images' point3D_ids")
    for pid in reversed(holes):
        out.delete_point3D(pid)
    out.xyz[: len(out.alive)] = np.asarray(rec.xyz, np.float64)[: len(out.alive)]  # dead slots keep their xyz
    return out


def image_priors(pri, rec, device="cuda"):
    """A JAX package ImagePriors' state, read duck-typed, as a port
    ImagePriors on `rec` (a port Reconstruction, e.g. from
    `reconstruction`) with its device rows on `device`: the conf; every
    Depth and Normals attribute (arrays copied; a device working map
    `_data_dev` read once to the host and put on `device`, its lazy host
    copy `_data` kept as the source has it); the Integrator's params,
    energy_old and integrated. The device caches start empty. Sets
    rec.images[imid].priors, .depth and .normals, as the JAX pipeline
    attaches them."""
    from mpsfm_tpu_torch.config import Config
    from mpsfm_tpu_torch.integration.bini import Integrator
    from mpsfm_tpu_torch.scene.image_priors import ImagePriors
    from mpsfm_tpu_torch.scene.priors import Depth, Normals

    dev = resolve_device(device)

    def state(src, cls):
        out = cls.__new__(cls)
        for k, v in vars(src).items():
            if k == "conf":
                v = Config.create(copy.deepcopy(dict(v)))
            elif k == "_data_dev":
                v = None if v is None else torch.tensor(np.asarray(v), device=dev)
            else:
                v = copy.deepcopy(v)
            setattr(out, k, v)
        return out

    out = ImagePriors.__new__(ImagePriors)
    out.conf = Config.create(copy.deepcopy(dict(pri.conf)))
    out.device = dev
    out.rec = rec
    out.imid = pri.imid
    out.depth = state(pri.depth, Depth)
    out.normals = state(pri.normals, Normals)
    out.integrator = Integrator(bini_params(pri.integrator.params._asdict()), device=dev)
    out.integrator.energy_old = pri.integrator.energy_old
    out.integrator.integrated = pri.integrator.integrated
    if hasattr(pri, "int_covs_applied"):
        out.int_covs_applied = pri.int_covs_applied
    out._reset_caches()
    im = rec.images[pri.imid]
    im.priors, im.depth, im.normals = out, out.depth, out.normals
    return out


def correspondences(corr, rec, device="cuda"):
    """A populated Correspondences of either package, read duck-typed, as a
    port Correspondences on `rec` (a port Reconstruction, e.g. from
    `reconstruction`) whose RANSACs would run on `device`: the conf, each
    pair's two-view geometry (config, inlier matches, pose as numpy,
    tri_angle, E, inlier count), the correspondence graph built from the
    same inlier matches in the same order, and the inlier match scores."""
    from mpsfm_tpu_torch.config import Config
    from mpsfm_tpu_torch.estimators.two_view import TwoViewGeometry
    from mpsfm_tpu_torch.scene.correspondences import Correspondences

    out = Correspondences(Config.create(copy.deepcopy(dict(corr.conf))).to_dict(), rec, device=device)
    for imid, n in corr.cg._num_kps.items():
        out.cg.add_image(imid, n)
    for (i, j), g in corr._tvg.items():
        pose = Rigid3d(np.array(g.pose.quat), np.array(g.pose.t))
        E = None if g.E is None else np.array(g.E)
        out._tvg[(i, j)] = TwoViewGeometry(int(g.config), np.asarray(g.inlier_matches).copy(), pose,
                                            g.tri_angle, E, g.num_inliers)
    for (i, j), m in corr.cg._pair_matches.items():
        out.cg.add_correspondences(i, j, np.asarray(m).copy())
    out.inlier_match_scores = dict(corr.inlier_match_scores)
    out.cg.finalize()
    return out


# ---- weights of the neural extraction: the JAX package's params -> the official checkpoint layouts ----

def _cpu32(a):
    return torch.tensor(np.asarray(a, np.float32))


def superpoint_state_dict(jparams) -> dict:
    """JAX SuperPoint flax params ({"params": {conv: {kernel (kh,kw,in,out),
    bias}}}) -> the magicleap superpoint_v1.pth state dict (weights
    (out,in,kh,kw)) on the CPU."""
    sd = {}
    for name, p in jparams["params"].items():
        sd[f"{name}.weight"] = _cpu32(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
        sd[f"{name}.bias"] = _cpu32(p["bias"])
    return sd


def lightglue_state_dict(jparams, n_layers) -> dict:
    """JAX LightGlue params (input_proj, Wr, self_{l}, cross_{l},
    final_proj, matchability) -> the official superpoint_lightglue.pth
    state dict under the post-rename names (transformers.{l}.*), on the
    CPU; the JAX params_from_torch_state_dict maps it back to the same
    arrays."""
    sd = {}

    def dense(prefix, p):
        sd[f"{prefix}.weight"] = _cpu32(p["w"])
        sd[f"{prefix}.bias"] = _cpu32(p["b"])

    dense("input_proj", jparams["input_proj"])
    sd["posenc.Wr.weight"] = _cpu32(jparams["Wr"])
    for l in range(n_layers):
        base = f"transformers.{l}"
        sp, cp = jparams[f"self_{l}"], jparams[f"cross_{l}"]
        for blk, p, names in ((f"{base}.self_attn", sp, (("Wqkv", "Wqkv"), ("out", "out_proj"))),
                              (f"{base}.cross_attn", cp, (("to_qk", "to_qk"), ("to_v", "to_v"), ("out", "to_out")))):
            for src, dst in names:
                dense(f"{blk}.{dst}", p[src])
            dense(f"{blk}.ffn.0", p["ffn0"])
            sd[f"{blk}.ffn.1.weight"] = _cpu32(p["ffn_ln_g"])
            sd[f"{blk}.ffn.1.bias"] = _cpu32(p["ffn_ln_b"])
            dense(f"{blk}.ffn.3", p["ffn1"])
    dense(f"log_assignment.{n_layers - 1}.final_proj", jparams["final_proj"])
    dense(f"log_assignment.{n_layers - 1}.matchability", jparams["matchability"])
    return sd


def netvlad_params(jparams) -> dict:
    """JAX NetVLAD params (conv{i} {w (3,3,I,O), b}, assign_*, centers,
    whiten_*, preproc_mean) -> the port's param dict of host arrays
    (conv kernels (O,I,3,3)); NetVLAD._to_device puts it on a device."""
    out = {}
    for k, v in jparams.items():
        if isinstance(v, dict):
            out[k] = {"w": np.ascontiguousarray(np.transpose(np.asarray(v["w"], np.float32), (3, 2, 0, 1))),
                      "b": np.asarray(v["b"], np.float32)}
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def metric3d_state_dict(jparams, prefix="") -> dict:
    """JAX Metric3Dv2 params (a flat dict under the official names) -> a
    state dict of CPU tensors with the same names (an identity on names),
    each key preceded by `prefix` (the checkpoint's "depth_model.")."""
    return {prefix + k: _cpu32(v) for k, v in jparams.items()}


def dsine_state_dict(jparams) -> dict:
    """JAX DSINE params (a flat dict under the official names) -> the
    official dsine.pth state dict of CPU tensors (an identity on names)."""
    return {k: _cpu32(v) for k, v in jparams.items()}


def roma_state_dicts(jparams) -> tuple[dict, dict]:
    """JAX RomaNet params -> the two official files' state dicts of CPU
    tensors: roma_outdoor.pth (every key but ``dinov2.*``) and
    dinov2_vitl14_pretrain.pth (the ``dinov2.*`` keys without the prefix)."""
    outdoor = {k: _cpu32(v) for k, v in jparams.items() if not k.startswith("dinov2.")}
    dinov2 = {k[len("dinov2."):]: _cpu32(v) for k, v in jparams.items() if k.startswith("dinov2.")}
    return outdoor, dinov2


def mast3r_state_dict(jparams) -> dict:
    """JAX Mast3rNet params (a flat dict under the official names) -> the
    MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth state dict of CPU
    tensors (an identity on names)."""
    return {k: _cpu32(v) for k, v in jparams.items()}


def depth_anything_state_dict(jparams) -> dict:
    """JAX DepthAnythingV2 params (a flat dict under the official names) ->
    the depth_anything_v2_*.pth state dict of CPU tensors (an identity on
    names)."""
    return {k: _cpu32(v) for k, v in jparams.items()}


def depth_pro_state_dict(jparams) -> dict:
    """JAX DepthPro params (a flat dict under the HF names) -> a state dict
    of CPU tensors with the same names, the checkpoint layout the port's
    DepthPro loads (an identity on names)."""
    return {k: _cpu32(v) for k, v in jparams.items()}


def flax_state_dict(jparams) -> dict:
    """A Flax param tree ({"params": {module: {...}}} or its inner dict) ->
    the state dict of the port's torch modules that carry the Flax names
    (nets/vit.py, dpt.py, two_view.py, warp.py): the path joined by dots,
    Dense kernels (in, out) transposed to (out, in), Conv kernels HWIO to
    OIHW, LayerNorm scales as weights; other leaves (position embeddings,
    class tokens) as they are. CPU tensors."""
    tree = jparams.get("params", jparams)
    sd = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                k, a = "weight", (a.T if a.ndim == 2 else np.transpose(a, (3, 2, 0, 1)))
            elif k == "scale":
                k = "weight"
            sd[prefix + k] = _cpu32(np.ascontiguousarray(a))

    walk(tree, "")
    return sd


# JAX TwoViewNet, WarpNet and MonoViT params (Flax trees) -> nets/two_view.TwoViewNet's, nets/warp.WarpNet's and
# nets/mono.MonoViT's state dicts
two_view_state_dict = warp_state_dict = mono_state_dict = flax_state_dict
