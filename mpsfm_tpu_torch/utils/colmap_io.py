"""COLMAP text + binary reconstruction writer/reader (port of
mpsfm_tpu/utils/colmap_io.py).

Matches the reference's output format (MpsfmReconstruction.write writes a
COLMAP-format reconstruction + gzip'd depths.h5 — reference
scene/reconstruction/base.py:123-141; pycolmap writes the BINARY format
by default) so downstream COLMAP tooling and parity checks work on our
outputs. The binary layout follows COLMAP's reconstruction serialization
(cameras.bin / images.bin / points3D.bin, little-endian; invalid
point3D_id is uint64 max).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from mpsfm_tpu_torch.scene.reconstruction import HostCamera, ImageRecord, Pose, Reconstruction
from mpsfm_tpu_torch.utils.io import open_store

# COLMAP camera model ids (src/colmap/sensor/models.h)
_MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2, "RADIAL": 3, "OPENCV": 4}
_MODEL_NAMES = {v: k for k, v in _MODEL_IDS.items()}
_MODEL_NPARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8}
_INVALID_P3D = 2**64 - 1


def write_text(rec: Reconstruction, out_dir):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    with open(out / "cameras.txt", "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cid, cam in sorted(rec.cameras.items()):
            params = " ".join(f"{p:.12g}" for p in cam.params[:4])
            f.write(f"{cid} PINHOLE {cam.width} {cam.height} {params}\n")

    with open(out / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for imid, im in sorted(rec.images.items()):
            if not im.registered:
                continue
            q = im.pose.q
            t = im.pose.t
            f.write(
                f"{imid + 1} {q[0]:.12g} {q[1]:.12g} {q[2]:.12g} {q[3]:.12g} "
                f"{t[0]:.12g} {t[1]:.12g} {t[2]:.12g} {im.camera_id} {im.name}\n"
            )
            obs = []
            for kp in range(len(im.keypoints)):
                pid = im.point3D_ids[kp]
                obs.append(
                    f"{im.keypoints[kp, 0]:.6g} {im.keypoints[kp, 1]:.6g} "
                    f"{pid + 1 if pid >= 0 else -1}"
                )
            f.write(" ".join(obs) + "\n")

    with open(out / "points3D.txt", "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        err_of = _point_errors(rec)
        for pid in rec.point_ids():
            xyz = rec.xyz[pid]
            track = " ".join(f"{imid + 1} {kp}" for imid, kp in rec.tracks[pid])
            f.write(
                f"{pid + 1} {xyz[0]:.12g} {xyz[1]:.12g} {xyz[2]:.12g} "
                f"128 128 128 {err_of[pid]:.6g} {track}\n"
            )


def _point_errors(rec: Reconstruction):
    (o_pid, o_im, o_kp), err = rec._point_reproj_errors(rec.point_ids())
    err_of = {}
    for pid in rec.point_ids():
        sel = o_pid == pid
        err_of[pid] = float(np.sqrt(np.clip(err[sel], 0, 1e12)).mean()) if sel.any() else 0.0
    return err_of


def write_binary(rec: Reconstruction, out_dir):
    """COLMAP binary reconstruction (cameras.bin / images.bin /
    points3D.bin) — drop-in for downstream COLMAP tooling, matching the
    reference's pycolmap `rec.write` output
    (mpsfm/sfm/scene/reconstruction/base.py:135-141). Ids follow the
    text writer's convention: image/point ids are written 1-based."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    with open(out / "cameras.bin", "wb") as f:
        cams = sorted(rec.cameras.items())
        f.write(struct.pack("<Q", len(cams)))
        for cid, cam in cams:
            f.write(struct.pack("<iiQQ", cid, _MODEL_IDS["PINHOLE"], int(cam.width), int(cam.height)))
            f.write(struct.pack("<4d", *[float(p) for p in cam.params[:4]]))

    with open(out / "images.bin", "wb") as f:
        reg = [(imid, im) for imid, im in sorted(rec.images.items()) if im.registered]
        f.write(struct.pack("<Q", len(reg)))
        for imid, im in reg:
            q, t = im.pose.q, im.pose.t
            f.write(struct.pack("<i", imid + 1))
            f.write(struct.pack("<4d", *[float(x) for x in q]))
            f.write(struct.pack("<3d", *[float(x) for x in t]))
            f.write(struct.pack("<i", int(im.camera_id)))
            f.write(im.name.encode() + b"\x00")
            n_kp = len(im.keypoints)
            f.write(struct.pack("<Q", n_kp))
            pids = np.where(
                im.point3D_ids >= 0, im.point3D_ids.astype(np.uint64) + 1,
                np.uint64(_INVALID_P3D),
            )
            row = np.empty(n_kp, dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<u8")])
            row["x"], row["y"], row["pid"] = im.keypoints[:, 0], im.keypoints[:, 1], pids
            f.write(row.tobytes())

    with open(out / "points3D.bin", "wb") as f:
        pids = rec.point_ids()
        err_of = _point_errors(rec)
        f.write(struct.pack("<Q", len(pids)))
        for pid in pids:
            xyz = rec.xyz[pid]
            f.write(struct.pack("<Q", int(pid) + 1))
            f.write(struct.pack("<3d", *[float(x) for x in xyz]))
            f.write(struct.pack("<3B", 128, 128, 128))
            f.write(struct.pack("<d", err_of[pid]))
            track = rec.tracks[pid]
            f.write(struct.pack("<Q", len(track)))
            for imid, kp in track:
                f.write(struct.pack("<ii", imid + 1, int(kp)))


def read_binary(in_dir) -> Reconstruction:
    """Load a COLMAP binary reconstruction (ours or any COLMAP-written
    model with a supported camera model)."""
    in_dir = Path(in_dir)
    rec = Reconstruction()

    with open(in_dir / "cameras.bin", "rb") as f:
        (n_cams,) = struct.unpack("<Q", f.read(8))
        for _ in range(n_cams):
            cid, model_id, W, H = struct.unpack("<iiQQ", f.read(24))
            n_par = _MODEL_NPARAMS[model_id]
            params = np.asarray(struct.unpack(f"<{n_par}d", f.read(8 * n_par)))
            if _MODEL_NAMES[model_id] == "SIMPLE_PINHOLE":
                params = np.asarray([params[0], params[0], params[1], params[2]])
            else:
                params = params[:4]
            rec.add_camera(HostCamera(cid, params, int(W), int(H)))

    with open(in_dir / "images.bin", "rb") as f:
        (n_ims,) = struct.unpack("<Q", f.read(8))
        for _ in range(n_ims):
            (img_id,) = struct.unpack("<i", f.read(4))
            q = np.asarray(struct.unpack("<4d", f.read(32)))
            t = np.asarray(struct.unpack("<3d", f.read(24)))
            (cam_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_kp,) = struct.unpack("<Q", f.read(8))
            row = np.frombuffer(
                f.read(24 * n_kp), dtype=[("x", "<f8"), ("y", "<f8"), ("pid", "<u8")]
            )
            im = ImageRecord(img_id - 1, name.decode(), cam_id)
            im.pose = Pose(q, t)
            im.registered = True
            im.keypoints = np.stack([row["x"], row["y"]], -1) if n_kp else np.zeros((0, 2))
            im.point3D_ids = np.full(n_kp, -1, np.int64)
            rec.add_image(im)

    pts_path = in_dir / "points3D.bin"
    if pts_path.exists():
        with open(pts_path, "rb") as f:
            (n_pts,) = struct.unpack("<Q", f.read(8))
            for _ in range(n_pts):
                (pid,) = struct.unpack("<Q", f.read(8))
                xyz = np.asarray(struct.unpack("<3d", f.read(24)))
                f.read(3)  # rgb
                f.read(8)  # error
                (tlen,) = struct.unpack("<Q", f.read(8))
                track = []
                for _ in range(tlen):
                    imid, kp = struct.unpack("<ii", f.read(8))
                    track.append((imid - 1, kp))
                rec.add_point3D(xyz, track)
    return rec


def write_depths(rec: Reconstruction, path):
    """Refined + prior depth, masks, scales of every image with a depth
    prior (reference scene/reconstruction/base.py:123-141), in the store
    that path's suffix picks (utils.io.open_store: depths.h5 gzip'd as the
    JAX package writes it, or a depths.npyd directory)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open_store(path, "w") as f:
        for imid, im in rec.images.items():
            d = getattr(im, "depth", None)
            if d is None:
                continue
            grp = f.create_group(im.name)
            # level 1: ~2x faster writes for ~5% larger files (the write
            # is on the mapping critical path; format unchanged)
            kw = dict(compression="gzip", compression_opts=1)
            if d.activated and d.data is not None:
                grp.create_dataset("depth", data=np.asarray(d.data, np.float32), **kw)
            grp.create_dataset("prior_depth", data=np.asarray(d.data_prior, np.float32), **kw)
            grp.create_dataset("uncertainty", data=np.asarray(d.uncertainty, np.float32), **kw)
            grp.create_dataset("valid", data=np.asarray(d.valid), **kw)
            if d.continuity_mask is not None:
                grp.create_dataset("continuity", data=np.asarray(d.continuity_mask), **kw)
            grp.attrs["scale"] = d.scale
            grp.attrs["shift"] = d.shift


def read_text(in_dir) -> Reconstruction:
    """Load a COLMAP text reconstruction (for --refrec ATE comparisons)."""
    in_dir = Path(in_dir)
    rec = Reconstruction()
    with open(in_dir / "cameras.txt") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cid = int(parts[0])
            W, H = int(parts[2]), int(parts[3])
            params = np.asarray([float(x) for x in parts[4:8]])
            if parts[1] == "SIMPLE_PINHOLE":
                params = np.asarray([float(parts[4])] * 2 + [float(parts[5]), float(parts[6])])
            rec.add_camera(HostCamera(cid, params, W, H))
    with open(in_dir / "images.txt") as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    obs_lines = {}
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        imid = int(parts[0]) - 1
        q = np.asarray([float(x) for x in parts[1:5]])
        t = np.asarray([float(x) for x in parts[5:8]])
        im = ImageRecord(imid, parts[9], int(parts[8]))
        im.pose = Pose(q, t)
        im.registered = True
        obs = lines[i + 1].split()
        n_kp = len(obs) // 3
        im.keypoints = np.array(
            [[float(obs[3 * k]), float(obs[3 * k + 1])] for k in range(n_kp)]
        ).reshape(n_kp, 2)
        im.point3D_ids = np.full(n_kp, -1, np.int64)
        rec.add_image(im)
    pts_path = in_dir / "points3D.txt"
    if pts_path.exists():
        with open(pts_path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                xyz = [float(x) for x in parts[1:4]]
                track = []
                for k in range(8, len(parts), 2):
                    track.append((int(parts[k]) - 1, int(parts[k + 1])))
                rec.add_point3D(np.asarray(xyz), track)
    return rec
