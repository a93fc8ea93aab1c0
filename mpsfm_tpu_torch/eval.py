"""Evaluation harness: ATE/RPE against a reference reconstruction (port of
mpsfm_tpu/eval.py).

The reference exposes --refrec_dir for this purpose (reconstruct.py:17,
init_utils.py:18-22); here it is a first-class module: load two
reconstructions (ours + reference, COLMAP text format), match images by
name, align with a similarity transform, and report ATE RMSE plus
registration overlap — the paper's parity metric (BASELINE.md).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def umeyama(src, dst):
    """Similarity (s, R, t) minimizing ||dst − (s R src + t)||²."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc**2).sum() / len(src)
    s = np.trace(np.diag(D) @ S) / max(var_s, 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_between(rec, ref_rec):
    """ATE RMSE (after similarity alignment) over commonly registered
    images; also returns per-image errors and the overlap counts."""
    common = []
    for imid, im in rec.registered_images.items():
        for rid, rim in ref_rec.registered_images.items():
            if rim.name == im.name:
                common.append((im, rim))
                break
    if len(common) < 3:
        return {"ate_rmse": float("inf"), "n_common": len(common)}
    est = np.stack([im.pose.center() for im, _ in common])
    ref = np.stack([rim.pose.center() for _, rim in common])
    s, R, t = umeyama(est, ref)
    aligned = (s * (R @ est.T)).T + t
    err = np.sqrt(((aligned - ref) ** 2).sum(-1))
    return {
        "ate_rmse": float(np.sqrt((err**2).mean())),
        "ate_median": float(np.median(err)),
        "per_image": {im.name: float(e) for (im, _), e in zip(common, err)},
        "n_common": len(common),
        "n_registered": len(rec.registered_images),
        "n_ref_registered": len(ref_rec.registered_images),
        "scale": float(s),
    }


def rotation_errors_deg(rec, ref_rec):
    """Pairwise-relative rotation errors (gauge-free) between common images."""
    common = []
    for imid, im in rec.registered_images.items():
        for rid, rim in ref_rec.registered_images.items():
            if rim.name == im.name:
                common.append((im, rim))
                break
    errs = []
    for i in range(len(common)):
        for j in range(i + 1, len(common)):
            Ra = common[i][0].pose.rotation_matrix() @ common[j][0].pose.rotation_matrix().T
            Rb = common[i][1].pose.rotation_matrix() @ common[j][1].pose.rotation_matrix().T
            dR = Ra @ Rb.T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
            errs.append(ang)
    return np.asarray(errs)


def main():
    import argparse
    import json

    from mpsfm_tpu_torch.utils.colmap_io import read_text

    ap = argparse.ArgumentParser(description="ATE evaluation vs a reference reconstruction")
    ap.add_argument("--rec_dir", required=True)
    ap.add_argument("--refrec_dir", required=True)
    args = ap.parse_args()
    rec = read_text(Path(args.rec_dir))
    ref = read_text(Path(args.refrec_dir))
    out = ate_between(rec, ref)
    rot = rotation_errors_deg(rec, ref)
    if len(rot):
        out["rel_rot_mean_deg"] = float(rot.mean())
        out["rel_rot_max_deg"] = float(rot.max())
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
