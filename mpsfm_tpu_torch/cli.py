"""Command line of the port: map an RGB-D directory (images/, depth/,
intrinsics.yaml) and write the COLMAP model (the arguments of the JAX
package's reconstruct.py, plus --device).

    python -m mpsfm_tpu_torch.cli --conf classical-nn_measured --data_dir <scene> [--device cpu]

--conf names a file under configs/ or a path; a conf whose text is JSON
needs no PyYAML (set "cache_format": "npy" in it where h5py is missing).
Prints `success=... registered=.../... points=...`.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description="MP-SfM reconstruction on PyTorch (CUDA unless --device cpu)")
    ap.add_argument("--conf", default=None, help="config name under configs/ or a yaml/json path")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--images_dir", default=None)
    ap.add_argument("--intrinsics_path", default=None)
    ap.add_argument("--cache_dir", default=None)
    ap.add_argument("--sfm_outputs_dir", default=None)
    ap.add_argument(
        "--extract",
        nargs="*",
        default=[],
        help="artifact classes to force re-extraction: f(eatures) m(atches) d(epth) p(airs)",
    )
    ap.add_argument("--verbose", type=int, default=0)
    ap.add_argument(
        "--refrec_dir",
        default=None,
        help="COLMAP-format reference reconstruction; prints ATE after mapping",
    )
    ap.add_argument("--device", default="cuda", help="torch device of every stage (default cuda)")
    args = ap.parse_args(argv)

    conf = {}
    if args.conf:
        from mpsfm_tpu_torch.config import load_cfg

        path = Path(args.conf)
        if not path.exists():
            path = ROOT / "configs" / f"{args.conf}.yaml"
        conf = load_cfg(path)

    from mpsfm_tpu_torch.pipeline import reconstruct

    rec, ok = reconstruct(
        args.data_dir,
        conf=conf,
        images_dir=args.images_dir,
        intrinsics_path=args.intrinsics_path,
        cache_dir=args.cache_dir,
        sfm_outputs_dir=args.sfm_outputs_dir,
        extract=args.extract,
        verbose=args.verbose,
        device=args.device,
    )
    print(f"success={ok} registered={rec.num_reg_images()}/{rec.num_images()} points={rec.num_points3D()}")
    if args.refrec_dir:
        from mpsfm_tpu_torch.eval import ate_between
        from mpsfm_tpu_torch.utils.colmap_io import read_text

        try:
            metrics = ate_between(rec, read_text(args.refrec_dir))
            metrics.pop("per_image", None)
            print("ATE vs reference:", json.dumps(metrics))
        except (OSError, ValueError, IndexError) as e:
            print(f"ATE evaluation failed ({args.refrec_dir}): {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
