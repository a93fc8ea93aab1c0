"""The JAX package's run behind chip_smoke.DENSE_FULL_BOUNDS: its reconstruct
on the CPU over chip_smoke.DENSE (the pipeline render cut to 5 images of
640×480) in chip_smoke.DENSE_CONF's mode (sparse+dense+measured, heuristic
sky masks; its own HDF5 caches, one process). Prints one RESULT line:
registered images, points, ATE against the render's poses, wall seconds.

    JAX_PLATFORMS=cpu python tests/jax_dense_reference.py <empty work dir>

About 20 minutes on two cores, ~2.2 GB.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from mpsfm_tpu import pipeline  # noqa: E402


def main(work):
    scene = chip_smoke.render_rgbd_dir(Path(work) / "scene", **chip_smoke.DENSE)
    conf = json.loads(json.dumps(chip_smoke.DENSE_CONF))
    conf.pop("cache_format")  # the JAX package's caches are HDF5 only
    conf["mapper"]["ba"].pop("dist_ba")  # one CPU device: the JAX package's "auto" shards nothing
    t = time.perf_counter()
    rec, ok = pipeline.reconstruct(Path(work) / "scene", conf=conf)
    print("RESULT " + json.dumps({"ok": bool(ok), "registered": rec.num_reg_images(), "points": rec.num_points3D(),
                                  "ate": chip_smoke.ate_rmse(rec, scene.poses), "wall": time.perf_counter() - t}))


if __name__ == "__main__":
    main(sys.argv[1])
