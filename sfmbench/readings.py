"""The readings that the check's limits are set from, in one process: for
each seed, one scene of the cell's traffic reconstructed through the timed
path at the cell's size, then the check's numbers of the program (the
lower readings), of the control (the reference one precision lower in the
program's place: the upper readings) and, with --fault, of the program
with a fault of faults/ planted under the timed path.

    python3 sfmbench/readings.py --workload <cell> --seeds 1 2 3 [--control] [--fault name ...]

One JSON line a seed and kind on standard output.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / ".cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(HERE), str(HERE.parent)]  # the harness, and the checkout that holds the program

from sfmb import bench, scenes  # noqa: E402
from sfmb.spec import Spec  # noqa: E402
from sfmb.spies import Spy, keeper, targets  # noqa: E402


def one_scene(spec, cfg, traffic, conf, paths, seed, device, work, faults=()):
    """The program's record of scene 0 of `seed` (its calls kept)."""
    from mpsfm_tpu_torch.pipeline import reconstruct
    from mpsfm_tpu_torch.utils.profiling import TIMERS

    scene = scenes.make_scene(work / f"s{seed}", seed, 0, traffic, traffic["images"], device)
    keepers = {k: keeper(entry) for k, entry in cfg.get("calls", {}).items()}
    with contextlib.ExitStack() as stack:
        for f in faults:
            stack.enter_context(spec.module("faults", f).plant())
        for k, entry in cfg.get("calls", {}).items():
            for mod, attr in targets(entry):
                stack.enter_context(Spy(mod, attr, keepers[k]))
        s = bench.reconstruct_scene(reconstruct, TIMERS, scene, conf, work, device)
    s["calls"] = {k: keep.take() for k, keep in keepers.items()}
    return s


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    device = torch.device(args.device)
    spec = Spec(Path.cwd())
    cell = spec.cell(args.workload)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    paths, _ = bench.write_weights(spec, cfg, device)
    from mpsfm_tpu_torch import kernels

    if device.type == "cuda":
        kernels.build_all(kernels.all_kernels())
    conf = bench.program_conf(cfg, paths)
    work = Path(tempfile.mkdtemp(prefix="sfmbench-readings-"))
    try:
        for seed in args.seeds:
            kinds = [("program", ())] + ([("control", ())] if args.control else []) \
                + [(f"fault:{f}", (f,)) for f in args.fault]
            for kind, faults in kinds:
                t = time.perf_counter()
                if kind == "control" and "program" in [k for k, _ in kinds]:
                    s = last  # the control reads the same scene and kernel operands
                else:
                    s = one_scene(spec, cfg, traffic, conf, paths, seed, device, work, faults)
                    last = s
                nums = bench.check(spec, cfg, paths, conf, [s], device, seed, control=kind == "control")
                print(json.dumps({"seed": seed, "kind": kind, "registered": s["registered"], "images": s["images"],
                                  "wall_s": s["wall_s"], "check_s": time.perf_counter() - t, "numbers": nums}),
                      flush=True)
            shutil.rmtree(last["cache"], ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
