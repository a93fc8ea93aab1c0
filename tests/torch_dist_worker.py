"""One rank of a gloo process group on the CPU, for tests/test_torch_parallel.py
and tests/test_torch_multihost.py (the port's counterpart of
tests/multihost_worker.py and tests/multihost_mapper_worker.py).

    python tests/torch_dist_worker.py <mode> <rank> <world> <port> <dir>

A standalone script that imports torch and the port, never jax: a process
group needs one process a rank. Modes:

  solve   the inputs pickled by the test in <dir>/inputs.pkl: for each
          route, solve_ba_block_sharded on the given partition and the
          gathered points; a partition whose cameras this rank perturbs
          (the sharded solve must raise on every rank); run_sharded_batches
          of the given items. Results pickled into <dir>/rank<r>.pkl.
  ba      the twin of multihost_worker.py: chip_smoke's synthetic bundle
          (the numpy copy of __graft_entry__._synthetic_ba_data, 8 × 128)
          partitioned over the world, solved, gathered, against solve_ba
          on this rank; a JSON verdict.
  mapper  the twin of multihost_mapper_worker.py: MpsfmMapper over the
          5-image PlaneScene (chip_smoke.MappingScene) with dist_ba "on";
          a JSON verdict of its decisions.
  groups  initialised from torchrun's environment (the test sets
          MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK,
          LOCAL_WORLD_SIZE): the replica × obs groups, a sum over each, and
          the sharded solve over the obs group; a JSON verdict.
"""

import json
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from mpsfm_tpu_torch.parallel import dist_ba, multihost  # noqa: E402

MAX_ITERS = 6


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else x


def solve(parts, group, **kw):
    q, t, x, info = dist_ba.solve_ba_block_sharded(parts, group, max_iters=MAX_ITERS, device="cpu", **kw)
    return {"quat": _np(q), "t": _np(t), "xyz": _np(dist_ba.all_gather_points(x, group)),
            **{k: _np(v) if torch.is_tensor(v) else v for k, v in info.items()}}


def mode_solve(rank, world, outdir):
    from mpsfm_tpu_torch.parallel.sharded_inference import run_sharded_batches

    with open(os.path.join(outdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    out = {"routes": {name: solve(parts, None, rel_tol=inputs["rel_tol"]) for name, parts in inputs["routes"].items()}}
    diverged = {k: dict(v) if isinstance(v, dict) else v for k, v in next(iter(inputs["routes"].values())).items()}
    diverged["repl"]["quat"] = diverged["repl"]["quat"] + np.float32(1e-6 * rank)
    try:
        solve(diverged, None)
        out["diverged"] = "no error"
    except RuntimeError as e:
        out["diverged"] = str(e)
    out["inference"] = run_sharded_batches(lambda b: (b.sum(dim=(1, 2)), b[:, 0, :] > 4), inputs["items"],
                                           lambda x: x, device="cpu")
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def mode_ba(rank, world, outdir):
    import chip_smoke
    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba.solver import solve_ba

    arrays = chip_smoke.ba_arrays(chip_smoke.synthetic_bundle(8, 128))
    data = convert.ba_data(arrays, device="cpu")
    parts, pids = dist_ba.partition_ba_data(data, multihost.world_size())
    group = dist_ba.make_group()
    r = solve(parts, group)
    xg = dist_ba.unpartition_points(r["xyz"], pids, arrays["xyz"].shape[0])
    q1, t1, x1, info1 = solve_ba(data, max_iters=MAX_ITERS)
    verdict = {
        "rank": rank, "world_size": multihost.world_size(), "is_coordinator": multihost.is_coordinator(),
        "n_local_shards": 1, "cost0_dist": float(r["cost0"]), "cost_dist": float(r["cost"]),
        "cost0_ref": float(info1["cost0"]), "cost_ref": float(info1["cost"]),
        "quat_maxdiff": float(np.abs(r["quat"] - q1.numpy()).max()),
        "t_maxdiff": float(np.abs(r["t"] - t1.numpy()).max()),
        "xyz_maxdiff": float(np.abs(xg - x1.numpy()).max()),
        "all_reduces": r["all_reduces"], "all_reduce_bytes": r["all_reduce_bytes"],
    }
    with open(os.path.join(outdir, f"verdict_{rank}.json"), "w") as f:
        json.dump(verdict, f)


def run_small_mapper(dist_ba_mode, shards):
    """MpsfmMapper on the CPU over the scene of multihost_mapper_worker.py
    (PlaneScene, seed 3, 5 images × 120 points, 64 hypotheses: chip_smoke's
    DIST_MAPPER): its decisions (chip_smoke.mapper_decisions)."""
    import chip_smoke

    return chip_smoke.run_dist_mapper("cpu", dist_ba_mode, shards)[0]


def mode_mapper(rank, world, outdir):
    verdict = {"rank": rank, **run_small_mapper("on", multihost.world_size())}
    with open(os.path.join(outdir, f"mapper_verdict_{rank}.json"), "w") as f:
        json.dump(verdict, f)


def mode_groups(rank, world, outdir):
    import chip_smoke
    from mpsfm_tpu_torch import convert
    from mpsfm_tpu_torch.ba.solver import solve_ba

    rep, obs = multihost.make_2d_groups()
    v = torch.tensor([float(rank)])
    sums = {}
    for name, g in (("world", multihost.make_global_group()), ("replica", rep), ("obs", obs)):
        x = v.clone()
        dist.all_reduce(x, group=g)
        sums[name] = float(x)
    arrays = chip_smoke.ba_arrays(chip_smoke.synthetic_bundle(8, 128))
    data = convert.ba_data(arrays, device="cpu")
    n_obs = multihost.world_size(obs)
    parts, pids = dist_ba.partition_ba_data(data, n_obs)
    group = dist_ba.make_group(n_obs)
    r = solve(parts, group)
    xg = dist_ba.unpartition_points(r["xyz"], pids, arrays["xyz"].shape[0])
    q1, _, x1, info1 = solve_ba(data, max_iters=MAX_ITERS)
    verdict = {"rank": rank, "world_size": multihost.world_size(), "obs_rank": multihost.rank(obs),
               "is_coordinator": multihost.is_coordinator(), "sums": sums,
               "cost0_dist": float(r["cost0"]), "cost_dist": float(r["cost"]),
               "cost0_ref": float(info1["cost0"]), "cost_ref": float(info1["cost"]),
               "quat": r["quat"].tolist(), "quat_maxdiff": float(np.abs(r["quat"] - q1.numpy()).max()),
               "xyz_maxdiff": float(np.abs(xg - x1.numpy()).max())}
    with open(os.path.join(outdir, f"groups_{rank}.json"), "w") as f:
        json.dump(verdict, f)


def main():
    mode, rank, world, port, outdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    torch.set_num_threads(1)
    if mode == "groups":  # from torchrun's environment, set by the test
        assert multihost.initialize_multihost(device="cpu")
    else:
        assert multihost.initialize_multihost(f"tcp://localhost:{port}", world, rank, device="cpu")
    try:
        {"solve": mode_solve, "ba": mode_ba, "mapper": mode_mapper, "groups": mode_groups}[mode](rank, world, outdir)
    finally:
        dist.destroy_process_group()
    print("OK", mode, rank)


if __name__ == "__main__":
    main()
