"""The port's process groups across OS processes (the counterpart of
tests/test_multihost.py): gloo ranks on the CPU, each a process of
tests/torch_dist_worker.py (torch and the port only).

Tolerances are tests/test_multihost.py's: the distributed solve against
solve_ba on the same rank, cost0 1e-5 and cost 1e-3 relative (of max(1,
|cost|)), quaternions 1e-5, translations 1e-4, points 1e-3; the ranks'
results bit for bit. The mapper's twin holds the same decisions on both
ranks, bit-identical poses, and a sharded global BA.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from mpsfm_tpu_torch.parallel import multihost

WORKER = Path(__file__).parent / "torch_dist_worker.py"
ROOT = Path(__file__).parent.parent


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(mode, world, outdir, timeout=300, torchrun_env=False, local_world=None):
    """Starts `world` worker processes of `mode` and waits for them; fails
    with a rank's output tail if one fails. torchrun_env: the group comes
    from MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK /
    LOCAL_WORLD_SIZE, as torchrun sets them, instead of arguments."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    base["OMP_NUM_THREADS"] = "1"
    procs = []
    for r in range(world):
        env = dict(base)
        if torchrun_env:
            lw = local_world or world
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(r),
                       LOCAL_RANK=str(r % lw), LOCAL_WORLD_SIZE=str(lw))
        procs.append(subprocess.Popen([sys.executable, str(WORKER), mode, str(r), str(world), str(port), str(outdir)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {out[-3000:]}"


def load(outdir, name, world):
    paths = [Path(outdir) / name.format(r) for r in range(world)]
    if name.endswith(".pkl"):
        return [pickle.loads(p.read_bytes()) for p in paths]
    return [json.loads(p.read_text()) for p in paths]


def test_initialize_multihost_is_a_noop_when_single(monkeypatch):
    """No group without a second process: world size 1, rank 0, the
    coordinator, no global group (the JAX function returns False the same
    way)."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()
    assert multihost.world_size() == 1 and multihost.rank() == 0 and multihost.is_coordinator()
    assert multihost.make_global_group() is None


@pytest.mark.parametrize("world,obs", [(4, 2), (4, 4), (4, 1), (6, 3)])
def test_layout_2d(world, obs):
    """The replica × obs layout of make_2d_groups (make_2d_mesh's reshape
    of the device list to (world // obs, obs)): rank r = replica · obs + o."""
    rep, obs_groups = multihost.layout_2d(world, obs)
    grid = [list(range(world))[i * obs:(i + 1) * obs] for i in range(world // obs)]
    assert obs_groups == grid
    assert rep == [[row[o] for row in grid] for o in range(obs)]


def test_layout_2d_refuses_a_ragged_split():
    with pytest.raises(ValueError, match="do not split"):
        multihost.layout_2d(6, 4)


def test_four_ranks_from_the_torchrun_environment(tmp_path):
    """Four ranks initialised from torchrun's variables as two hosts of two
    (LOCAL_WORLD_SIZE 2): the replica and obs groups of make_2d_groups sum
    over the right ranks, rank 0 alone is the coordinator, and the sharded
    solve over each obs group (2 shards) matches solve_ba, identically in
    both replicas (tests/test_parallel.py::test_block_sharded_ba_2d_mesh's
    layout and bounds)."""
    run_ranks("groups", 4, tmp_path, torchrun_env=True, local_world=2)
    vs = load(tmp_path, "groups_{}.json", 4)
    for r, v in enumerate(vs):
        assert v["world_size"] == 4 and v["is_coordinator"] == (r == 0) and v["obs_rank"] == r % 2
        assert v["sums"] == {"world": 6.0, "replica": float(r % 2 + r % 2 + 2), "obs": float(2 * (r // 2) * 2 + 1)}
        assert abs(v["cost0_dist"] - v["cost0_ref"]) <= 1e-5 * max(1.0, abs(v["cost0_ref"]))
        assert abs(v["cost_dist"] - v["cost_ref"]) <= 1e-3 * max(1.0, abs(v["cost_ref"]))
        assert v["quat_maxdiff"] < 1e-5 and v["xyz_maxdiff"] < 1e-3
    # every rank of both replicas holds the same result, bit for bit
    assert len({json.dumps([v["cost_dist"], v["quat"]]) for v in vs}) == 1


@pytest.mark.slow
def test_two_process_distributed_ba(tmp_path):
    """tests/test_multihost.py's twin: two processes, one gloo group, the
    sharded solve of the synthetic bundle against solve_ba on each rank."""
    run_ranks("ba", 2, tmp_path)
    vs = load(tmp_path, "verdict_{}.json", 2)
    for v in vs:
        assert v["world_size"] == 2 and v["n_local_shards"] == 1  # each process owns its point block
        assert abs(v["cost0_dist"] - v["cost0_ref"]) <= 1e-5 * max(1.0, abs(v["cost0_ref"]))
        assert abs(v["cost_dist"] - v["cost_ref"]) <= 1e-3 * max(1.0, abs(v["cost_ref"]))
        assert v["quat_maxdiff"] < 1e-5
        assert v["t_maxdiff"] < 1e-4
        assert v["xyz_maxdiff"] < 1e-3
        assert v["all_reduces"] > 0
    assert vs[0]["is_coordinator"] and not vs[1]["is_coordinator"]
    # both processes observed the same distributed result
    assert vs[0]["cost_dist"] == vs[1]["cost_dist"]


@pytest.mark.slow
def test_two_process_mapper_pipeline(tmp_path):
    """tests/test_multihost.py's mapper twin: the mapper replicated on two
    gloo ranks with dist_ba "on" makes identical decisions on both ranks
    (registration order, point counts, bit-identical poses) while its
    global BAs run sharded; and the same decisions as one process with
    dist_ba off."""
    run_ranks("mapper", 2, tmp_path, timeout=1500)
    v0, v1 = load(tmp_path, "mapper_verdict_{}.json", 2)
    assert v0["ok"] and v1["ok"]
    assert v0["dist_solves"] > 0, "mapper never sharded a BA"
    assert v0["registered"] == v1["registered"] and len(v0["registered"]) == 5, v0["registered"]
    assert v0["order"] == v1["order"]
    assert v0["points_per_image"] == v1["points_per_image"]
    assert v0["num_points3D"] == v1["num_points3D"]
    assert v0["poses"] == v1["poses"]
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_dist_worker import run_small_mapper

    one = run_small_mapper("off", 0)
    assert one["dist_solves"] == 0
    assert one["order"] == v0["order"] and one["registered"] == v0["registered"]
    assert abs(one["num_points3D"] - v0["num_points3D"]) <= max(3, 0.02 * one["num_points3D"])


def test_chip_smoke_dist_ba_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's distributed BA phase rehearsed on the CPU at its
    small sizes (DIST_SIZES["small"]): the same worker processes, groups,
    solves and checks as on the card, K1's plain version in place of the
    kernel ((a) on a world-size-1 gloo group, as NCCL needs a card)."""
    import chip_smoke
    import torch

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the test runner's other workers share the cores
    k1, k1_launches, mapper_launches = chip_smoke.dist_ba_phase(torch.device("cpu"), "small")
    assert k1["err"] == 0.0 and k1_launches == 0 and set(mapper_launches) == {
        "cholesky", "cholesky_many", "bini", "bini_diag"}
