"""Multi-process setup: torch.distributed process groups (port of
mpsfm_tpu/parallel/multihost.py).

The JAX package runs its sharded programs over a device mesh that spans
every process; the port is SPMD over torch.distributed instead: one
process (rank) per device, NCCL between cards, gloo on the CPU, and a
process group where the JAX package has a mesh. Host-side mapper control
stays replicated-deterministic: every rank runs the whole mapper on the
same inputs and takes the same decisions, and only the sharded BA
communicates (parallel/dist_ba.py). A rank whose decisions diverged is
caught at the next sharded solve (dist_ba.check_replicated), and every
group has a finite timeout, so a divergence fails instead of hanging.

So `torchrun --nproc_per_node 4 <script>` is the counterpart of a
four-chip mesh, and a single process never shards.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from mpsfm_tpu_torch import resolve_device

# how long a collective may wait for the other ranks before it raises
TIMEOUT = timedelta(seconds=300)


def world_size(group=None) -> int:
    """Ranks of `group` (the default group when None); 1 when no process
    group is initialised."""
    return dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in `group`; 0 when no process group is initialised."""
    return dist.get_rank(group) if dist.is_available() and dist.is_initialized() else 0


class Collectives:
    """Sums and gathers over `group`, with the count of all-reduces and
    the bytes they carried. Without an initialised process group there
    is one rank and nothing to send."""

    def __init__(self, group=None):
        self.group = group
        self.on = dist.is_available() and dist.is_initialized()
        self.size = world_size(group)
        self.rank = rank(group)
        self.calls = 0
        self.bytes = 0

    def sum(self, *xs):
        """The elementwise sums over the ranks of the tensors xs (one
        all-reduce carries them all)."""
        if not self.on:
            return xs
        flat = torch.cat([x.reshape(-1) for x in xs])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        self.calls += 1
        self.bytes += flat.numel() * flat.element_size()
        out, o = [], 0
        for x in xs:
            out.append(flat[o:o + x.numel()].reshape(x.shape))
            o += x.numel()
        return tuple(out)

    def gather(self, x):
        """(ranks, *x.shape): every rank's x, in rank order."""
        if not self.on:
            return x[None]
        outs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(outs, x.contiguous(), group=self.group)
        return torch.stack(outs)


def initialize_multihost(init_method=None, num_processes=None, process_id=None, device=None, backend=None,
                         timeout=TIMEOUT):
    """Initialise the default process group from the arguments or from
    torchrun's environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK) and bind this rank's device: `device`, by default
    cuda:LOCAL_RANK (resolve_device: no card raises). The backend is NCCL
    for a card and gloo for the CPU unless `backend` names one (gloo also
    reduces CUDA tensors: two ranks can share one card that way, which
    NCCL refuses). A no-op returning False when single (one process and
    no init_method); True once the group exists."""
    num = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if num <= 1 and init_method is None:
        return False
    rank_ = int(os.environ.get("RANK", "0")) if process_id is None else process_id
    dev = resolve_device(device if device is not None else f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), init_method=init_method or "env://",
                            world_size=num, rank=rank_, timeout=timeout)
    return True


def make_global_group():
    """The group over every rank of every host (the default group); None
    when no process group is initialised."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def layout_2d(world: int, obs_axis_size: int):
    """Rank lists of the replica × obs layout: rank r = replica · obs +
    o. Returns (replica groups: one per o, obs groups: one per replica)."""
    if world % obs_axis_size:
        raise ValueError(f"{world} ranks do not split into groups of {obs_axis_size}")
    n_rep = world // obs_axis_size
    obs = [list(range(r * obs_axis_size, (r + 1) * obs_axis_size)) for r in range(n_rep)]
    rep = [list(range(o, world, obs_axis_size)) for o in range(obs_axis_size)]
    return rep, obs


def make_2d_groups(obs_axis_size=None, timeout=TIMEOUT):
    """This rank's (replica group, obs group) of the replicate-across-hosts
    × shard-within-host layout (the JAX package's make_2d_mesh): a sharded
    BA reduces over the obs group only, so its ranks share one host's
    links, and the replica groups compute identical results. obs_axis_size
    defaults to the ranks of one host (torchrun's LOCAL_WORLD_SIZE). Every
    rank must call it: each group is created by all ranks."""
    world, me = world_size(), rank()
    obs = obs_axis_size or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    rep_ranks, obs_ranks = layout_2d(world, obs)
    mine = {}
    for kind, lists in (("replica", rep_ranks), ("obs", obs_ranks)):
        for ranks in lists:
            g = dist.new_group(ranks, timeout=timeout)
            if me in ranks:
                mine[kind] = g
    return mine["replica"], mine["obs"]


def is_coordinator() -> bool:
    return rank() == 0
