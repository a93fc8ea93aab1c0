"""Multi-device bundle adjustment: camera-block / point-block LM over a
process group (port of mpsfm_tpu/parallel/dist_ba.py).

Points and their whole tracks are partitioned across the ranks, cameras
are replicated (the MegBA-style decomposition of the JAX package). Each
rank holds one point shard on its own device, assembles its shard's
normal equations and its contribution to the reduced camera (Schur)
system, and one all-reduce gives every rank the whole system, which each
solves (replicated); the point updates back-substitute locally. Where the
JAX package has shard_map over a mesh and jax.lax.psum, the port has one
process a device and torch.distributed.all_reduce(SUM) over a process
group (parallel/multihost.py); the point blocks come back with
all_gather (all_gather_points).

  host (partition_ba_data, numpy, the JAX package's line for line): the
    points split over the shards round-robin by observation count, each
    shard's observations re-packed camera-major, its slot tables, and its
    block-Schur pair tables against one global block adjacency
    (schur_sparse.make_block_schur_tables_sharded), or, when those are
    too large or MPSFM_DIST_BS=0, the per-(point, camera) tables of the
    dense route.
  each LM step: the shard's blocks G and reduced rhs (block-Schur route),
    or its dense T Hpp⁻¹ Tᵀ and rhs (dense-T route), summed by one
    all-reduce; the block CG on the explicit S (cap max(64, 2C), tolerance
    1e-3, no warm start), or S + 1e-7·I solved by ba/cholesky.cholesky_solve
    (K1 on a card, its plain version on the CPU); the trial cost summed by
    another all-reduce. Hcc and g_c are summed once a normal-equation
    build (the JAX package sums the same values every step).

Every host read that steers the loop (the accept test, the rel_tol
latch, the CG's stopping condition) reads all-reduced values, so every
rank takes the same branch. The JAX package scans all max_iters steps
with a `done` mask; the steps after `done` change nothing, so the loop
ends there and the cost history keeps the last cost, as the scan's does.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.ba import losses
from mpsfm_tpu_torch.ba.schur_sparse import (
    BlockSchurTables,
    build_schur_blocks,
    make_block_schur_tables_sharded,
    pm_backsub,
    pm_coupling_table,
    pm_reduced_rhs,
    schur_cg_blocks,
    tables_to,
)
from mpsfm_tpu_torch.ba.solver import (
    BAData,
    _apply_cam_update,
    _assemble_ne,
    _backsub_rows,
    _cost_only,
    _reduced_solve,
    _schur_coupling,
    inv3x3,
)
from mpsfm_tpu_torch.parallel import multihost


def make_group(n_shards: int | None = None):
    """The process group a sharded solve runs over (the JAX package's
    make_mesh): the default group for n_shards None or the world size,
    else this rank's obs group of n_shards consecutive ranks
    (multihost.make_2d_groups; the other groups are replicas that compute
    the same result). None when no process group is initialised (one
    rank, nothing to reduce). Every rank must call it."""
    world = multihost.world_size()
    if n_shards is None or n_shards == world:
        return multihost.make_global_group()
    return multihost.make_2d_groups(n_shards)[1]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _slot_tables_local(ids, valid_rows, P, K=None):
    """Slot tables (P, K) over the VALID rows only (padding rows never
    enter any segment), vectorized — no per-segment python loop."""
    idx = np.where(valid_rows)[0]
    ids_v = np.asarray(ids)[idx]
    counts = np.bincount(ids_v, minlength=P) if len(ids_v) else np.zeros(P, np.int64)
    Kmin = int(counts.max()) if len(ids_v) else 1
    K = max(Kmin, 1) if K is None else max(K, Kmin, 1)
    slots = np.zeros((P, K), np.int32)
    mask = np.zeros((P, K), np.float32)
    if len(ids_v):
        order = np.argsort(ids_v, kind="stable")
        sorted_ids = ids_v[order]
        starts = np.searchsorted(sorted_ids, sorted_ids)  # first pos of each id run
        pos = np.arange(len(sorted_ids)) - starts
        slots[sorted_ids, pos] = idx[order]
        mask[sorted_ids, pos] = 1.0
    return slots, mask


def partition_ba_data(data: BAData, n_shards: int):
    """Host-side partitioner: points (and their whole tracks) split across
    n_shards, balanced by observation count; per-shard obs re-packed
    camera-major. `data`: a BAData (tensors on any device) or any object
    with its fields as arrays. Returns (parts dict for
    solve_ba_block_sharded, point_ids list-of-arrays for
    unpartition_points); every array numpy, the JAX package's, array for
    array."""
    C = int(_np(data.quat).shape[0])
    P_n = int(_np(data.xyz).shape[0])
    r_pt = _np(data.r_pt)
    r_valid = _np(data.r_valid)
    d_pt = _np(data.d_pt)
    d_valid = _np(data.d_valid)
    No = len(r_pt)
    Nd = len(d_pt)
    Sc = No // C
    Sd = Nd // C if Nd else 0

    cnt = np.bincount(r_pt[r_valid > 0], minlength=P_n)
    if Nd:
        cnt = cnt + np.bincount(d_pt[d_valid > 0], minlength=P_n)
    order = np.argsort(-cnt, kind="stable")
    shard_of = np.empty(P_n, np.int32)
    shard_of[order] = np.arange(P_n) % n_shards  # round-robin over sorted counts

    point_ids = [np.where(shard_of == s)[0] for s in range(n_shards)]
    Pl = max(max(len(p) for p in point_ids), 1)

    # global -> local point index
    local_of = np.zeros(P_n, np.int64)
    for s, pids in enumerate(point_ids):
        local_of[pids] = np.arange(len(pids))

    # per-(shard, camera) row selection in the camera-major layout
    rows = np.arange(No)
    row_cam = rows // max(Sc, 1)
    r_sel = [
        [np.where((r_valid > 0) & (shard_of[r_pt] == s) & (row_cam == c))[0] for c in range(C)]
        for s in range(n_shards)
    ]
    Scl = max(max((len(x) for row in r_sel for x in row), default=1), 1)
    if Nd:
        drows = np.arange(Nd)
        drow_cam = drows // max(Sd, 1)
        d_sel = [
            [np.where((d_valid > 0) & (shard_of[d_pt] == s) & (drow_cam == c))[0] for c in range(C)]
            for s in range(n_shards)
        ]
        Sdl = max(max((len(x) for row in d_sel for x in row), default=1), 1)
    else:
        d_sel = [[np.zeros(0, np.int64)] * C for _ in range(n_shards)]
        Sdl = 1

    No_l, Nd_l = C * Scl, C * Sdl

    sharded = {
        k: []
        for k in (
            "xyz", "point_var", "r_cam", "r_pt", "r_uv", "r_valid", "r_mag", "r_scale",
            "d_cam", "d_pt", "d_logtarget", "d_valid", "d_mag", "d_scale",
            "r_pt_slots", "r_pt_slot_mask", "d_pt_slots", "d_pt_slot_mask",
            "pc_r_slot", "pc_r_mask", "pc_d_slot", "pc_d_mask",
        )
    }
    # common slot-table widths across shards (static shapes)
    Kr = Kd = 1
    for s in range(n_shards):
        pc = np.bincount(local_of[r_pt[np.concatenate(r_sel[s])]], minlength=Pl) if any(len(x) for x in r_sel[s]) else np.zeros(1, np.int64)
        Kr = max(Kr, int(pc.max()) if pc.size else 1)
        if Nd:
            dc = np.bincount(local_of[d_pt[np.concatenate(d_sel[s])]], minlength=Pl) if any(len(x) for x in d_sel[s]) else np.zeros(1, np.int64)
            Kd = max(Kd, int(dc.max()) if dc.size else 1)

    for s in range(n_shards):
        pids = point_ids[s]
        xyz_l = np.zeros((Pl, 3), np.float32)
        xyz_l[:, 2] = 1.0
        pv_l = np.zeros(Pl, np.float32)
        xyz_l[: len(pids)] = _np(data.xyz)[pids]
        pv_l[: len(pids)] = _np(data.point_var)[pids]

        def pack(sel, N_l, S_l, src_pt, fields):
            out = {k: np.zeros((N_l, *v.shape[1:]), v.dtype) for k, v in fields.items()}
            out["_pt"] = np.zeros(N_l, np.int64)
            out["_valid"] = np.zeros(N_l, np.float32)
            for c in range(C):
                rs = sel[c]
                base = c * S_l
                out["_pt"][base : base + len(rs)] = local_of[src_pt[rs]]
                out["_valid"][base : base + len(rs)] = 1.0
                for k, v in fields.items():
                    out[k][base : base + len(rs)] = v[rs]
            return out

        rf = pack(
            r_sel[s], No_l, Scl, r_pt,
            {"uv": _np(data.r_uv), "mag": _np(data.r_mag), "scale": _np(data.r_scale)},
        )
        rf["scale"][rf["_valid"] == 0] = 1.0
        df = pack(
            d_sel[s], Nd_l, Sdl, d_pt,
            {"logtarget": _np(data.d_logtarget), "mag": _np(data.d_mag), "scale": _np(data.d_scale)},
        )
        df["scale"][df["_valid"] == 0] = 1.0

        r_slots, r_mask = _slot_tables_local(rf["_pt"], rf["_valid"] > 0, Pl, Kr)
        d_slots, d_mask = _slot_tables_local(df["_pt"], df["_valid"] > 0, Pl, Kd)
        # per-(point, camera) single-slot tables (dense Schur coupling)
        pc_r_slot = np.zeros((Pl, C), np.int32)
        pc_r_mask = np.zeros((Pl, C), np.float32)
        vr = np.where(rf["_valid"] > 0)[0]
        pc_r_slot[rf["_pt"][vr], vr // Scl] = vr
        pc_r_mask[rf["_pt"][vr], vr // Scl] = 1.0
        pc_d_slot = np.zeros((Pl, C), np.int32)
        pc_d_mask = np.zeros((Pl, C), np.float32)
        vd = np.where(df["_valid"] > 0)[0]
        pc_d_slot[df["_pt"][vd], vd // Sdl] = vd
        pc_d_mask[df["_pt"][vd], vd // Sdl] = 1.0

        sharded["xyz"].append(xyz_l)
        sharded["point_var"].append(pv_l)
        sharded["r_cam"].append((np.arange(No_l) // Scl).astype(np.int32))
        sharded["r_pt"].append(rf["_pt"].astype(np.int32))
        sharded["r_uv"].append(rf["uv"].astype(np.float32))
        sharded["r_valid"].append(rf["_valid"])
        sharded["r_mag"].append(rf["mag"].astype(np.float32))
        sharded["r_scale"].append(rf["scale"].astype(np.float32))
        sharded["d_cam"].append((np.arange(Nd_l) // Sdl).astype(np.int32))
        sharded["d_pt"].append(df["_pt"].astype(np.int32))
        sharded["d_logtarget"].append(df["logtarget"].astype(np.float32))
        sharded["d_valid"].append(df["_valid"])
        sharded["d_mag"].append(df["mag"].astype(np.float32))
        sharded["d_scale"].append(df["scale"].astype(np.float32))
        sharded["r_pt_slots"].append(r_slots)
        sharded["r_pt_slot_mask"].append(r_mask)
        sharded["d_pt_slots"].append(d_slots)
        sharded["d_pt_slot_mask"].append(d_mask)
        sharded["pc_r_slot"].append(pc_r_slot)
        sharded["pc_r_mask"].append(pc_r_mask)
        sharded["pc_d_slot"].append(pc_d_slot)
        sharded["pc_d_mask"].append(pc_d_mask)

    parts = {
        "repl": {
            "quat": _np(data.quat).astype(np.float32),
            "t": _np(data.t).astype(np.float32),
            "cam_dof": _np(data.cam_dof).astype(np.float32),
            "fx": _np(data.fx).astype(np.float32),
            "fy": _np(data.fy).astype(np.float32),
            "cx": _np(data.cx).astype(np.float32),
            "cy": _np(data.cy).astype(np.float32),
        },
        "shard": {k: np.stack(v) for k, v in sharded.items()},
    }

    # explicit block-sparse Schur structure: per-shard pair tables with a
    # GLOBAL camera-pair block adjacency, so the all-reduced sum of the
    # shards' G equals the single-device explicit S; the dense T route
    # when they are too large or MPSFM_DIST_BS=0
    if os.environ.get("MPSFM_DIST_BS", "1") == "0":
        return parts, point_ids

    shard_obs = [
        {
            "r_pt": parts["shard"]["r_pt"][s], "r_cam": parts["shard"]["r_cam"][s],
            "r_valid": parts["shard"]["r_valid"][s],
            "d_pt": parts["shard"]["d_pt"][s], "d_cam": parts["shard"]["d_cam"][s],
            "d_valid": parts["shard"]["d_valid"][s],
        }
        for s in range(n_shards)
    ]
    bs_built = make_block_schur_tables_sharded(shard_obs, Pl, C)
    if bs_built is not None:
        per_shard, shared = bs_built
        for key in ("uni_slots", "uni_mask", "pm_cam", "cam_slots", "cam_mask"):
            parts["shard"]["bs_" + key] = np.stack([ps[key] for ps in per_shard])
        nb = len(per_shard[0]["con_a"])
        parts["n_bs_buckets"] = nb
        for i in range(nb):
            for key in ("con_a", "con_b", "con_mask"):
                parts["shard"][f"bs_{key}{i}"] = np.stack(
                    [ps[key][i] for ps in per_shard]
                )
        for key, v in shared.items():
            parts["repl"]["bs_" + key] = v
        # the dense (Pl, C, 6, 3) T coupling table is superseded — drop
        # the pc slot tables so _assemble_ne skips building it
        for key in ("pc_r_slot", "pc_r_mask", "pc_d_slot", "pc_d_mask"):
            del parts["shard"][key]
    return parts, point_ids


def unpartition_points(xyz_sharded, point_ids, P_n):
    """(n_shards*Pl, 3) or (n_shards, Pl, 3) solver output -> (P, 3) in
    original point order."""
    xyz_sharded = _np(xyz_sharded)
    if xyz_sharded.ndim == 3:  # (n_shards, Pl, 3)
        xyz_sharded = xyz_sharded.reshape(-1, 3)
    n_shards = len(point_ids)
    Pl = xyz_sharded.shape[0] // n_shards
    out = np.zeros((P_n, 3), xyz_sharded.dtype)
    for s, pids in enumerate(point_ids):
        out[pids] = xyz_sharded[s * Pl : s * Pl + len(pids)]
    return out


def _tensor(a, dev):
    """A host array as a tensor on `dev`: integer arrays int64, the rest float32."""
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=dev)
    return torch.as_tensor(a.astype(np.float32), device=dev)


def _local_ba_data(repl, shard, dev) -> BAData:
    """The rank's BAData: the replicated cameras and its own point shard,
    as tensors on `dev`."""
    def get(src, k):
        return _tensor(src[k], dev) if k in src else None

    cams = {k: get(repl, k) for k in ("quat", "t", "cam_dof", "fx", "fy", "cx", "cy")}
    fields = [f for f in BAData._fields if f not in cams and f != "bs"]
    return BAData(**cams, **{f: get(shard, f) for f in fields})


def _local_bs_tables(repl, shard, n_buckets):
    """Reassemble a BlockSchurTables view from the split repl/shard dicts
    (shared adjacency replicated, pair tables shard-local)."""
    return BlockSchurTables(
        uni_slots=shard["bs_uni_slots"], uni_mask=shard["bs_uni_mask"],
        con_a=tuple(shard[f"bs_con_a{i}"] for i in range(n_buckets)),
        con_b=tuple(shard[f"bs_con_b{i}"] for i in range(n_buckets)),
        con_mask=tuple(shard[f"bs_con_mask{i}"] for i in range(n_buckets)),
        blk_rows=repl["bs_blk_rows"], blk_cols=repl["bs_blk_cols"],
        diag_ids=repl["bs_diag_ids"], diag_mask=repl["bs_diag_mask"],
        row_slots=repl["bs_row_slots"], row_mask=repl["bs_row_mask"],
        colT_slots=repl["bs_colT_slots"], colT_mask=repl["bs_colT_mask"],
        pm_cam=shard["bs_pm_cam"],
        cam_slots=shard["bs_cam_slots"], cam_mask=shard["bs_cam_mask"],
    )


def all_gather_points(xyz_local, group=None):
    """The point blocks of every rank, (n_shards, Pl, 3), on each rank
    (the input of unpartition_points)."""
    return multihost.Collectives(group).gather(xyz_local)


def check_replicated(values, group=None, device="cuda"):
    """All-gathers a digest of this rank's replicated state (a list of
    ints) and raises RuntimeError unless every rank's equals rank 0's: a
    rank whose host decisions diverged fails here instead of waiting in a
    collective the others never reach, or mixing its state into their sums."""
    comm = multihost.Collectives(group)
    d = torch.tensor([int(v) for v in values], dtype=torch.int64, device=resolve_device(device))
    seen = comm.gather(d)
    if not bool((seen == seen[0]).all()):
        raise RuntimeError(f"distributed BA: the ranks' replicated state differs (digests by rank "
                           f"{seen.cpu().tolist()}): their mapper decisions diverged")


def parts_digest(parts, extra=()):
    """Shapes, observation counts and checksums of the replicated part of
    a partition (and of `extra`, e.g. the bundle's image ids): what every
    rank must agree on before a sharded solve."""
    sh = parts["shard"]
    crc = 0
    for k in sorted(parts["repl"]):
        crc = zlib.crc32(np.ascontiguousarray(parts["repl"][k]).tobytes(), crc)
    return [int(parts["repl"]["quat"].shape[0]), *sh["xyz"].shape[:2], sh["r_cam"].shape[1], sh["d_cam"].shape[1],
            int(sh["r_valid"].sum()), int(sh["d_valid"].sum()), parts.get("n_bs_buckets", 0), crc,
            zlib.crc32(np.asarray(list(extra), np.int64).tobytes())]


def solve_ba_block_sharded(
    parts,
    group=None,
    reproj_loss: int = losses.SOFT_L1,
    depth_loss: int = losses.CAUCHY,
    max_iters: int = 20,
    lm_lambda0: float = 1e-4,
    rel_tol: float = 1e-6,
    device="cuda",
    digest=(),
):
    """LM-Schur BA over a process group with explicit all-reduces.

    parts from partition_ba_data, the same on every rank (checked with
    check_replicated, `digest` added: e.g. the bundle's image ids); the
    group's ranks are the shards, and each uploads only its own,
    parts["shard"][k][rank], to `device` (the rank's card unless the caller
    asks for the CPU). Returns (quat, t, xyz_local (Pl, 3), info):
    cameras replicated, this rank's point block (all_gather_points and
    unpartition_points map them back); info = {cost0, cost, accepted,
    cost_history (max_iters,), all_reduces, all_reduce_bytes, steps}."""
    dev = resolve_device(device)
    comm = multihost.Collectives(group)
    n_shards = parts["shard"]["xyz"].shape[0]
    if comm.size != n_shards:
        raise ValueError(f"a partition into {n_shards} shards needs a group of {n_shards} ranks, not {comm.size}")
    check_replicated(parts_digest(parts, digest), group, dev)
    repl = parts["repl"]
    shard = {k: v[comm.rank] for k, v in parts["shard"].items()}
    n_bs_buckets = parts.get("n_bs_buckets", 0)
    use_bs = n_bs_buckets > 0 and "bs_uni_slots" in shard
    ld = _local_ba_data(repl, shard, dev)
    bs = tables_to(_local_bs_tables(repl, shard, n_bs_buckets), dev) if use_bs else None
    C = ld.quat.shape[0]
    No, Nd = ld.r_cam.shape[0], ld.d_cam.shape[0]
    frozen_c = 1.0 - ld.cam_dof
    frozen_p = (1.0 - ld.point_var)[:, None]

    def cost_of(quat, t, xyz):
        return comm.sum(_cost_only(ld, quat, t, xyz, reproj_loss, depth_loss))[0]

    def ne_of(quat, t, xyz):
        Hcc_l, Hpp, g_c_l, g_p, Wr_rows, Wd_rows, T = _assemble_ne(ld, quat, t, xyz, reproj_loss, depth_loss)
        Hcc, g_c = comm.sum(Hcc_l, g_c_l)
        return Hcc, Hpp, g_c, g_p, Wr_rows, Wd_rows, T

    quat, t, xyz = ld.quat, ld.t, ld.xyz
    cost0 = cost_of(quat, t, xyz)
    cost = cost0
    lam = np.float32(lm_lambda0)  # float32, as the JAX package's λ
    accepted = 0
    hist = cost0.repeat(max_iters)
    ne = ne_of(quat, t, xyz)
    it = -1
    for it in range(max_iters):
        Hcc, Hpp, g_c, g_p, Wr_rows, Wd_rows, T = ne
        dc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
        Hcc_aug = Hcc + torch.diag_embed(float(lam) * dc + 1e-8 + frozen_c)
        dp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        Hpp_inv = inv3x3(Hpp + torch.diag_embed(float(lam) * dp + 1e-8 + frozen_p))

        if use_bs:
            # each shard's pair blocks against the global adjacency: one
            # all-reduce of G (B·36 floats) and the reduced rhs
            V = pm_coupling_table(Wr_rows, Wd_rows, bs)
            red_l, _ = pm_reduced_rhs(V, Hpp_inv, torch.zeros_like(g_c), g_p, bs)
            G, red = comm.sum(build_schur_blocks(V, Hpp_inv, bs), red_l)
            rhs = -(g_c - red)
            delta_c, _ = schur_cg_blocks(G, bs, Hcc_aug, rhs, max(64, 2 * C), 1e-3)
            delta_c = delta_c * ld.cam_dof
            delta_p = pm_backsub(V, Hpp_inv, g_p, delta_c, ld.point_var, bs)
        else:
            # the shard's dense T Hpp⁻¹ Tᵀ (6C × 6C) and reduced rhs, one
            # all-reduce, the replicated solve (K1), local back-substitution
            Wr = Wr_rows.reshape(No, 6, 3)
            Wd = Wd_rows.reshape(Nd, 6, 3)
            hp = torch.einsum("pij,pj->pi", Hpp_inv, g_p)
            red_r = (Wr * hp[ld.r_pt][:, None, :]).sum(-1).reshape(C, -1, 6).sum(1)
            red_d = (Wd * hp[ld.d_pt][:, None, :]).sum(-1).reshape(C, -1, 6).sum(1)
            S_red, red = comm.sum(_schur_coupling(T, Hpp_inv), red_r + red_d)
            rhs = -(g_c - red)
            delta_c = _reduced_solve(S_red, Hcc_aug, rhs) * ld.cam_dof
            delta_p = _backsub_rows(ld, Wr, Wd, Hpp_inv, g_p, delta_c)

        quat_new, t_new = _apply_cam_update(quat, t, delta_c)
        xyz_new = xyz + delta_p
        new_cost = cost_of(quat_new, t_new, xyz_new)
        rel = (cost - new_cost).abs() / cost.clamp_min(1e-30)
        improved, small = torch.stack([(new_cost < cost) & torch.isfinite(new_cost), rel < rel_tol]).tolist()
        if improved:
            quat, t, xyz, cost = quat_new, t_new, xyz_new, new_cost
            accepted += 1
            lam = max(lam / np.float32(3.0), np.float32(1e-10))
            ne = ne_of(quat, t, xyz)
        else:
            lam = min(lam * np.float32(10.0), np.float32(1e6))
        hist[it:] = cost
        if improved and small:
            break
    info = {"cost0": cost0, "cost": cost, "accepted": accepted, "cost_history": hist, "steps": it + 1,
            "all_reduces": comm.calls, "all_reduce_bytes": comm.bytes}
    return quat, t, xyz, info
