"""Explicit block-sparse Schur complement of the large-scene BA path
(port of mpsfm_tpu/ba/schur_sparse.py).

For a bundle above the dense (C, P) layout the reduced camera system
S = Hcc_aug − U·Hpp⁻¹·Uᵀ is formed explicitly as one 6×6 block G per
covisible camera pair (Ceres SPARSE_SCHUR, reference
mpsfm/sfm/mapper/bundle_adjustment.py:285-293): real scenes are
covisibility-sparse, so the blocks are few (B ≈ C · mean covisibility).

  host (once a problem, numpy, `make_block_schur_tables`): the JAX
    package's numpy line for line, so every table equals its counterpart
    — the point-major slot table of the coupling rows (reprojection ++
    depth), every within-point observation pair canonicalised to
    cam(a) ≤ cam(b) and grouped by camera-pair block into `con_*` tables,
    bucketed by the power-of-two width of their pair count, the per-camera
    block lists of the symmetric matvec, and the pm-row ↔ camera tables of
    the reduced rhs and the back-substitution. `tables_to` moves them to
    the device (index tables int64, as everywhere in the port).
  device, per accepted LM step: V = [Wr; Wd][uni_slots] (one row gather),
    each 6×3 row block times chol(Hpp⁻¹), rounded to bfloat16 as the JAX
    package rounds it before its pair gathers (the products are exact in
    float32 and accumulate in float32: the same G up to summation order),
    then G = Σ_k V[con_a]·V[con_b]ᵀ per bucket, a batched product.
  CG (`schur_cg_blocks`) runs on the explicit blocks with the exact block
    Jacobi preconditioner of S.

The JAX package's CG is a `lax.while_loop` whose condition the device
reads. Here `masked_pcg` runs the CG body on the device with its updates
masked (torch.where) once the condition turns false, and reads the
condition on the host every READ_EVERY iterations: the same x and
iteration count as the early exit, for one host sync per READ_EVERY
iterations instead of one per iteration (up to 64 per LM step), at the
price of at most READ_EVERY − 1 masked iterations after convergence.

`make_block_schur_tables_sharded` builds the same tables per point shard
of the distributed BA (parallel/dist_ba.py) against one global block
adjacency, so that the all-reduced shard blocks equal the single-device G.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

READ_EVERY = 8  # CG iterations between two host reads of the stopping condition


class BlockSchurTables(NamedTuple):
    """Host-precomputed structure of the explicit block-sparse S (numpy
    arrays from make_block_schur_tables, tensors after tables_to)."""

    # point-major unified coupling-row layout
    uni_slots: torch.Tensor  # (P, Tu) into [reproj ++ depth] rows
    uni_mask: torch.Tensor  # (P, Tu) f32
    # per-block contribution pair tables (indices into the flattened
    # (P*Tu,) point-major V table), bucketed by power-of-two pair count:
    # tuples of (Bb, Kb), blocks sorted by descending count
    con_a: tuple
    con_b: tuple
    con_mask: tuple
    # block adjacency
    blk_rows: torch.Tensor  # (B,) camera row (<= col)
    blk_cols: torch.Tensor  # (B,) camera col
    diag_ids: torch.Tensor  # (C,) block id of (c,c); 0 if absent
    diag_mask: torch.Tensor  # (C,) f32
    # symmetric matvec slot tables
    row_slots: torch.Tensor  # (C, R1) block ids with row == c
    row_mask: torch.Tensor  # (C, R1) f32
    colT_slots: torch.Tensor  # (C, R2) block ids with col == c, row < col
    colT_mask: torch.Tensor  # (C, R2) f32
    # point-major-row <-> camera mapping (reduced rhs and back-substitution
    # in the layout of the block build)
    pm_cam: torch.Tensor  # (P*Tu,) camera of each pm row (0 padded)
    cam_slots: torch.Tensor  # (C, Rc) pm-row ids of camera c
    cam_mask: torch.Tensor  # (C, Rc) f32


def make_block_schur_tables(
    r_pt,
    r_cam,
    r_valid,
    d_pt,
    d_cam,
    d_valid,
    num_points: int,
    num_cams: int,
    max_pair_elems: int = 256_000_000,
    max_block_elems: int = 64_000_000,
):
    """Build BlockSchurTables (numpy) on the host. Returns None when the
    pair enumeration or the padded block tables would be too large (the
    caller keeps the matrix-free PCG)."""
    r_pt = np.asarray(r_pt, np.int64)
    d_pt = np.asarray(d_pt, np.int64)
    obs_pt = np.concatenate([r_pt, d_pt])
    obs_cam = np.concatenate([np.asarray(r_cam, np.int64), np.asarray(d_cam, np.int64)])
    obs_valid = np.concatenate([np.asarray(r_valid) > 0, np.asarray(d_valid) > 0])

    idx = np.nonzero(obs_valid)[0]
    if len(idx) == 0:
        return None
    pt = obs_pt[idx]
    cam = obs_cam[idx]
    order = np.argsort(pt, kind="stable")
    pt_s, cam_s, obs_s = pt[order], cam[order], idx[order]
    counts = np.bincount(pt_s, minlength=num_points)
    Tu = int(counts.max())
    if Tu == 0 or num_points * Tu * Tu > max_pair_elems:
        return None

    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    flat = pt_s * Tu + (np.arange(len(pt_s)) - starts[pt_s])
    uni_slots = np.zeros((num_points * Tu,), np.int32)
    uni_mask = np.zeros((num_points * Tu,), np.float32)
    uni_cam = np.full((num_points * Tu,), -1, np.int64)
    uni_slots[flat] = obs_s.astype(np.int32)
    uni_mask[flat] = 1.0
    uni_cam[flat] = cam_s
    uni_slots = uni_slots.reshape(num_points, Tu)
    uni_mask = uni_mask.reshape(num_points, Tu)
    uni_cam = uni_cam.reshape(num_points, Tu)

    # ---- canonical within-point obs pairs ----
    m2 = (uni_mask.reshape(num_points, Tu, 1) * uni_mask.reshape(num_points, 1, Tu)) > 0
    ca = np.broadcast_to(uni_cam[:, :, None], (num_points, Tu, Tu))
    cb = np.broadcast_to(uni_cam[:, None, :], (num_points, Tu, Tu))
    keep = m2 & (ca <= cb)
    p_i, k_i, l_i = np.nonzero(keep)
    a_flat = (p_i * Tu + k_i).astype(np.int32)
    b_flat = (p_i * Tu + l_i).astype(np.int32)
    bkey = ca[keep] * num_cams + cb[keep]

    ukeys, binv = np.unique(bkey, return_inverse=True)
    B = len(ukeys)
    blk_rows = (ukeys // num_cams).astype(np.int32)
    blk_cols = (ukeys % num_cams).astype(np.int32)
    bcounts = np.bincount(binv, minlength=B)
    Kmax = int(bcounts.max())
    if B * Kmax > max_block_elems:
        return None

    # ---- bucket blocks by contribution count: descending order, one
    # padded table per power-of-two width ----
    border = np.argsort(-bcounts, kind="stable")
    inv_border = np.empty(B, np.int64)
    inv_border[border] = np.arange(B)
    binv = inv_border[binv]
    blk_rows = blk_rows[border]
    blk_cols = blk_cols[border]
    bcounts = bcounts[border]  # descending
    widths = np.maximum(8, 2 ** np.ceil(np.log2(np.maximum(bcounts, 1))).astype(np.int64))
    bounds = [0] + [i for i in range(1, B) if widths[i] != widths[i - 1]] + [B]

    order2 = np.argsort(binv, kind="stable")
    bstarts = np.concatenate([[0], np.cumsum(np.bincount(binv, minlength=B))[:-1]])
    a_s, b_s, binv_s = a_flat[order2], b_flat[order2], binv[order2]
    offs = np.arange(len(binv_s)) - bstarts[binv_s]
    con_a, con_b, con_mask = [], [], []
    for s, e in zip(bounds[:-1], bounds[1:]):
        Kb = int(widths[s])
        nb = e - s
        sel = (binv_s >= s) & (binv_s < e)
        rows_b = (binv_s[sel] - s) * Kb + offs[sel]
        ta = np.zeros((nb * Kb,), np.int32)
        tb = np.zeros((nb * Kb,), np.int32)
        tm = np.zeros((nb * Kb,), np.float32)
        ta[rows_b] = a_s[sel]
        tb[rows_b] = b_s[sel]
        tm[rows_b] = 1.0
        con_a.append(ta.reshape(nb, Kb))
        con_b.append(tb.reshape(nb, Kb))
        con_mask.append(tm.reshape(nb, Kb))

    # ---- block adjacency tables ----
    diag_ids = np.zeros((num_cams,), np.int32)
    diag_mask = np.zeros((num_cams,), np.float32)
    is_diag = blk_rows == blk_cols
    diag_ids[blk_rows[is_diag]] = np.nonzero(is_diag)[0].astype(np.int32)
    diag_mask[blk_rows[is_diag]] = 1.0

    def group(ids_of_blocks, sel):
        sel_ids = np.nonzero(sel)[0]
        cams = ids_of_blocks[sel]
        cnt = np.bincount(cams, minlength=num_cams)
        R = max(int(cnt.max()), 1)
        slots = np.zeros((num_cams * R,), np.int32)
        mask = np.zeros((num_cams * R,), np.float32)
        o = np.argsort(cams, kind="stable")
        st = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        rr = cams[o] * R + (np.arange(len(cams)) - st[cams[o]])
        slots[rr] = sel_ids[o].astype(np.int32)
        mask[rr] = 1.0
        return slots.reshape(num_cams, R), mask.reshape(num_cams, R)

    row_slots, row_mask = group(blk_rows, np.ones(B, bool))
    colT_slots, colT_mask = group(blk_cols, blk_rows < blk_cols)

    # pm-row -> camera tables of the rhs and the back-substitution
    pm_cam = np.maximum(uni_cam.reshape(-1), 0).astype(np.int32)
    pm_valid = uni_mask.reshape(-1) > 0
    vrows = np.nonzero(pm_valid)[0]
    vcams = pm_cam[vrows]
    ccnt = np.bincount(vcams, minlength=num_cams)
    Rc = max(int(ccnt.max()), 1)
    cam_slots = np.zeros((num_cams * Rc,), np.int32)
    cam_mask = np.zeros((num_cams * Rc,), np.float32)
    co = np.argsort(vcams, kind="stable")
    cst = np.concatenate([[0], np.cumsum(ccnt)[:-1]])
    crr = vcams[co] * Rc + (np.arange(len(vcams)) - cst[vcams[co]])
    cam_slots[crr] = vrows[co].astype(np.int32)
    cam_mask[crr] = 1.0

    return BlockSchurTables(
        uni_slots=uni_slots,
        uni_mask=uni_mask,
        con_a=tuple(con_a),
        con_b=tuple(con_b),
        con_mask=tuple(con_mask),
        blk_rows=blk_rows,
        blk_cols=blk_cols,
        diag_ids=diag_ids,
        diag_mask=diag_mask,
        row_slots=row_slots,
        row_mask=row_mask,
        colT_slots=colT_slots,
        colT_mask=colT_mask,
        pm_cam=pm_cam,
        cam_slots=cam_slots.reshape(num_cams, Rc),
        cam_mask=cam_mask.reshape(num_cams, Rc),
    )


def make_block_schur_tables_sharded(shard_obs, num_points_local, num_cams,
                                    max_pair_elems: int = 256_000_000,
                                    max_block_elems: int = 64_000_000):
    """Per-shard BlockSchurTables with a GLOBAL block adjacency.

    ``shard_obs``: list (one per shard) of dicts with keys r_pt, r_cam,
    r_valid, d_pt, d_cam, d_valid — the shard's packed LOCAL observation
    tables (point indices local to the shard's point block). All shards
    get IDENTICAL table shapes (shared Tu / bucket widths / Rc), so the
    results stack into one array per table; blk/diag/row/colT adjacency
    is identical across shards (points are partitioned, so the union of
    per-shard camera-pair blocks is the full problem's block set and the
    all-reduced sum of the shards' G equals the single-device explicit S).
    The JAX package's numpy, line for line.
    Returns (per_shard list of numpy BlockSchurTables-field dicts,
    shared adjacency dict) or None when the tables would be too large.
    """
    S = len(shard_obs)
    pre = []
    Tu = 1
    for so in shard_obs:
        pt = np.concatenate([np.asarray(so["r_pt"], np.int64), np.asarray(so["d_pt"], np.int64)])
        cam = np.concatenate([np.asarray(so["r_cam"], np.int64), np.asarray(so["d_cam"], np.int64)])
        valid = np.concatenate([np.asarray(so["r_valid"]) > 0, np.asarray(so["d_valid"]) > 0])
        idx = np.nonzero(valid)[0]
        counts = np.bincount(pt[idx], minlength=num_points_local) if len(idx) else np.zeros(num_points_local, np.int64)
        Tu = max(Tu, int(counts.max()) if counts.size else 1)
        pre.append((pt, cam, idx, counts))
    if num_points_local * Tu * Tu > max_pair_elems // max(S, 1):
        return None

    # pass 1: per-shard uni tables + pair block keys
    shard_uni = []
    shard_pairs = []
    all_keys = []
    for pt, cam, idx, counts in pre:
        pt_v, cam_v = pt[idx], cam[idx]
        order = np.argsort(pt_v, kind="stable")
        pt_s, cam_s, obs_s = pt_v[order], cam_v[order], idx[order]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        flat = pt_s * Tu + (np.arange(len(pt_s)) - starts[pt_s])
        uni_slots = np.zeros((num_points_local * Tu,), np.int32)
        uni_mask = np.zeros((num_points_local * Tu,), np.float32)
        uni_cam = np.full((num_points_local * Tu,), -1, np.int64)
        uni_slots[flat] = obs_s.astype(np.int32)
        uni_mask[flat] = 1.0
        uni_cam[flat] = cam_s
        um = uni_mask.reshape(num_points_local, Tu)
        uc = uni_cam.reshape(num_points_local, Tu)
        m2 = (um[:, :, None] * um[:, None, :]) > 0
        ca = np.broadcast_to(uc[:, :, None], m2.shape)
        cb = np.broadcast_to(uc[:, None, :], m2.shape)
        keep = m2 & (ca <= cb)
        p_i, k_i, l_i = np.nonzero(keep)
        a_flat = (p_i * Tu + k_i).astype(np.int32)
        b_flat = (p_i * Tu + l_i).astype(np.int32)
        bkey = ca[keep] * num_cams + cb[keep]
        shard_uni.append((uni_slots.reshape(num_points_local, Tu),
                          um, uc))
        shard_pairs.append((a_flat, b_flat, bkey))
        all_keys.append(np.unique(bkey))

    ukeys = np.unique(np.concatenate(all_keys)) if all_keys else np.zeros(0, np.int64)
    B = len(ukeys)
    if B == 0:
        return None
    # per-block max count over shards drives the shared bucket widths
    maxcnt = np.zeros(B, np.int64)
    shard_binv = []
    for a_flat, b_flat, bkey in shard_pairs:
        binv = np.searchsorted(ukeys, bkey)
        shard_binv.append(binv)
        cnt = np.bincount(binv, minlength=B)
        maxcnt = np.maximum(maxcnt, cnt)
    border = np.argsort(-maxcnt, kind="stable")
    inv_border = np.empty(B, np.int64)
    inv_border[border] = np.arange(B)
    blk_rows = (ukeys[border] // num_cams).astype(np.int32)
    blk_cols = (ukeys[border] % num_cams).astype(np.int32)
    maxcnt = maxcnt[border]
    widths = np.maximum(8, 2 ** np.ceil(np.log2(np.maximum(maxcnt, 1))).astype(np.int64))
    bounds = [0] + [i for i in range(1, B) if widths[i] != widths[i - 1]] + [B]
    if B * int(widths[0]) > max_block_elems:  # widths[0] is the widest bucket
        return None

    per_shard = []
    for s in range(S):
        uni_slots, um, uc = shard_uni[s]
        a_flat, b_flat, bkey = shard_pairs[s]
        binv = inv_border[shard_binv[s]]
        order2 = np.argsort(binv, kind="stable")
        bcnt = np.bincount(binv, minlength=B)
        bstarts = np.concatenate([[0], np.cumsum(bcnt)[:-1]])
        a_s, b_s, binv_s = a_flat[order2], b_flat[order2], binv[order2]
        offs = np.arange(len(binv_s)) - bstarts[binv_s]
        con_a, con_b, con_mask = [], [], []
        for s0, e0 in zip(bounds[:-1], bounds[1:]):
            Kb = int(widths[s0])
            nb = e0 - s0
            sel = (binv_s >= s0) & (binv_s < e0)
            rows_b = (binv_s[sel] - s0) * Kb + offs[sel]
            ta = np.zeros((nb * Kb,), np.int32)
            tb = np.zeros((nb * Kb,), np.int32)
            tm = np.zeros((nb * Kb,), np.float32)
            ta[rows_b] = a_s[sel]
            tb[rows_b] = b_s[sel]
            tm[rows_b] = 1.0
            con_a.append(ta.reshape(nb, Kb))
            con_b.append(tb.reshape(nb, Kb))
            con_mask.append(tm.reshape(nb, Kb))
        per_shard.append({
            "uni_slots": uni_slots, "uni_mask": um,
            "con_a": tuple(con_a), "con_b": tuple(con_b), "con_mask": tuple(con_mask),
            "uni_cam": uc,
        })

    # shared adjacency
    diag_ids = np.zeros((num_cams,), np.int32)
    diag_mask = np.zeros((num_cams,), np.float32)
    is_diag = blk_rows == blk_cols
    diag_ids[blk_rows[is_diag]] = np.nonzero(is_diag)[0].astype(np.int32)
    diag_mask[blk_rows[is_diag]] = 1.0

    def group(ids_of_blocks, sel):
        sel_ids = np.nonzero(sel)[0]
        cams = ids_of_blocks[sel]
        cnt = np.bincount(cams, minlength=num_cams)
        R = max(int(cnt.max()), 1)
        slots = np.zeros((num_cams * R,), np.int32)
        mask = np.zeros((num_cams * R,), np.float32)
        o = np.argsort(cams, kind="stable")
        st = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        rr = cams[o] * R + (np.arange(len(cams)) - st[cams[o]])
        slots[rr] = sel_ids[o].astype(np.int32)
        mask[rr] = 1.0
        return slots.reshape(num_cams, R), mask.reshape(num_cams, R)

    row_slots, row_mask = group(blk_rows, np.ones(B, bool))
    colT_slots, colT_mask = group(blk_cols, blk_rows < blk_cols)
    shared = {
        "blk_rows": blk_rows, "blk_cols": blk_cols,
        "diag_ids": diag_ids, "diag_mask": diag_mask,
        "row_slots": row_slots, "row_mask": row_mask,
        "colT_slots": colT_slots, "colT_mask": colT_mask,
    }

    # per-shard pm-row -> camera tables (shared Rc)
    Rc = 1
    for ps in per_shard:
        pm_valid = ps["uni_mask"].reshape(-1) > 0
        vcams = np.maximum(ps["uni_cam"].reshape(-1), 0)[pm_valid]
        cnt = np.bincount(vcams, minlength=num_cams) if len(vcams) else np.zeros(num_cams, np.int64)
        Rc = max(Rc, int(cnt.max()) if cnt.size else 1)
    for ps in per_shard:
        uni_cam = ps.pop("uni_cam")
        pm_cam = np.maximum(uni_cam.reshape(-1), 0).astype(np.int32)
        pm_valid = ps["uni_mask"].reshape(-1) > 0
        vrows = np.nonzero(pm_valid)[0]
        vcams = pm_cam[vrows]
        ccnt = np.bincount(vcams, minlength=num_cams) if len(vcams) else np.zeros(num_cams, np.int64)
        cam_slots = np.zeros((num_cams * Rc,), np.int32)
        cam_mask = np.zeros((num_cams * Rc,), np.float32)
        if len(vcams):
            co = np.argsort(vcams, kind="stable")
            cst = np.concatenate([[0], np.cumsum(ccnt)[:-1]])
            crr = vcams[co] * Rc + (np.arange(len(vcams)) - cst[vcams[co]])
            cam_slots[crr] = vrows[co].astype(np.int32)
            cam_mask[crr] = 1.0
        ps["pm_cam"] = pm_cam
        ps["cam_slots"] = cam_slots.reshape(num_cams, Rc)
        ps["cam_mask"] = cam_mask.reshape(num_cams, Rc)

    return per_shard, shared


def tables_to(bs: BlockSchurTables, device) -> BlockSchurTables:
    """The tables as tensors on `device`: integer tables int64, masks f32."""

    def conv(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a.astype(np.float32), device=device)

    return BlockSchurTables(*(tuple(conv(x) for x in f) if isinstance(f, tuple) else conv(f) for f in bs))


def _chol3x3(M):
    """Closed-form batched Cholesky of (..., 3, 3) SPD matrices."""
    a = torch.sqrt(M[..., 0, 0].clamp_min(1e-30))
    b = M[..., 1, 0] / a
    c = M[..., 2, 0] / a
    d = torch.sqrt((M[..., 1, 1] - b * b).clamp_min(1e-30))
    e = (M[..., 2, 1] - c * b) / d
    f = torch.sqrt((M[..., 2, 2] - c * c - e * e).clamp_min(1e-30))
    z = torch.zeros_like(a)
    return torch.stack(
        [torch.stack([a, z, z], -1), torch.stack([b, d, z], -1), torch.stack([c, e, f], -1)], -2
    )


def inv_spd(M):
    """Batched inverse of small SPD matrices (..., n, n) by Gauss-Jordan
    elimination without pivoting (the block-Jacobi preconditioners; JAX
    takes jnp.linalg.inv). Elementwise torch ops, n steps."""
    n = M.shape[-1]
    A = torch.cat([M, torch.eye(n, dtype=M.dtype, device=M.device).expand_as(M)], -1)
    for k in range(n):
        row = A[..., k:k + 1, :] / A[..., k:k + 1, k:k + 1]
        A = A - A[..., :, k:k + 1] * row
        A[..., k:k + 1, :] = row
    return A[..., n:]


def pm_coupling_table(Wr_rows, Wd_rows, bs: BlockSchurTables):
    """The coupling rows gathered into the point-major (P*Tu, 18) layout,
    shared by the block build, the reduced rhs and the back-substitution."""
    Wall = torch.cat([Wr_rows, Wd_rows], 0)  # (No+Nd, 18)
    return Wall[bs.uni_slots.reshape(-1)] * bs.uni_mask.reshape(-1, 1)


# rows of a pair gather bucket a chunk of build_schur_blocks takes at once
_CHUNK_ROWS = 1_000_000


def build_schur_blocks(V, Hpp_inv, bs: BlockSchurTables):
    """The U Hpp⁻¹ Uᵀ blocks G (B,6,6) of the explicit S from the
    point-major coupling table V = pm_coupling_table(...)."""
    P, Tu = bs.uni_slots.shape
    # right-multiply each 6x3 row block by L = chol(Hpp_inv):
    # out[:, 3i+k] = Σ_j V[:, 3i+j] L[p,j,k]
    L = _chol3x3(Hpp_inv)  # (P,3,3)
    V2 = torch.bmm(V.reshape(P, Tu * 6, 3), L).reshape(P * Tu, 18)
    # the JAX package gathers the pair rows in bfloat16; its products
    # are exact in float32 and accumulate in float32
    V2h = V2.to(torch.bfloat16)
    outs = []
    for ca_t, cb_t, cm_t in zip(bs.con_a, bs.con_b, bs.con_mask):
        Bb, Kb = ca_t.shape
        chunk_b = max(1, min(Bb, _CHUNK_ROWS // max(Kb, 1)))
        for b0 in range(0, Bb, chunk_b):
            b1 = min(b0 + chunk_b, Bb)
            A = (V2h[ca_t[b0:b1].reshape(-1)].float().reshape(b1 - b0, Kb, 18)
                 * cm_t[b0:b1, :, None]).reshape(b1 - b0, Kb, 6, 3)
            Bv = V2h[cb_t[b0:b1].reshape(-1)].float().reshape(b1 - b0, Kb, 6, 3)
            # G[b,i,j] = Σ_{k,l} A[b,k,i,l] Bv[b,k,j,l]
            outs.append(torch.bmm(A.permute(0, 2, 1, 3).reshape(b1 - b0, 6, Kb * 3),
                                  Bv.permute(0, 1, 3, 2).reshape(b1 - b0, Kb * 3, 6)))
    return torch.cat(outs, 0) if len(outs) > 1 else outs[0]  # (B,6,6)


def _sel_i6(dtype, device):
    """(18,6) selector: Sel[3i+l, i'] = δ_{i,i'} (sum over the l triple)."""
    s = np.zeros((18, 6), np.float32)
    s[np.arange(18), np.arange(18) // 3] = 1.0
    return torch.as_tensor(s, dtype=dtype, device=device)


def _sel_l3(dtype, device):
    """(18,3) selector: Sel[3i+l, l'] = δ_{l,l'} (sum over the i groups)."""
    s = np.zeros((18, 3), np.float32)
    s[np.arange(18), np.arange(18) % 3] = 1.0
    return torch.as_tensor(s, dtype=dtype, device=device)


def pm_reduced_rhs(V, Hpp_inv, g_c, g_p, bs: BlockSchurTables):
    """rhs = −(g_c − U Hpp⁻¹ g_p) in the pm layout. Returns (rhs (C,6), hp (P,3))."""
    P, Tu = bs.uni_slots.shape
    hp = torch.einsum("pij,pj->pi", Hpp_inv, g_p)  # (P,3)
    hp18 = hp @ _sel_l3(V.dtype, V.device).T  # (P,18): hp18[:, 3i+l] = hp[:, l]
    prod = V.reshape(P, Tu, 18) * hp18[:, None, :]
    r6 = prod.reshape(P * Tu, 18) @ _sel_i6(V.dtype, V.device)  # (P*Tu, 6)
    red = (r6[bs.cam_slots.reshape(-1)].reshape(*bs.cam_slots.shape, 6) * bs.cam_mask[..., None]).sum(1)  # (C,6)
    return -(g_c - red), hp


def pm_backsub(V, Hpp_inv, g_p, delta_c, point_var, bs: BlockSchurTables):
    """Δp = −Hpp⁻¹ (g_p + Uᵀ Δc) in the pm layout (padded rows of V are
    zero, so the clamped pm_cam gather adds nothing)."""
    P, Tu = bs.uni_slots.shape
    xg = delta_c[bs.pm_cam]  # (P*Tu, 6)
    xg18 = xg @ _sel_i6(V.dtype, V.device).T  # (P*Tu,18): xg18[:, 3i+l] = xg[:, i]
    wtd_rows = (V * xg18) @ _sel_l3(V.dtype, V.device)  # (P*Tu, 3)
    wtd = wtd_rows.reshape(P, Tu, 3).sum(1)  # (P,3)
    return -torch.einsum("pij,pj->pi", Hpp_inv, g_p + wtd) * point_var[:, None]


def block_schur_matvec(G, bs: BlockSchurTables, Hcc_aug, x):
    """S x with S = Hcc_aug − G (symmetric block structure)."""
    yb = torch.einsum("bij,bj->bi", G, x[bs.blk_cols])  # (B,6)
    ybT = torch.einsum("bij,bi->bj", G, x[bs.blk_rows])  # transpose side
    yr = (yb[bs.row_slots] * bs.row_mask[..., None]).sum(1)  # (C,6)
    yc = (ybT[bs.colT_slots] * bs.colT_mask[..., None]).sum(1)
    return torch.einsum("cij,cj->ci", Hcc_aug, x) - yr - yc


def masked_pcg(S_mv, Minv, rhs, cg_iters: int, cg_tol, x0=None):
    """PCG on S x = rhs with the block preconditioner Minv (C,6,6): the
    JAX package's while_loop (stop when `it == cg_iters` or ‖r‖ ≤ cg_tol ·
    ‖rhs‖) with masked updates and a host read every READ_EVERY
    iterations (module docstring). cg_tol may be a device scalar.
    Returns (x, iterations as a device int tensor)."""

    def prec(r):
        return torch.einsum("cij,cj->ci", Minv, r)

    def safe(v):
        return torch.where(v.abs() < 1e-30, torch.full_like(v, 1e-30), v)

    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - S_mv(x)
    p = prec(r)
    rz = (r * p).sum()
    thr = cg_tol * (torch.sqrt((rhs * rhs).sum()) + 1e-30)
    it = torch.zeros((), dtype=torch.int32, device=rhs.device)
    for k in range(cg_iters):
        active = torch.sqrt((r * r).sum()) > thr
        if k % READ_EVERY == 0 and not bool(active):
            break
        Sp = S_mv(p)
        alpha = rz / safe((p * Sp).sum())
        x = torch.where(active, x + alpha * p, x)
        r_new = r - alpha * Sp
        z = prec(r_new)
        rz_new = (r_new * z).sum()
        p = torch.where(active, z + rz_new / safe(rz) * p, p)
        r = torch.where(active, r_new, r)
        rz = torch.where(active, rz_new, rz)
        it = it + active.to(torch.int32)
    return x, it


def schur_cg_blocks(G, bs: BlockSchurTables, Hcc_aug, rhs, cg_iters: int, cg_tol, x0=None):
    """PCG on the explicit block-sparse S, preconditioned by the exact
    block Jacobi of S (Hcc_aug − the diagonal blocks of G)."""
    Sdiag = Hcc_aug - G[bs.diag_ids] * bs.diag_mask[:, None, None]
    return masked_pcg(lambda x: block_schur_matvec(G, bs, Hcc_aug, x), inv_spd(Sdiag), rhs, cg_iters, cg_tol, x0)
