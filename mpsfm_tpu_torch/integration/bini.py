"""Bilateral normal integration (BiNI) in torch (port of
mpsfm_tpu/integration/bini.py).

Minimizes, in log-depth z, per image

    E(z) = Σ_dir w_dir ⊙ prec_dir ⊙ (c_dir ⊙ D_dir z + n_comp)²
         + λ1 · prec_prior ⊙ (z − z_prior)²
         + λ2 · prec_sparse ⊙ (z − z_sparse)²

by IRLS over the bilateral weights with a Jacobi-PCG solve per round.
Everything here is batched over a leading lane dimension B (the JAX
package vmaps one-image functions): BiniInputs fields are (B,H,W). The
stencil (weights, operator, rhs, diagonal, PCG) lives in bini_fused.py,
beside the CUDA kernel that runs its PCG on the card.

Batched early exits keep the JAX semantics of vmap over a while_loop /
scan: each lane freezes at its own exit (PCG tolerance, IRLS convergence
or abort), never at a batch-wide one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpsfm_tpu_torch import resolve_device
from mpsfm_tpu_torch.integration.bini_diag import deflated_pcg, deflation
from mpsfm_tpu_torch.integration.bini_fused import (
    _dxm,
    _dxp,
    _dym,
    _dyp,
    diag as _diag,
    edges,
    pcg as _pcg,
    rhs as _rhs,
    weights as _weights,
)


class BiniParams(NamedTuple):
    lambda1: float = 1.0
    lambda2: float = 1.0
    k: float = 1.0  # discontinuity sigmoid sharpness
    max_iter: int = 10  # IRLS outer iterations
    cg_max_iter: int = 500
    cg_tol: float = 1e-3
    tol: float = 5e-2  # relative-energy convergence


class BiniInputs(NamedTuple):
    """Dense maps defining the integration problems, (B,H,W) each (or
    (H,W) numpy arrays on the host, as the builders return them)."""

    z0: torch.Tensor  # initial log depth
    c_x: torch.Tensor  # horizontal perspective coefficient
    c_y: torch.Tensor  # vertical perspective coefficient
    nx: torch.Tensor  # normal x-component
    ny: torch.Tensor  # normal y-component
    prec_x: torch.Tensor  # normal precision for x-residuals
    prec_y: torch.Tensor
    prec_prior: torch.Tensor  # prior precision (λ1 applied in the solve)
    z_prior: torch.Tensor
    prec_sparse: torch.Tensor  # 0 where no sparse anchor
    z_sparse: torch.Tensor


def _masks(H, W, dtype, device):
    mxp = torch.ones((H, W), dtype=dtype, device=device)
    mxm, myp, mym = mxp.clone(), mxp.clone(), mxp.clone()
    mxp[:, -1] = 0  # has right neighbour
    mxm[:, 0] = 0  # has left neighbour
    myp[-1] = 0  # has bottom neighbour
    mym[0] = 0  # has top neighbour
    return mxp, mxm, myp, mym


def _energy(inp: BiniInputs, p: BiniParams, z, wx, wy):
    """Per-lane energy (B,)."""
    mxp, mxm, myp, mym = _masks(*z.shape[-2:], z.dtype, z.device)
    rxp = inp.c_x * _dxp(z) + inp.nx
    rxm = inp.c_x * _dxm(z) + inp.nx
    ryp = inp.c_y * _dyp(z) + inp.ny
    rym = inp.c_y * _dym(z) + inp.ny
    s = lambda a: a.sum((-2, -1))  # noqa: E731
    return (
        s(wx * inp.prec_x * rxp**2 * mxp)
        + s((1 - wx) * inp.prec_x * rxm**2 * mxm)
        + s(wy * inp.prec_y * ryp**2 * myp)
        + s((1 - wy) * inp.prec_y * rym**2 * mym)
        + s(p.lambda1 * inp.prec_prior * (z - inp.z_prior) ** 2)
        + s(p.lambda2 * inp.prec_sparse * (z - inp.z_sparse) ** 2)
    )


def _energy_at_z0(inp: BiniInputs, p: BiniParams):
    wx, wy = _weights(inp.z0, p.k)
    return _energy(inp, p, inp.z0, wx, wy)


def _operator(inp: BiniInputs, p: BiniParams, wx, wy):
    """(Stencil, b, diag) of one IRLS round."""
    pa = p.lambda1 * inp.prec_prior + p.lambda2 * inp.prec_sparse
    pb = p.lambda1 * inp.prec_prior * inp.z_prior + p.lambda2 * inp.prec_sparse * inp.z_sparse
    st, hx, hy = edges(inp.c_x, inp.c_y, inp.nx, inp.ny, inp.prec_x, inp.prec_y, pa, wx, wy)
    return st, _rhs(hx, hy, pb), _diag(st)


def _bini_solve_impl(inp: BiniInputs, p: BiniParams):
    """IRLS + Jacobi-PCG solve of a batch (fields (B,H,W)). Returns
    (z (B,H,W), info) with per-lane energy0, energy, aborted, cg_iters.

    Reference convergence policy (integration.py:441-513): a lane stops
    when its relative energy change vs the previous/min energy drops
    below tol while decreasing, and aborts (keeps its initial z) if its
    energy rises above the initial energy. The rounds are a host loop
    that ends once every lane has stopped (one read per round); the PCG
    of each round runs on K2's core for CUDA tensors."""
    z = inp.z0
    wx, wy = _weights(z, p.k)
    e0 = _energy(inp, p, z, wx, wy)
    e_prev, e_min = e0, e0
    Bn = z.shape[0]
    done = torch.zeros(Bn, dtype=torch.bool, device=z.device)
    aborted = torch.zeros_like(done)
    total_cg = torch.zeros(Bn, dtype=torch.int32, device=z.device)
    for _ in range(p.max_iter):
        if bool(done.all()):
            break
        st, b, dg = _operator(inp, p, wx, wy)
        z_new, cg_it = _pcg(st, b, dg, z, p.cg_max_iter, p.cg_tol, ~done)
        wx_new, wy_new = _weights(z_new, p.k)
        e_new = _energy(inp, p, z_new, wx_new, wy_new)

        abort_now = (e_new > e0) & ~done
        rel = (e_new - e_prev).abs() / e_prev.clamp_min(1e-30)
        rel_min = (e_new - e_min).abs() / e_min.clamp_min(1e-30)
        conv = (((rel < p.tol) & (e_prev > e_new)) | ((rel_min < p.tol) & (e_min > e_new))) & (e_new < e0)

        take = ~done & ~abort_now
        tk = take[:, None, None]
        z = torch.where(tk, z_new, z)
        wx = torch.where(tk, wx_new, wx)
        wy = torch.where(tk, wy_new, wy)
        e_min = torch.where(take, torch.minimum(e_min, e_new), e_min)
        e_prev = torch.where(take, e_new, e_prev)
        done = done | conv | abort_now
        aborted = aborted | abort_now
        total_cg = total_cg + torch.where(take, cg_it, 0)
    z = torch.where(aborted[:, None, None], inp.z0, z)
    info = {
        "energy0": e0,
        "energy": torch.where(aborted, e0, e_prev),
        "aborted": aborted,
        "cg_iters": total_cg,
    }
    return z, info


def _batched(inp: BiniInputs) -> BiniInputs:
    return BiniInputs(*(f[None] for f in inp))


def bini_solve(inp: BiniInputs, p: BiniParams):
    """One image: fields (H,W). Returns (z (H,W), info of scalars)."""
    z, info = _bini_solve_impl(_batched(inp), p)
    return z[0], {k: v[0] for k, v in info.items()}


def bini_solve_batch(inp: BiniInputs, p: BiniParams):
    """Whole bundle: fields (B,H,W)."""
    return _bini_solve_impl(inp, p)


def bini_energy(inp: BiniInputs, p: BiniParams):
    """Energy at inp.z0 (IRLS weights evaluated there), fields (H,W)."""
    return _energy_at_z0(_batched(inp), p)[0]


def bini_energy_batch(inp: BiniInputs, p: BiniParams):
    return _energy_at_z0(inp, p)


# ---- packed transport: one (11,H,W) array per problem ----
#
# Rows are grouped by mutation rate (JAX package: bini.py TRANSPORT_ORDER):
#   rows 0-2 dynamic (z0, prec_sparse, z_sparse), rows 3-4 prior
#   (prec_prior, z_prior), rows 5-10 static (c_x, c_y, nx, ny, prec_x, prec_y).

TRANSPORT_ORDER = (
    "z0", "prec_sparse", "z_sparse",
    "prec_prior", "z_prior",
    "c_x", "c_y", "nx", "ny", "prec_x", "prec_y",
)


def pack_inputs(inp: BiniInputs) -> np.ndarray:
    """Host-side: BiniInputs of numpy (H,W) maps -> (11,H,W) float32 in TRANSPORT_ORDER."""
    return np.stack([np.asarray(getattr(inp, f), np.float32) for f in TRANSPORT_ORDER])


def _unpack(packed) -> BiniInputs:
    """(...,11,H,W) -> BiniInputs of (...,H,W) views."""
    return BiniInputs(**{f: packed[..., i, :, :] for i, f in enumerate(TRANSPORT_ORDER)})


# ---- anchor transport: the dynamic rows rebuilt on the device ----

def _drop_index(idx, n):
    """JAX scatter index semantics under mode="drop": negative indices
    wrap once, anything still outside [0, n) is dropped. Returns
    (index, in_range)."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


def _assemble_batch_anchors(anch, cov, pairs):
    """(B,11,H,W) transport rows from packed anchors + cached z0/static rows.

    anch (B,6,Ka) float32: [0] y [1] x [2] val [3] logz [4] slot code;
    [5] meta: [5,0] z0 log-shift, [5,1] prior log-shift, [5,2:5] R2.
    Slot codes: >=0 -> val is the anchor depth and its log-depth precision
    is d²/zvar with zvar = R2·cov[slot]·R2ᵀ; -1 -> zvar 1e-2; -2 -> val IS
    the precision. Out-of-range coordinates mark padding (dropped). With
    two anchors on one pixel, prec_sparse keeps the max and z_sparse one of
    them (unspecified which, as in the JAX package)."""
    z0 = torch.stack([q[0] for q in pairs])  # (B,H,W)
    stat8 = torch.stack([q[1] for q in pairs])  # (B,8,H,W)
    Bn, H, W = z0.shape
    ay, oky = _drop_index(anch[:, 0].to(torch.int64), H)
    ax, okx = _drop_index(anch[:, 1].to(torch.int64), W)
    slot = anch[:, 4].to(torch.int64)
    covsel = cov[slot.clamp(0, cov.shape[0] - 1)]  # (B,Ka,3,3)
    R2 = anch[:, 5, 2:5]  # (B,3)
    zvar = torch.einsum("bi,bkij,bj->bk", R2, covsel, R2).clamp_min(1e-12)
    d2 = anch[:, 2] * anch[:, 2]
    prec = torch.where(slot >= 0, d2 / zvar, torch.where(slot == -1, d2 / 1e-2, anch[:, 2]))
    # dropped anchors scatter into a spare slot past the image
    flat = torch.where(oky & okx, ay * W + ax, torch.full_like(ay, H * W))
    prec_sparse = z0.new_zeros((Bn, H * W + 1)).scatter_reduce_(1, flat, prec, "amax")
    z_sparse = z0.new_zeros((Bn, H * W + 1)).scatter_(1, flat, anch[:, 3])
    meta = anch[:, 5]
    dyn = torch.stack(
        [
            z0 + meta[:, 0, None, None],
            prec_sparse[:, : H * W].reshape(Bn, H, W),
            z_sparse[:, : H * W].reshape(Bn, H, W),
        ],
        1,
    )
    stat = torch.cat([stat8[:, 0:1], stat8[:, 1:2] + meta[:, 1, None, None, None], stat8[:, 2:]], 1)
    return torch.cat([dyn, stat], 1)


def bini_energy_batch_anchors(anch, p: BiniParams, cov, *pairs):
    """(energies (B,), packed (B,11,H,W)). anch (B,6,Ka) packed anchor
    rows; cov (Pc,3,3) point covariances; pairs = B × (z0 (H,W), stat8 (8,H,W))."""
    packed = _assemble_batch_anchors(anch, cov, pairs)
    return _energy_at_z0(_unpack(packed), p), packed


def bini_gate_solve_batch_anchors(anch, prev, p: BiniParams, cov, *pairs):
    """Energy gate + gated solve of a bundle.

    prev (B,2) float32: [energy_old, has_prev] per image. A lane refines
    iff it has no previous energy or its relative energy change exceeds
    p.tol. When no lane refines the solve is skipped: the JAX package's
    lax.cond becomes a host branch here (one read of the gate). When any
    lane refines, every lane is solved, as the JAX package's vmapped
    branch does, so a skipped lane still reports its solve's abort flag.

    Returns (z_out (B,H,W), info4 (B,4) [e0, e_final, refine, aborted]):
    z_out is the refined z where refine & ~aborted, else the (shifted) z0.
    """
    packed = _assemble_batch_anchors(anch, cov, pairs)
    inp = _unpack(packed)
    e0 = _energy_at_z0(inp, p)
    refine = (prev[:, 1] < 0.5) | ((e0 - prev[:, 0]).abs() / prev[:, 0].clamp_min(1e-30) > p.tol)
    z0b = packed[:, 0]
    if bool(refine.any()):
        z_new, info = _bini_solve_impl(inp, p)
        e_fin, aborted = info["energy"], info["aborted"]
    else:
        z_new, e_fin, aborted = z0b, e0, torch.zeros_like(refine)
    take = refine & ~aborted
    z_out = torch.where(take[:, None, None], z_new, z0b)
    e_eff = torch.where(refine, e_fin, e0)
    info4 = torch.stack([e0, e_eff, refine.to(e0.dtype), aborted.to(e0.dtype)], -1).to(torch.float32)
    return z_out, info4


# ---- uncertainty: diag(H⁻¹) at query pixels ----

def take_z(z_batch, pos):
    """z_batch[pos]: one lane of a batch of maps."""
    return z_batch[pos]


def resize_log_dev(zlog, shift, out_hw):
    """log(resize_bilinear(exp(zlog + shift))) to out_hw = (H2, W2), with
    cv2-style sampling (pixel centres, edge clamping): the downscaled z0 of
    the int_covs grid, from the working log-depth on the device."""
    d = torch.exp(zlog + shift)
    H, W = d.shape
    H2, W2 = out_hw

    def centres(n_in, n_out):  # (i + 0.5)·n_in/n_out − 0.5, with n_in/n_out one float32 constant as XLA folds it
        ratio = float(np.float32(n_in) / np.float32(n_out))
        return (torch.arange(n_out, dtype=d.dtype, device=d.device) + 0.5) * ratio - 0.5

    ys, xs = centres(H, H2), centres(W, W2)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx = (xs - x0)[None, :]
    fy = (ys - y0)[:, None]
    x0i, y0i = x0.long(), y0.long()
    x1i, y1i = (x0i + 1).clamp(0, W - 1), (y0i + 1).clamp(0, H - 1)
    x0i, y0i = x0i.clamp(0, W - 1), y0i.clamp(0, H - 1)
    v = (
        d[y0i][:, x0i] * (1 - fx) * (1 - fy)
        + d[y0i][:, x1i] * fx * (1 - fy)
        + d[y1i][:, x0i] * (1 - fx) * fy
        + d[y1i][:, x1i] * fx * fy
    )
    return torch.log(v.clamp_min(1e-8))


def _diag_inverse_at_impl(inp: BiniInputs, p: BiniParams, z, rows, cols, chunk: int = 128):
    """diag(H⁻¹) at the query pixels rows/cols (B,K) of each lane, by
    deflated Jacobi-PCG indicator solves of p.cg_max_iter iterations, with
    H the operator of the IRLS weights at z (B,H,W). Returns (B,K)
    variances of log-depth. The near-kernel of H is its smooth gauge
    modes; deflating {1, x, y} solves them exactly in a 3×3 system and
    leaves PCG the local part (bini_diag.py)."""
    wx, wy = _weights(z, p.k)
    st, _, dg = _operator(inp, p, wx, wy)
    return deflated_pcg(st, deflation(st, dg), rows, cols, p.cg_max_iter, chunk)


def diag_inverse_at(inp: BiniInputs, p: BiniParams, z, rows, cols, chunk: int = 128):
    """One image: fields and z (H,W), rows/cols (K,). Returns (K,)."""
    return _diag_inverse_at_impl(_batched(inp), p, z[None], rows[None], cols[None], chunk)[0]


def diag_inverse_at_batch(packed, p: BiniParams, rows, cols, chunk: int = 128):
    """packed (B,11,H,W) with z0 the converged log-depth; rows/cols (B,Kp).
    Returns (B,Kp)."""
    return _diag_inverse_at_impl(_unpack(packed), p, packed[:, 0], rows, cols, chunk)


def diag_inverse_at_batch_anchors(anch, rowcol, p: BiniParams, chunk: int, cov, *pairs):
    """Anchor-transport variant of diag_inverse_at_batch; rowcol (B,2,Kp)
    query rows and columns."""
    packed = _assemble_batch_anchors(anch, cov, pairs)
    return _diag_inverse_at_impl(_unpack(packed), p, packed[:, 0], rowcol[:, 0], rowcol[:, 1], chunk)


def diag_inverse_gated_batch_anchors(anch, rowcol, p: BiniParams, chunk: int, cov, changed, *pairs):
    """diag_inverse_at_batch_anchors gated on the changed flags (B,): when
    no lane's integration changed, zeros (B,Kp). The JAX package's lax.cond
    becomes a host branch (one read of the flags); when any lane changed,
    every lane is solved, as the JAX package's branch does."""
    if not bool((changed > 0.5).any()):
        return torch.zeros((anch.shape[0], rowcol.shape[-1]), dtype=anch.dtype, device=anch.device)
    return diag_inverse_at_batch_anchors(anch, rowcol, p, chunk, cov, *pairs)


# ---- host-side builders (numpy; copies of the JAX package's) ----

def build_integration_inputs(
    depth_prior,
    depth_uncertainty,
    valid_mask,
    normals,
    normal_covs,
    fx,
    fy,
    cx,
    cy,
    z_init=None,
    sparse_px=None,
    sparse_depth=None,
    sparse_zvar=None,
    scale_filter=True,
    scale_filter_factor=1.5,
    large_number=1e6,
    depth_magnitude_multiplier=1.0,
    normals_magnitude_multiplier=1.0,
    dtype=np.float32,
) -> BiniInputs:
    """Host-side BiniInputs (numpy (H,W) maps) from prior maps + sparse SfM
    points (reference integration.py:236-288), composed from the three
    mutation-rate builders below."""
    static6 = build_static6(
        valid_mask, normals, normal_covs, fx, fy, cx, cy,
        large_number=large_number,
        normals_magnitude_multiplier=normals_magnitude_multiplier,
        dtype=dtype,
    )
    prior2 = build_prior2(depth_prior, depth_uncertainty, depth_magnitude_multiplier, dtype)
    dyn3 = build_dyn3(
        depth_prior, z_init, sparse_px, sparse_depth, sparse_zvar,
        scale_filter, scale_filter_factor, dtype,
    )
    return BiniInputs(
        z0=dyn3[0],
        c_x=static6[0],
        c_y=static6[1],
        nx=static6[2],
        ny=static6[3],
        prec_x=static6[4],
        prec_y=static6[5],
        prec_prior=prior2[0],
        z_prior=prior2[1],
        prec_sparse=dyn3[1],
        z_sparse=dyn3[2],
    )


def build_static6(
    valid_mask, normals, normal_covs, fx, fy, cx, cy,
    large_number=1e6, normals_magnitude_multiplier=1.0, dtype=np.float32,
) -> np.ndarray:
    """STATIC rows (6,H,W): [c_x, c_y, nx, ny, prec_x, prec_y]."""
    n = np.asarray(normals, np.float64)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    H, W = nx.shape
    Vnx = np.asarray(normal_covs[..., 0, 0], np.float64)
    Vny = np.asarray(normal_covs[..., 1, 1], np.float64)
    Vnz = np.asarray(normal_covs[..., 2, 2], np.float64)
    Vnx = np.where(valid_mask, Vnx, large_number) / normals_magnitude_multiplier
    Vny = np.where(valid_mask, Vny, large_number) / normals_magnitude_multiplier
    Vnz = np.where(valid_mask, Vnz, large_number) / normals_magnitude_multiplier

    xx, yy = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    u = xx - cx
    v = yy - cy
    c_x = nx * u + ny * v * (fx / fy) + nz * fx
    c_y = nx * u * (fy / fx) + ny * v + nz * fy
    c_x = np.where(np.abs(c_x) < 1e-8, 1e-8, c_x)
    c_y = np.where(np.abs(c_y) < 1e-8, 1e-8, c_y)

    gx = -nx / c_x
    gy = -ny / c_y
    prec_x = 1.0 / (Vnx * (u * gx + 1.0) ** 2 + Vny * (v * (fx / fy) * gx) ** 2 + Vnz * (fx * gx) ** 2 + 1e-12)
    prec_y = 1.0 / (Vnx * (u * (fy / fx) * gy) ** 2 + Vny * (v * gy + 1.0) ** 2 + Vnz * (fy * gy) ** 2 + 1e-12)
    return np.stack([c_x, c_y, nx, ny, prec_x, prec_y]).astype(dtype)


def build_prior2(depth_prior, depth_uncertainty, depth_magnitude_multiplier=1.0, dtype=np.float32) -> np.ndarray:
    """PRIOR rows (2,H,W): [prec_prior, z_prior]."""
    depth_prior = np.asarray(depth_prior, np.float64)
    prec_prior = depth_magnitude_multiplier / (np.asarray(depth_uncertainty, np.float64) + 1e-6)
    prec_prior = prec_prior * depth_prior**2  # var(log d) = var(d)/d²
    z_prior = np.log(np.clip(depth_prior, 1e-8, None))
    return np.stack([prec_prior, z_prior]).astype(dtype)


def build_dyn3(
    depth_prior, z_init, sparse_px, sparse_depth, sparse_zvar,
    scale_filter=True, scale_filter_factor=1.5, dtype=np.float32,
) -> np.ndarray:
    """DYNAMIC rows (3,H,W): [z0, prec_sparse, z_sparse]."""
    depth_prior = np.asarray(depth_prior, np.float64)
    H, W = depth_prior.shape
    prec_sparse = np.zeros((H, W))
    z_sparse = np.zeros((H, W))
    if sparse_px is not None and len(sparse_px) > 0:
        xs = np.clip(np.round(sparse_px[:, 0]).astype(int), 0, W - 1)
        ys = np.clip(np.round(sparse_px[:, 1]).astype(int), 0, H - 1)
        d3 = np.asarray(sparse_depth, np.float64)
        keep = d3 > 0
        if scale_filter:
            div = d3 / np.clip(depth_prior[ys, xs], 1e-8, None)
            keep &= (div < scale_filter_factor) & (div > 1 / scale_filter_factor)
        xs, ys, d3 = xs[keep], ys[keep], d3[keep]
        zv = np.clip(np.asarray(sparse_zvar, np.float64)[keep], 1e-12, None)
        prec = (1.0 / zv) * d3**2
        np.maximum.at(prec_sparse, (ys, xs), prec)
        z_sparse[ys, xs] = np.log(np.clip(d3, 1e-8, None))
    z0 = np.log(np.clip(depth_prior if z_init is None else z_init, 1e-8, None))
    return np.stack([z0, prec_sparse, z_sparse]).astype(dtype)


class Integrator:
    """Per-image integration state with warm restarts and energy-skip
    (reference Integration class, integration.py:82-137,378-434)."""

    def __init__(self, params: BiniParams | None = None, device="cuda"):
        self.params = params or BiniParams()
        self.device = resolve_device(device)
        self.energy_old = None
        self.integrated = False

    def should_refine_energy(self, e_now: float) -> bool:
        if not self.integrated or self.energy_old is None:
            return True
        return abs(e_now - self.energy_old) / max(self.energy_old, 1e-30) > self.params.tol

    def should_refine(self, inputs: BiniInputs) -> bool:
        if not self.integrated or self.energy_old is None:
            return True
        return self.should_refine_energy(float(bini_energy_batch(_batched(self._tensors(inputs)), self.params)[0]))

    def _tensors(self, inputs: BiniInputs) -> BiniInputs:
        return _unpack(torch.as_tensor(pack_inputs(inputs), device=self.device))

    def accept(self, z, energy: float, aborted: bool):
        """Post-solve bookkeeping. Returns (depth or None, changed)."""
        self.energy_old = energy
        self.integrated = True
        if aborted:
            return None, False
        return np.exp(np.asarray(z.cpu() if torch.is_tensor(z) else z, np.float64)), True

    def integrate(self, inputs: BiniInputs):
        """Returns (depth (H,W) np.float64 or None, changed: bool)."""
        return self.integrate_packed(torch.as_tensor(pack_inputs(inputs), device=self.device))

    def integrate_packed(self, packed):
        """Same, from an (11,H,W) TRANSPORT_ORDER tensor."""
        inp = _batched(_unpack(packed))
        if self.integrated and self.energy_old is not None:
            if not self.should_refine_energy(float(_energy_at_z0(inp, self.params)[0])):
                return None, False
        z, info = _bini_solve_impl(inp, self.params)
        return self.accept(z[0], float(info["energy"][0]), bool(info["aborted"][0]))
