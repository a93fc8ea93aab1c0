"""The sparse BA solver (ba/solver.py's slot-table LM, ba/schur_sparse.py)
and the Optimizer's path above the dense layout: the port against the JAX
package on the CPU.

Inputs: __graft_entry__._synthetic_ba_data_sparse (a sweep, each point
seen by `track_len` consecutive cameras: the JAX package's own block-Schur
test data), __graft_entry__._synthetic_ba_data (every camera sees every
point, with per-(point, camera) tables), and tests/test_ba.py's scenes
carried across with `convert`. The port's reduced solves run K1's plain
version on the CPU; the JAX package's, XLA's cho_factor.

Tolerances (none looser than the JAX package's own test of the function):
  - make_block_schur_tables: every table equal, dtypes included (the
    port's numpy is the JAX package's, line for line);
  - the reducers, _cost_only and _assemble_ne: 1e-6 of the largest
    magnitude, against the JAX functions run op by op (compiled, XLA's
    fusion moves Hpp by 4e-6; tests/test_torch_dense_ba.py holds the
    dense cost to 1e-6, its normal equations to 1e-4);
    the pm coupling table, a gather, equal;
  - build_schur_blocks: both packages round the coupling rows to bfloat16
    before the pair products (exact in float32), so G differs by the
    float32 order of the sums and by the rare row whose bfloat16 rounding
    a float32 ulp flips; held to 1e-4 of max |G| (measured 2.9e-6 here,
    2.4e-6 on the 16 × 1024 sweep), far inside the 2e-2 at which
    tests/test_ba.py holds the explicit operator to the matrix-free one;
  - block_schur_matvec, pm_reduced_rhs, pm_backsub: 1e-5 relative, the
    bounds of tests/test_ba.py::test_block_schur_explicit_matches_matrix_free;
  - _schur_pcg, schur_cg_blocks: the same iteration count and x within
    1e-4 of max |x|, with a tolerance of 0 (the budget of 10 iterations
    ends them) and at the solver's tolerance 1e-2 (it ends them within 64);
    masked_pcg's x equal bit for bit to an early-exit loop's;
  - _dense_schur_solve: 1e-4 of max |x| (K1's plain version vs cho_solve
    on the same S);
  - solve_ba: with rel_tol = 0 over the first DECISION_ITERS iterations
    (relative cost changes far above float32 resolution) the same
    accepted count and cost history within 1e-3; the default run to
    tests/test_ba.py's bounds against the ground truth on each route;
    the port's solve_ba against its solve_ba_dense at
    tests/test_ba.py::test_dense_ba_matches_sparse's bounds (t 5e-3, xyz
    2e-2, cost 5% + 1e-3);
  - the Optimizer above the dense layout (DENSE_MAX patched low): against
    the JAX Optimizer's dense result on the same Reconstruction at
    test_dense_ba_matches_sparse's bounds.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_ba_data, _synthetic_ba_data_sparse
from mpsfm_tpu.ba import losses
from mpsfm_tpu.ba import schur_sparse as jss
from mpsfm_tpu.ba import solver as js
from mpsfm_tpu.ba.problem import build_ba_data as jbuild
from mpsfm_tpu.mapper.optimizer import Optimizer as JOptimizer
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.ba import dense as tdense
from mpsfm_tpu_torch.ba import problem as tproblem
from mpsfm_tpu_torch.ba import schur_sparse as tss
from mpsfm_tpu_torch.ba import solver as ts
from mpsfm_tpu_torch.mapper import optimizer as topt
from mpsfm_tpu_torch.scene import image_priors as tip

sys.path.insert(0, os.path.dirname(__file__))
from test_ba import FakeDepth, make_synthetic_rec, pose_errors  # noqa: E402
from test_torch_image_priors import MEAN_TOL, VAR_RTOL, global_bundle, one_torch_thread, plane_pair  # noqa: E402,F401

NE_REL = 1e-6
G_REL = 1e-4
DECISION_ITERS = 3
TRUNC_RTOL = 1e-4  # tests/test_torch_optimizer.py
LOSSES = (losses.SOFT_L1, losses.CAUCHY)


def sweep(n_cams=12, n_pts=512, track_len=4, seed=0):
    return _synthetic_ba_data_sparse(n_cams=n_cams, n_pts=n_pts, track_len=track_len, seed=seed)


def port(data):
    """A JAX BAData on the port, on the CPU (bs carried by tables_to)."""
    return convert.ba_data(data._asdict(), device="cpu")


def t_(a):
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64))
    return torch.as_tensor(a.astype(np.float32))


def assert_close(a, b, rel, what="", scale=None):
    """|a − b| ≤ rel · max |b| (b the JAX package's), or rel · scale where
    b is a difference of terms of magnitude `scale`."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    gap = np.abs(a - b).max() if a.size else 0.0
    scale = max(np.abs(b).max(), 1e-30) if scale is None else scale
    assert gap <= rel * scale, (what, gap, scale)


def assert_tables_equal(bj, bt):
    assert (bj is None) == (bt is None)
    if bj is None:
        return
    for f in jss.BlockSchurTables._fields:
        a, b = getattr(bj, f), getattr(bt, f)
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        if isinstance(a, tuple):
            assert len(a) == len(b), f
        for x, y in pairs:
            x = np.asarray(x)
            y = y.numpy() if torch.is_tensor(y) else y
            if torch.is_tensor(b) or (isinstance(b, tuple) and torch.is_tensor(b[0])):
                assert y.dtype == (np.int64 if np.issubdtype(x.dtype, np.integer) else np.float32), f
            else:
                assert y.dtype == x.dtype, f
            assert x.shape == y.shape and np.array_equal(x, y), f


def obs_arrays(d):
    return [np.asarray(getattr(d, f)) for f in ("r_pt", "r_cam", "r_valid", "d_pt", "d_cam", "d_valid")]


def rec_problem(rng, depth=True, **kw):
    """tests/test_ba.py's scene with FakeDepth rows, as the port's
    representation="sparse" problem (its observation arrays)."""
    rj, _ = make_synthetic_rec(rng, **kw)
    rt = convert.reconstruction(rj)
    if depth:
        for i in rt.images:
            rt.images[i].depth = FakeDepth(rt, i)
    return tproblem.build_ba_data(rt, global_bundle(rt), representation="sparse", device="cpu")


@pytest.mark.parametrize("scene", ["sweep", "rec", "too_many_pairs", "too_many_blocks"])
def test_block_schur_tables_match_jax(rng, scene):
    """The port's make_block_schur_tables against the JAX package's on the
    same observation arrays: every table equal, or both None past a limit."""
    if scene == "rec":
        p = rec_problem(rng)
        arrays = [getattr(p.data, f).numpy() for f in ("r_pt", "r_cam", "r_valid", "d_pt", "d_cam", "d_valid")]
        P, C = p.data.xyz.shape[0], p.data.quat.shape[0]
    else:
        d = sweep()
        arrays, P, C = obs_arrays(d), d.xyz.shape[0], d.quat.shape[0]
    kw = {"too_many_pairs": dict(max_pair_elems=1000), "too_many_blocks": dict(max_block_elems=1000)}.get(scene, {})
    bj = jss.make_block_schur_tables(*arrays, P, C, **kw)
    bt = tss.make_block_schur_tables(*arrays, P, C, **kw)
    assert (bt is None) == (scene.startswith("too"))
    assert_tables_equal(bj, bt)
    if bt is not None:
        assert_tables_equal(bj, tss.tables_to(bt, torch.device("cpu")))


def test_reducers_and_residuals_match_jax(rng):
    C, S, P = 4, 8, 10
    ids = rng.integers(0, P, C * S)
    vals = rng.normal(size=(C * S, 3)).astype(np.float32)
    slots, mask = js.make_slot_tables(ids, P)
    assert_close(ts._seg_reduce(t_(vals), t_(slots), t_(mask)), js._seg_reduce(jnp.asarray(vals), slots, mask),
                 NE_REL, "seg_reduce")
    assert_close(ts._cam_reduce(t_(vals), C), js._cam_reduce(jnp.asarray(vals), C), NE_REL, "cam_reduce")
    assert_close(ts._segment_sum(t_(vals), t_(ids), P), js._segment_sum(jnp.asarray(vals), ids, P), NE_REL,
                 "segment_sum")
    x = rng.normal(size=(C, 6)).astype(np.float32)
    np.testing.assert_array_equal(ts._cam_expand(t_(x), C * S).numpy(), np.asarray(js._cam_expand(jnp.asarray(x), C * S)))
    np.testing.assert_array_equal(ts._cam_broadcast_rows(t_(x), C * S).numpy(),
                                  np.asarray(js._cam_broadcast_rows(jnp.asarray(x), C * S)))
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    tt, X = rng.normal(size=3).astype(np.float32), (rng.normal(size=3) + [0, 0, 6]).astype(np.float32)
    uv = rng.normal(size=2).astype(np.float32) * 100
    assert_close(ts._reproj_residual(t_(q), t_(tt), t_(X), 500.0, 510.0, 320.0, 240.0, t_(uv)),
                 js._reproj_residual(jnp.asarray(q), jnp.asarray(tt), jnp.asarray(X), 500.0, 510.0, 320.0, 240.0,
                                     jnp.asarray(uv)), NE_REL, "reproj residual")
    assert_close(ts._depth_residual(t_(q), t_(tt), t_(X), torch.tensor(1.7)),
                 js._depth_residual(jnp.asarray(q), jnp.asarray(tt), jnp.asarray(X), 1.7), NE_REL, "depth residual")


DATAS = {
    "sweep": lambda: sweep(),  # block-Schur tables, no per-(point, camera) tables
    "bench": lambda: _synthetic_ba_data(n_cams=8, n_pts=256),  # per-(point, camera) tables: T
}


@pytest.mark.parametrize("name", sorted(DATAS))
def test_cost_and_normal_equations_match_jax(name):
    """_cost_only and _assemble_ne (Hcc, Hpp, g_c, g_p, Wr_rows, Wd_rows, T)
    at the start and at a perturbed state."""
    d = DATAS[name]()
    td = port(d)
    for k in range(2):
        xyz = np.asarray(d.xyz) + 0.01 * k
        cj = float(js._cost_only(d, d.quat, d.t, jnp.asarray(xyz), *LOSSES))
        ct = float(ts._cost_only(td, td.quat, td.t, t_(xyz), *LOSSES))
        assert ct == pytest.approx(cj, rel=NE_REL)
        nej = js._assemble_ne(d, d.quat, d.t, jnp.asarray(xyz), *LOSSES)
        net = ts._assemble_ne(td, td.quat, td.t, t_(xyz), *LOSSES)
        assert (nej[-1] is None) == (name == "sweep") and (net[-1] is None) == (nej[-1] is None)
        for what, a, b in zip(("Hcc", "Hpp", "g_c", "g_p", "Wr_rows", "Wd_rows", "T"), net, nej):
            if b is not None:
                assert_close(a, b, NE_REL, what)


def lm_state(d, lam=3e-3):
    """The JAX package's normal equations and damped blocks at λ (as
    tests/test_ba.py::test_block_schur_explicit_matches_matrix_free)."""
    Hcc, Hpp, g_c, g_p, Wr_rows, Wd_rows, T = js._assemble_ne(d, d.quat, d.t, d.xyz, *LOSSES)
    eye3, eye6 = jnp.eye(3), jnp.eye(6)
    Hpp_inv = js.inv3x3(Hpp + jnp.einsum("pi,ij->pij", lam * jnp.einsum("pii->pi", Hpp) + 1e-8, eye3) * eye3)
    Hcc_aug = Hcc + jnp.einsum("ci,ij->cij", lam * jnp.einsum("cii->ci", Hcc) + 1e-8 + (1 - d.cam_dof), eye6) * eye6
    return dict(Hcc_aug=Hcc_aug, Hpp_inv=Hpp_inv, g_c=g_c, g_p=g_p, Wr_rows=Wr_rows, Wd_rows=Wd_rows, T=T)


def test_block_schur_parts_match_jax(rng):
    """pm_coupling_table, build_schur_blocks, block_schur_matvec,
    pm_reduced_rhs and pm_backsub on the JAX package's inputs; and the
    port's explicit operator against its matrix-free S·x (the twin of
    tests/test_ba.py::test_block_schur_explicit_matches_matrix_free)."""
    d = sweep()
    st = lm_state(d)
    tst = {k: t_(v) for k, v in st.items() if v is not None}
    bj, bt = d.bs, port(d).bs
    Vj = jss.pm_coupling_table(st["Wr_rows"], st["Wd_rows"], bj)
    Vt = tss.pm_coupling_table(tst["Wr_rows"], tst["Wd_rows"], bt)
    np.testing.assert_array_equal(Vt.numpy(), np.asarray(Vj))
    Gj = jss.build_schur_blocks(Vj, st["Hpp_inv"], bj)
    Gt = tss.build_schur_blocks(Vt, tst["Hpp_inv"], bt)
    assert_close(Gt, Gj, G_REL, "G")
    C = d.quat.shape[0]
    x = rng.normal(size=(C, 6)).astype(np.float32)
    yj = jss.block_schur_matvec(Gj, bj, st["Hcc_aug"], jnp.asarray(x))
    yt = tss.block_schur_matvec(t_(np.asarray(Gj)), bt, tst["Hcc_aug"], t_(x))
    assert_close(yt, yj, 1e-5, "matvec")
    rj, hpj = jss.pm_reduced_rhs(Vj, st["Hpp_inv"], st["g_c"], st["g_p"], bj)
    rt, hpt = tss.pm_reduced_rhs(Vt, tst["Hpp_inv"], tst["g_c"], tst["g_p"], bt)
    # rhs = −(g_c − red), a difference of terms ~5x its size: relative to them
    assert_close(rt, rj, 1e-5, "rhs", scale=float(np.abs(np.asarray(st["g_c"])).max()))
    assert_close(hpt, hpj, 1e-5, "hp")
    dc = rng.normal(size=(C, 6)).astype(np.float32) * 1e-3
    pj = jss.pm_backsub(Vj, st["Hpp_inv"], st["g_p"], jnp.asarray(dc), d.point_var, bj)
    pt = tss.pm_backsub(Vt, tst["Hpp_inv"], tst["g_p"], t_(dc), t_(d.point_var), bt)
    assert_close(pt, pj, 1e-5, "backsub")
    # the port's explicit operator against its matrix-free one (bfloat16 pair rows: 2e-2)
    td = port(d)
    Wr = tst["Wr_rows"].reshape(-1, 6, 3)
    Wd = tst["Wd_rows"].reshape(-1, 6, 3)
    y_r = (Wr * ts._cam_broadcast_rows(t_(x), Wr.shape[0])[:, :, None]).sum(1)
    y_d = (Wd * ts._cam_broadcast_rows(t_(x), Wd.shape[0])[:, :, None]).sum(1)
    yp = ts._seg_reduce(y_r, td.r_pt_slots, td.r_pt_slot_mask) + ts._seg_reduce(y_d, td.d_pt_slots, td.d_pt_slot_mask)
    zp = torch.einsum("pij,pj->pi", tst["Hpp_inv"], yp)
    back = ((Wr * zp[td.r_pt][:, None, :]).sum(-1).reshape(C, -1, 6).sum(1)
            + (Wd * zp[td.d_pt][:, None, :]).sum(-1).reshape(C, -1, 6).sum(1))
    y_free = torch.einsum("cij,cj->ci", tst["Hcc_aug"], t_(x)) - back
    y_exp = tss.block_schur_matvec(Gt, bt, tst["Hcc_aug"], t_(x))
    assert float((y_exp - y_free).abs().max()) <= 2e-2 * float(y_free.abs().max()) + 1e-4


def test_inv_spd_matches_jax(rng):
    A = rng.normal(size=(5, 6, 6)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    assert_close(tss.inv_spd(t_(M)), jnp.linalg.inv(jnp.asarray(M)), 1e-5, "inv")


@pytest.mark.parametrize("tol", [0.0, 1e-2])
def test_schur_cgs_match_jax(tol):
    """_schur_pcg (matrix-free) and schur_cg_blocks (explicit blocks) with
    a warm start: the same iteration count, x within 1e-4 of max |x|."""
    d = sweep()
    st = lm_state(d)
    tst = {k: t_(v) for k, v in st.items() if v is not None}
    td = port(d)
    rhs, _ = jss.pm_reduced_rhs(jss.pm_coupling_table(st["Wr_rows"], st["Wd_rows"], d.bs), st["Hpp_inv"],
                                st["g_c"], st["g_p"], d.bs)
    x0 = 0.5 * np.linalg.solve(np.asarray(st["Hcc_aug"]), np.asarray(rhs)[..., None])[..., 0]
    budget = 10 if tol == 0.0 else 64
    xj, itj = js._schur_pcg(d, st["Hcc_aug"], st["Hpp_inv"], st["Wr_rows"], st["Wd_rows"], rhs, budget, tol,
                            x0=jnp.asarray(x0))
    xt, itt = ts._schur_pcg(td, tst["Hcc_aug"], tst["Hpp_inv"], tst["Wr_rows"], tst["Wd_rows"], t_(rhs), budget,
                            tol, x0=t_(x0))
    assert int(itt) == int(itj) and (int(itj) == budget) == (tol == 0.0), (int(itt), int(itj))
    assert_close(xt, xj, 1e-4, "matrix-free x")
    Vj = jss.pm_coupling_table(st["Wr_rows"], st["Wd_rows"], d.bs)
    Gj = jss.build_schur_blocks(Vj, st["Hpp_inv"], d.bs)
    xj, itj = jss.schur_cg_blocks(Gj, d.bs, st["Hcc_aug"], rhs, budget, tol, x0=jnp.asarray(x0))
    xt, itt = tss.schur_cg_blocks(t_(np.asarray(Gj)), td.bs, tst["Hcc_aug"], t_(rhs), budget, tol, x0=t_(x0))
    assert int(itt) == int(itj) and (int(itj) == budget) == (tol == 0.0), (int(itt), int(itj))
    assert_close(xt, xj, 1e-4, "block x")


def test_masked_pcg_equals_an_early_exit_loop(rng, monkeypatch):
    """masked_pcg's x and count equal, bit for bit, a loop that reads its
    condition every iteration and exits, whatever READ_EVERY is."""
    A = rng.normal(size=(8, 6, 6)).astype(np.float32)
    S = t_(A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32))
    Minv = tss.inv_spd(S)
    rhs = t_(rng.normal(size=(8, 6)))

    def S_mv(x):
        return torch.einsum("cij,cj->ci", S, x) + 0.1 * x.roll(1, 0)

    def safe(v):
        return torch.where(v.abs() < 1e-30, torch.full_like(v, 1e-30), v)

    def early_exit(cg_iters, tol):
        x = torch.zeros_like(rhs)
        r = rhs - S_mv(x)
        p = torch.einsum("cij,cj->ci", Minv, r)
        rz = (r * p).sum()
        thr = tol * (torch.sqrt((rhs * rhs).sum()) + 1e-30)
        it = 0
        while it < cg_iters and bool(torch.sqrt((r * r).sum()) > thr):
            Sp = S_mv(p)
            alpha = rz / safe((p * Sp).sum())
            x = x + alpha * p
            r = r - alpha * Sp
            z = torch.einsum("cij,cj->ci", Minv, r)
            rz_new = (r * z).sum()
            p = z + rz_new / safe(rz) * p
            rz = rz_new
            it += 1
        return x, it

    for every in (1, 3, 8):
        monkeypatch.setattr(tss, "READ_EVERY", every)
        for cg_iters, tol in ((40, 1e-3), (40, 0.0), (5, 1e-3)):
            x, it = tss.masked_pcg(S_mv, Minv, rhs, cg_iters, tol)
            xr, itr = early_exit(cg_iters, tol)
            assert int(it) == itr and torch.equal(x, xr), (every, cg_iters, tol)


def test_dense_schur_solve_matches_jax():
    """The reduced system formed densely and solved by K1's plain version
    against the JAX package's cho_factor / cho_solve."""
    d = _synthetic_ba_data(n_cams=8, n_pts=256)
    st = lm_state(d)
    tst = {k: t_(v) for k, v in st.items()}
    rhs = -st["g_c"]
    xj, _ = js._dense_schur_solve(st["T"], st["Hcc_aug"], st["Hpp_inv"], rhs)
    xt, it = ts._dense_schur_solve(tst["T"], tst["Hcc_aug"], tst["Hpp_inv"], t_(rhs))
    assert int(it) == 0
    assert_close(xt, xj, 1e-4, "dense-Schur x")


ROUTES = {
    "dense_schur": lambda d: d,  # per-(point, camera) tables present, C ≤ 512
    "block_schur": lambda d: d._replace(pc_r_slot=None, pc_r_mask=None, pc_d_slot=None, pc_d_mask=None),
    "matrix_free": lambda d: d._replace(pc_r_slot=None, pc_r_mask=None, pc_d_slot=None, pc_d_mask=None, bs=None),
}


def with_bs(d):
    """A JAX BAData with the block-Schur tables of its observations."""
    return d._replace(bs=jss.make_block_schur_tables(*obs_arrays(d), d.xyz.shape[0], d.quat.shape[0]))


def rec_data(rng):
    """tests/test_ba.py's scene (6 × 200, 0.5 px, poses 0.02 off) as the
    JAX package's BAData, with per-(point, camera) tables."""
    rj, _ = make_synthetic_rec(rng, noise_px=0.5)
    return jbuild(rj, global_bundle(rj), use_depth=False).data


@pytest.mark.parametrize("scene", ["bench", "rec"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solve_ba_decisions_match_jax(rng, route, scene):
    """rel_tol = 0 over DECISION_ITERS iterations (each moving the cost by
    ≥ 1e-5 relative in the JAX run): the same accepted count, cost0 to
    1e-5, the cost history within 1e-3; on the bench bundle (8 × 256, depth
    rows) and on tests/test_ba.py's scene."""
    d = _synthetic_ba_data(n_cams=8, n_pts=256) if scene == "bench" else rec_data(rng)
    d = ROUTES[route](with_bs(d))
    qj, tj, xj, ij = js.solve_ba(d, max_iters=DECISION_ITERS, rel_tol=0.0)
    qt, tt, xt, it = ts.solve_ba(port(d), max_iters=DECISION_ITERS, rel_tol=0.0)
    hj = np.asarray(ij["cost_history"], np.float64)
    prev = np.concatenate([[float(ij["cost0"])], hj[:-1]])
    assert ((prev - hj) / prev >= 1e-5).all(), (prev - hj) / prev
    assert it["accepted"] == int(ij["accepted"]) == DECISION_ITERS
    assert float(it["cost0"]) == pytest.approx(float(ij["cost0"]), rel=1e-5)
    np.testing.assert_allclose(it["cost_history"].numpy(), hj, rtol=1e-3)
    cg = it["cg_iters"].numpy()
    assert (cg == 0).all() if route == "dense_schur" else (cg > 0).all()


def port_rec(rng, **kw):
    rj, gt = make_synthetic_rec(rng, **kw)
    return convert.reconstruction(rj), gt


def port_problem(rec, route, **kw):
    """The port's problem of rec's global bundle on the route: the
    default build (per-(point, camera) tables), or its tables dropped for
    the block-Schur tables of its observations, or neither."""
    d = tproblem.build_ba_data(rec, global_bundle(rec), device="cpu", **kw)
    if route == "dense_schur":
        return d
    data = d.data._replace(pc_r_slot=None, pc_r_mask=None, pc_d_slot=None, pc_d_mask=None)
    if route == "block_schur":
        arrays = [getattr(data, f).numpy() for f in ("r_pt", "r_cam", "r_valid", "d_pt", "d_cam", "d_valid")]
        bs = tss.make_block_schur_tables(*arrays, data.xyz.shape[0], data.quat.shape[0])
        data = data._replace(bs=tss.tables_to(bs, torch.device("cpu")))
    d.data = data
    return d


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solve_ba_converges_to_gt(rng, route):
    rec, gt = port_rec(rng, noise_px=0.5)
    prob = port_problem(rec, route, use_depth=False)
    quat, t, xyz, info = ts.solve_ba(prob.data, max_iters=25)
    assert float(info["cost"]) < float(info["cost0"]) * 0.2
    tproblem.apply_ba_result(rec, prob, quat, t, xyz)
    rot, trans = pose_errors(rec, gt)
    assert rot.max() < 0.2 and trans.max() < 0.05, (rot, trans)
    assert np.median(np.linalg.norm(rec.xyz[rec.point_ids()] - gt["pts"], axis=1)) < 0.1


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solve_ba_gauge_fixed(rng, route):
    rec, _ = port_rec(rng)
    q0, t0, tx1 = rec.images[0].pose.q.copy(), rec.images[0].pose.t.copy(), rec.images[1].pose.t[0]
    prob = port_problem(rec, route, use_depth=False)
    tproblem.apply_ba_result(rec, prob, *ts.solve_ba(prob.data, max_iters=10)[:3])
    np.testing.assert_allclose(rec.images[0].pose.q, q0, atol=1e-6)
    np.testing.assert_allclose(rec.images[0].pose.t, t0, atol=1e-6)
    np.testing.assert_allclose(rec.images[1].pose.t[0], tx1, atol=1e-5)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solve_ba_fix_pose_refines_points_only(rng, route):
    rec, gt = port_rec(rng, pose_noise=0.0, noise_px=0.5)
    before = {i: rec.images[i].pose.q.copy() for i in rec.images}
    prob = port_problem(rec, route, fix_pose=True, use_depth=False)
    tproblem.apply_ba_result(rec, prob, *ts.solve_ba(prob.data, max_iters=15)[:3])
    for i in rec.images:
        np.testing.assert_allclose(rec.images[i].pose.q, before[i], atol=1e-6)
    assert np.median(np.linalg.norm(rec.xyz[rec.point_ids()] - gt["pts"], axis=1)) < 0.1


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solve_ba_robust_loss_rejects_outliers(rng, route):
    rec, gt = port_rec(rng, noise_px=0.5, pose_noise=0.01)
    rec.images[3].keypoints[:20] += 80.0
    prob = port_problem(rec, route, use_depth=False)
    tproblem.apply_ba_result(rec, prob, *ts.solve_ba(prob.data, max_iters=25)[:3])
    rot, trans = pose_errors(rec, gt)
    assert rot.max() < 0.5 and trans.max() < 0.05, (rot, trans)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_solve_ba_depth_priors_fix_scale_drift(rng, route):
    rec, _ = port_rec(rng, noise_px=0.3, pose_noise=0.0)
    for i in rec.images:
        rec.images[i].depth = FakeDepth(rec, i)
    for pid in rec.point_ids():
        rec.xyz[pid] *= 1.1
    for i in rec.images:
        rec.images[i].pose.t = rec.images[i].pose.t * 1.1
    prob = port_problem(rec, route, use_depth=True)
    assert int(prob.data.d_valid.sum()) > 0
    info = ts.solve_ba(prob.data, max_iters=30)[3]
    assert float(info["cost"]) < 0.1 * float(info["cost0"])


@pytest.mark.parametrize("route", ["block_schur", "matrix_free"])
def test_solve_ba_matches_solve_ba_dense(rng, route):
    """The port's solve_ba against its solve_ba_dense on the same problem,
    at tests/test_ba.py::test_dense_ba_matches_sparse's bounds."""
    rec, _ = port_rec(rng, noise_px=0.5, pose_noise=0.02)
    prob = port_problem(rec, route, use_depth=False)
    _qs, ts_, xs, info_s = ts.solve_ba(prob.data, max_iters=25)
    _qd, td, xd, info_d = tdense.solve_ba_dense(prob.dense, max_iters=25)
    assert float(info_d["cost"]) < float(info_d["cost0"]) * 0.2
    np.testing.assert_allclose(td.numpy(), ts_.numpy(), atol=5e-3)
    np.testing.assert_allclose(xd.numpy(), xs.numpy(), atol=2e-2)
    assert abs(float(info_d["cost"]) - float(info_s["cost"])) < 0.05 * float(info_s["cost"]) + 1e-3


def test_block_schur_branch_of_build_ba_data_matches_jax(rng, monkeypatch):
    """Above DENSE_MAX (patched low) build_ba_data gives no dense layout and
    no per-(point, camera) tables; with a representation other than
    "sparse" its bs equals the JAX package's make_block_schur_tables on
    the JAX build's arrays (the JAX build's every other array equal)."""
    rj, _ = make_synthetic_rec(rng, n_cams=4, n_pts=60)
    rt = convert.reconstruction(rj)
    for rec in (rj, rt):
        for i in rec.images:
            rec.images[i].depth = FakeDepth(rec, i)
    bundle = global_bundle(rj)
    monkeypatch.setattr(tproblem, "DENSE_MAX", 16)
    for rep in ("both", "solve", "sparse"):
        pt = tproblem.build_ba_data(rt, bundle, representation=rep, device="cpu")
        pj = jbuild(rj, bundle, representation="sparse")  # the same arrays, no dense layout at this size
        assert pt.dense is None and pt.data.pc_r_slot is None and pj.data.pc_r_slot is not None
        for f in pt.data._fields:
            if f.startswith("pc_") or f == "bs":
                continue
            np.testing.assert_array_equal(getattr(pt.data, f).numpy(), np.asarray(getattr(pj.data, f)), err_msg=f)
        bj = jss.make_block_schur_tables(*obs_arrays(pj.data), pj.data.xyz.shape[0], pj.data.quat.shape[0])
        assert_tables_equal(bj if rep != "sparse" else None, pt.data.bs)


def opt_pair(rng, depth, **kw):
    rj, _ = make_synthetic_rec(rng, **kw)
    rt = convert.reconstruction(rj)
    if depth:
        for rec in (rj, rt):
            for i in rec.images:
                rec.images[i].depth = FakeDepth(rec, i)
    return rj, rt


def assert_dense_vs_sparse(info_j, info_t, rj, rt):
    """test_dense_ba_matches_sparse's bounds: t 5e-3, xyz 2e-2, cost 5% + 1e-3."""
    assert info_t["cost"] < info_t["cost0"]
    assert abs(info_t["cost"] - info_j["cost"]) < 0.05 * info_j["cost"] + 1e-3
    for i in rj.images:
        np.testing.assert_allclose(rt.images[i].pose.t, rj.images[i].pose.t, atol=5e-3)
    pids = rj.point_ids()
    np.testing.assert_allclose(rt.xyz[pids], rj.xyz[pids], atol=2e-2)


@pytest.mark.parametrize("depth", [False, True])
def test_optimizer_ba_above_the_dense_layout_matches_jax(rng, monkeypatch, depth):
    """Optimizer.ba on a bundle above the (patched) dense layout: the port
    builds the block-Schur tables and solves with solve_ba; the JAX
    Optimizer solves the same Reconstruction on its dense path."""
    rj, rt = opt_pair(rng, depth, noise_px=0.5)
    bundle = global_bundle(rj)
    monkeypatch.setattr(tproblem, "DENSE_MAX", 16)
    prob = topt.Optimizer({}, rt, device="cpu")._build(bundle, "global", False, 1.0, False, "update")
    assert prob.dense is None and prob.data.bs is not None
    info_j, okj = JOptimizer({}, rj).ba(bundle)
    info_t, okt = topt.Optimizer({}, rt, device="cpu").ba(bundle)
    assert okj and okt and info_t["accepted"] >= 3
    assert_dense_vs_sparse(info_j, info_t, rj, rt)


def lanes(pending):
    return {p.imid: (info, k) for g, _z, info in pending for k, p in enumerate(g)}


@pytest.mark.parametrize("fix_pose", [False, True], ids=["ba_fused", "refine_3d_points"])
def test_ba_fused_above_the_dense_layout_falls_back(monkeypatch, fix_pose):
    """ba_fused above the (patched) dense layout, as in the JAX package:
    finalize_deferred_all (the deferred integration and int_covs reach
    the images), the host truncation multiplier, the host depth rows,
    solve_ba. Against the JAX Optimizer's fused dense run on the same
    state (its integration and int_covs finalized with the BA's read) at
    test_dense_ba_matches_sparse's bounds, the JAX Optimizer made to take
    its own fallback (its device-depth build without the dense layout);
    refine_3d_points takes the same fallback with the poses fixed."""
    from mpsfm_tpu.scene import image_priors as jip

    rj, rt, pj, pt = plane_pair()
    bundle = global_bundle(rj)
    oj, ot = JOptimizer({}, rj), topt.Optimizer({}, rt, device="cpu")
    monkeypatch.setattr(tproblem, "DENSE_MAX", 16)
    jbuild_ = JOptimizer._build

    def no_dense_layout(self, *a, **kw):
        """The JAX Optimizer's device-depth build without its dense layout:
        ba_fused takes its fallback, whose rebuild then solves dense."""
        prob = jbuild_(self, *a, **kw)
        if kw.get("device_depth"):
            prob.dense = None
        return prob

    monkeypatch.setattr(JOptimizer, "_build", no_dense_layout)
    if fix_pose:
        (ij, okj), (it, okt) = oj.refine_3d_points(bundle), ot.refine_3d_points(bundle)
        assert okj and okt
        for i in rj.images:
            np.testing.assert_allclose(rt.images[i].pose.q, rj.images[i].pose.q, atol=1e-6)
        assert_dense_vs_sparse(ij, it, rj, rt)
        return
    (hj, pendj), (ht, pendt) = jip.integrate_bundle_deferred(pj[:2]), tip.integrate_bundle_deferred(pt[:2])
    uj, covj = jip.int_covs_bundle_deferred(pj[:2], hj, lanes(pendj))
    ut, covt = tip.int_covs_bundle_deferred(pt[:2], ht, lanes(pendt))
    ij, okj = oj.ba_fused(bundle, "global", None, pending=pendj, update_trunc=True, unc_overrides=uj,
                          pending_covs=covj)
    it, okt = ot.ba_fused(bundle, "global", None, pending=pendt, update_trunc=True, unc_overrides=ut,
                          pending_covs=covt)
    assert okj and okt
    assert all(b.integrator.integrated for b in pt[:2]) and all(b.integrator.integrated for b in pj[:2])
    for a, b in zip(pj[:2], pt[:2]):
        assert np.abs(np.log(b.depth.data) - np.log(a.depth.data)).mean() < MEAN_TOL
        np.testing.assert_allclose(b.depth.uncertainty_update, a.depth.uncertainty_update, rtol=VAR_RTOL)
    assert ot.truncation_multiplier == pytest.approx(oj.truncation_multiplier, rel=TRUNC_RTOL)
    assert_dense_vs_sparse(ij, it, rj, rt)


@pytest.mark.slow
def test_block_schur_full_solve_parity():
    """tests/test_ba.py::test_block_schur_full_solve_parity on the port:
    the explicit path reaches the matrix-free optimum (same final cost
    within 2% + 1e-3), and the JAX package's explicit run's cost."""
    d = sweep(n_cams=16, n_pts=1024, seed=1)
    td = port(d)
    i1 = ts.solve_ba(td, max_iters=10)[3]
    i2 = ts.solve_ba(td._replace(bs=None), max_iters=10)[3]
    ij = js.solve_ba(d, max_iters=10)[3]
    c1, c2 = float(i1["cost"]), float(i2["cost"])
    assert c1 < float(i1["cost0"]) * 0.1
    assert abs(c1 - c2) < 0.02 * c2 + 1e-3
    assert abs(c1 - float(ij["cost"])) < 0.02 * float(ij["cost"]) + 1e-3


@pytest.mark.slow
def test_real_size_bundle_above_the_dense_layout():
    """A bundle above the real dense layout (Pb·Cb = 8.4e6 > 8e6: 128
    cameras × 65 536 points, tracks of 6) through the block-Schur tables
    and solve_ba on the CPU: the port's tables equal the JAX package's
    and the cost drops 10-fold."""
    d = _synthetic_ba_data_sparse(n_cams=128, n_pts=65536, track_len=6, seed=0)
    assert 128 * 65536 > tproblem.DENSE_MAX
    bt = tss.make_block_schur_tables(*obs_arrays(d), 65536, 128)
    assert_tables_equal(d.bs, bt)
    info = ts.solve_ba(port(d), max_iters=5)[3]
    assert float(info["cost"]) < 0.1 * float(info["cost0"])


def test_chip_smoke_sparse_bundle_is_the_jax_packages():
    """chip_smoke.py's numpy copy of _synthetic_ba_data_sparse (no JAX)
    gives the JAX function's arrays from the same seed, and the port's
    block-Schur tables of them equal the JAX package's."""
    import chip_smoke

    d = sweep(n_cams=16, n_pts=1024, seed=1)
    arrays = chip_smoke.sparse_ba_arrays(chip_smoke.sparse_scene(16, 1024, 4, seed=1))
    for f in arrays:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(d, f)), err_msg=f)
    assert_tables_equal(d.bs, chip_smoke.sparse_tables(arrays))


def test_chip_smoke_sparse_routes_on_the_cpu(monkeypatch):
    """chip_smoke.py's large route and full-width BA at small sizes on the
    CPU, with the dense layout's limit patched below their global bundles
    (32 × 2048: Pb·Cb = 65 536): the refinement steps and the Optimizer's
    entry points on the block-sparse Schur tables, and the routes' checks."""
    import chip_smoke

    monkeypatch.setattr(tproblem, "DENSE_MAX", 40_000)
    size = dict(n_cams=32, n_pts=2048, track_len=6, B=2, H=48, W=64)
    res, launches = chip_smoke.sparse_large_route("cpu", {}, size)
    assert launches == {} and "make_block_schur_tables (in build_ba_data)" in res["times"]
    res, launches = chip_smoke.sparse_full_width("cpu", {}, dict(n_cams=32, n_pts=2048, track_len=6))
    assert res["cost"] <= res["truth_cost"]
    assert res["times"]["make_block_schur_tables (in build_ba_data)"] > 0


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_sparse_card_vs_cpu():
    """chip_smoke.py's small sparse solve (block-sparse Schur on the card
    and on the CPU, matrix-free on the card) and the dense-Schur route
    against solve_ba_dense on the card."""
    import chip_smoke

    chip_smoke.sparse_card_vs_cpu(torch.device("cuda"))
    chip_smoke.sparse_dense_schur_route(torch.device("cuda"), 8, 256)
