"""BiNI integration: the PyTorch port against the JAX package on the CPU.

Both packages get the same numpy inputs. On the CPU the port runs the
plain torch versions of its kernel (K2's PCG core and its fixed-budget
solve); the JAX package's Pallas kernel runs in interpret mode.

Tolerance: mean |Δz| < 1e-4 in log-depth (target of the port), never
looser than the JAX package's own Pallas-vs-XLA bar of 2e-3
(tests/test_bini_pallas.py). Gaps measured on the CPU: bini_solve mean
3.8e-7 (max 1.2e-6), energy 1.2e-6 relative, same CG count (246); fused
solve vs bini_solve_pallas mean 4.4e-7 (max 2.4e-6); gate + solve mean
6.2e-7 (max 2.3e-6), info4 flags equal, energies within 3.8e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.integration import bini as jbini
from mpsfm_tpu.integration.bini_pallas import bini_solve_pallas
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.integration import bini as tbini
from mpsfm_tpu_torch.integration import bini_fused

from test_integration_bini import make_inputs, plane_scene

MEAN_TOL = 1e-4
# max |Δx| of K2 on the card vs its plain version (chip_smoke.py's K2_TOL; a
# stale or dropped halo at one CTA's seams exceeds it, as chip_smoke.py shows)
CARD_TOL = 1e-4

GH, GW = 48, 64  # gate-test grid


def _np(nt):
    return {k: np.asarray(v, np.float32) for k, v in nt._asdict().items()}


def _stack(lanes):
    return {f: np.stack([lane[f] for lane in lanes]) for f in lanes[0]}


def test_bini_solve_matches_jax(rng):
    depth_gt, normals = plane_scene(rng)
    depth_noisy, _ = plane_scene(rng, noise=0.03)
    arrays = _np(make_inputs(depth_noisy, normals))
    p = jbini.BiniParams(max_iter=5, cg_max_iter=300)
    zj, ij = jbini.bini_solve(jbini.BiniInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}), p)
    zt, it = tbini.bini_solve(convert.bini_inputs(arrays, device="cpu"), convert.bini_params(p._asdict()))
    dz = np.abs(np.asarray(zj) - zt.numpy())
    assert dz.mean() < MEAN_TOL, dz.mean()
    assert bool(ij["aborted"]) == bool(it["aborted"])
    np.testing.assert_allclose(float(it["energy"]), float(ij["energy"]), rtol=1e-5)
    np.testing.assert_allclose(float(it["energy0"]), float(ij["energy0"]), rtol=1e-5)


def test_bini_solve_fused_matches_pallas_interpret(rng):
    """Fixed-budget solve of a batch of two lanes (plain version on the CPU)
    vs the Pallas kernel in interpret mode, lane by lane."""
    depth_gt, normals = plane_scene(rng)
    lanes = [_np(make_inputs(plane_scene(rng, noise=s)[0], normals)) for s in (0.03, 0.05)]
    p = jbini.BiniParams(max_iter=3, cg_max_iter=120)
    zj = np.stack(
        [np.asarray(bini_solve_pallas(jbini.BiniInputs(**{k: jnp.asarray(v) for k, v in a.items()}), p, interpret=True))
         for a in lanes]
    )
    zt = bini_fused.bini_solve_fused(convert.bini_inputs(_stack(lanes), device="cpu"), convert.bini_params(p._asdict()))
    dz = np.abs(zj - zt.numpy())
    assert dz.mean() < MEAN_TOL, dz.mean()


def test_pcg_lanes_freeze_at_their_own_exit(rng):
    """A batched PCG stops each lane at its own tolerance, as a vmapped
    while_loop does: the two-lane run equals the two one-lane runs."""
    depth_gt, normals = plane_scene(rng)
    lanes = [_np(make_inputs(plane_scene(rng, noise=s)[0], normals)) for s in (0.01, 0.08)]
    p = tbini.BiniParams(max_iter=1, cg_max_iter=400, cg_tol=1e-3)
    both = convert.bini_inputs(_stack(lanes), device="cpu")
    wx, wy = bini_fused.weights(both.z0, p.k)
    st, b, dg = tbini._operator(both, p, wx, wy)
    active = torch.ones(2, dtype=torch.bool)
    x2, it2 = bini_fused.pcg(st, b, dg, both.z0, p.cg_max_iter, p.cg_tol, active)
    assert it2[0] != it2[1]
    for lane in range(2):
        one = bini_fused.Stencil(*(f[lane:lane + 1] for f in st))
        x1, it1 = bini_fused.pcg(one, b[lane:lane + 1], dg[lane:lane + 1], both.z0[lane:lane + 1],
                                 p.cg_max_iter, p.cg_tol, active[:1])
        assert int(it1[0]) == int(it2[lane])
        torch.testing.assert_close(x1[0], x2[lane], rtol=0, atol=0)


# ---- gate + solve on anchor rows ----

def _plane_lane(rng, noise):
    """(z0 (H,W), stat8 (8,H,W)) of a noisy slanted plane, JAX builders."""
    n = np.array([0.3, -0.2, -1.0])
    n /= np.linalg.norm(n)
    xx, yy = np.meshgrid(np.arange(GW, dtype=np.float64), np.arange(GH, dtype=np.float64))
    f = 60.0
    depth = n[2] * 5.0 / (n[0] * (xx - GW / 2) / f + n[1] * (yy - GH / 2) / f + n[2])
    depth = depth * np.exp(rng.normal(scale=noise, size=depth.shape))
    covs = np.zeros((GH, GW, 3, 3))
    for k in range(3):
        covs[..., k, k] = (np.pi / 180 * 2) ** 2
    static6 = jbini.build_static6(np.ones((GH, GW), bool), np.broadcast_to(n, (GH, GW, 3)), covs, f, f, GW / 2, GH / 2)
    prior2 = jbini.build_prior2(depth, (depth * 0.05) ** 2)
    return np.log(depth).astype(np.float32), np.concatenate([prior2, static6]).astype(np.float32)


def _abort_lane(s=1.0, jump=6.0, eps=1e-4):
    """A lane whose first IRLS round raises the energy ~10x, so it aborts.

    z0 is a ramp of slope s with a jump at the middle column large enough
    that the bilateral weights on both sides of that edge vanish; the weak
    prior (a continuous ramp, flat across that edge) then closes the jump,
    which turns the weights back onto the edge, where the normals ask for
    slope s: measured e0 = 7.29, first-round energy 69.1."""
    x = np.arange(GW, dtype=np.float64)[None, :].repeat(GH, 0)
    edge = GW // 2
    z0 = s * x + jump * (x > edge)
    z_prior = s * x - s * (x > edge)
    one = np.ones((GH, GW))
    stat8 = np.stack([eps * one, z_prior, one, one, -s * one, 0 * one, one, one])
    return z0.astype(np.float32), stat8.astype(np.float32)


def make_anchors(rng, shape, Ka, n_real, z_maps, Pc):
    """(B,6,Ka) anchor rows with de-duplicated pixels: slot codes cycle
    through >=0, -1 and -2; slots past n_real are padding (y = H, code -1,
    as the mapper pads them). Anchor log-depths sit on z_maps."""
    B = len(z_maps)
    H, W = shape
    anch = np.zeros((B, 6, Ka), np.float32)
    anch[:, 0] = H
    anch[:, 4] = -1.0
    for b in range(B):
        pix = rng.choice(H * W, n_real, replace=False)
        ys, xs = pix // W, pix % W
        codes = np.array([rng.integers(0, Pc), -1, -2])[np.arange(n_real) % 3]
        logz = z_maps[b][ys, xs]
        anch[b, 0, :n_real] = ys
        anch[b, 1, :n_real] = xs
        anch[b, 2, :n_real] = np.where(codes == -2, 0.5, np.exp(logz))  # precision or depth
        anch[b, 3, :n_real] = logz
        anch[b, 4, :n_real] = codes
        anch[b, 5, 0] = 0.01 * b  # z0 log-shift
        anch[b, 5, 1] = -0.02 * b  # prior log-shift
        r2 = rng.normal(size=3)
        anch[b, 5, 2:5] = r2 / np.linalg.norm(r2)
    return anch


def make_cov(rng, Pc):
    A = rng.normal(size=(Pc, 3, 3))
    return (A @ A.transpose(0, 2, 1) * 1e-2 + np.eye(3) * 1e-3).astype(np.float32)


def run_gate_both(anch, prev, p, cov, pairs):
    """(z, info4) of the JAX package and of the port on the same arrays."""
    zj, ij = jbini.bini_gate_solve_batch_anchors(
        jnp.asarray(anch), jnp.asarray(prev), p, jnp.asarray(cov), *[(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs]
    )
    a, pv, c, prs = convert.anchor_state(anch, prev, cov, pairs, device="cpu")
    zt, it = tbini.bini_gate_solve_batch_anchors(a, pv, convert.bini_params(p._asdict()), c, *prs)
    return np.asarray(zj), np.asarray(ij), zt.numpy(), it.numpy()


@pytest.mark.parametrize("case", ["skip+abort", "refine-both", "skip-all"])
def test_gate_solve_batch_anchors_matches_jax(rng, case):
    """Gate + solve at B = 2 with de-duplicated anchors of every slot code.
    skip+abort: lane 0 refines and aborts, lane 1 is skipped by the gate;
    refine-both: both lanes refine; skip-all: the solve is skipped."""
    p = jbini.BiniParams(max_iter=10, cg_max_iter=1000, cg_tol=1e-3, tol=5e-2, k=1.0, lambda1=1.0, lambda2=1.0)
    Pc = 5
    cov = make_cov(rng, Pc)
    if case == "skip+abort":
        pairs = [_abort_lane(), _plane_lane(rng, 0.03)]
    else:
        pairs = [_plane_lane(rng, 0.03), _plane_lane(rng, 0.05)]
    anch = make_anchors(rng, (GH, GW), 24, 12, [q[1][1] for q in pairs], Pc)
    if case == "skip+abort":
        anch[0, 2, :12] = np.where(anch[0, 4, :12] == -2, 1e-4, 1e-3)  # weak anchors keep the abort
    e0, _ = jbini.bini_energy_batch_anchors(
        jnp.asarray(anch), p, jnp.asarray(cov), *[(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs]
    )
    e0 = np.asarray(e0)
    prev = {
        "skip+abort": [[0.0, 0.0], [e0[1], 1.0]],
        "refine-both": [[0.0, 0.0], [2.0 * e0[1], 1.0]],
        "skip-all": [[e0[0], 1.0], [e0[1], 1.0]],
    }[case]
    prev = np.asarray(prev, np.float32)
    zj, ij, zt, it = run_gate_both(anch, prev, p, cov, pairs)
    np.testing.assert_array_equal(it[:, 2:], ij[:, 2:])  # refine, aborted
    np.testing.assert_allclose(it[:, :2], ij[:, :2], rtol=1e-5)  # e0, e_final
    expect = {"skip+abort": [[1, 1], [0, 0]], "refine-both": [[1, 0], [1, 0]], "skip-all": [[0, 0], [0, 0]]}[case]
    np.testing.assert_array_equal(ij[:, 2:], expect)
    dz = np.abs(zj - zt)
    assert dz.mean() < MEAN_TOL, dz.mean()


def test_energy_batch_anchors_matches_jax(rng):
    Pc = 4
    cov = make_cov(rng, Pc)
    pairs = [_plane_lane(rng, 0.03), _plane_lane(rng, 0.05)]
    anch = make_anchors(rng, (GH, GW), 16, 9, [q[1][1] for q in pairs], Pc)
    p = jbini.BiniParams()
    ej, pj = jbini.bini_energy_batch_anchors(
        jnp.asarray(anch), p, jnp.asarray(cov), *[(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs]
    )
    a, _, c, prs = convert.anchor_state(anch, np.zeros((2, 2)), cov, pairs, device="cpu")
    et, pt = tbini.bini_energy_batch_anchors(a, convert.bini_params(p._asdict()), c, *prs)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)


def test_builders_match_jax(rng):
    depth_gt, normals = plane_scene(rng)
    depth_noisy, _ = plane_scene(rng, noise=0.03)
    H, W = depth_gt.shape
    k = 40
    px = np.stack([rng.uniform(0, W - 1, k), rng.uniform(0, H - 1, k)], -1)
    args = dict(sparse_px=px, sparse_depth=depth_gt[px[:, 1].astype(int), px[:, 0].astype(int)],
                sparse_zvar=np.full(k, 1e-3))
    covs = np.zeros((H, W, 3, 3)) + np.eye(3) * 1e-3
    common = (depth_noisy, (depth_noisy * 0.05) ** 2, np.ones((H, W), bool), normals, covs, 300.0, 310.0, W / 2, H / 2)
    j = jbini.build_integration_inputs(*common, **args)
    t = tbini.build_integration_inputs(*common, **args)
    for f in jbini.BiniInputs._fields:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    np.testing.assert_array_equal(tbini.pack_inputs(t), jbini.pack_inputs(j))


def test_integrator_matches_jax(rng):
    depth_gt, normals = plane_scene(rng)
    depth_noisy, _ = plane_scene(rng, noise=0.03)
    inp = make_inputs(depth_noisy, normals)
    p = jbini.BiniParams(max_iter=4, cg_max_iter=200)
    jint = jbini.Integrator(p)
    tint = tbini.Integrator(convert.bini_params(p._asdict()), device="cpu")
    dj, cj = jint.integrate(inp)
    dt, ct = tint.integrate(inp)
    assert cj == ct
    assert np.abs(np.log(dj) - np.log(dt)).mean() < MEAN_TOL
    assert jint.should_refine(inp) == tint.should_refine(inp)


# ---- the kernel's lane groups ----

@pytest.mark.parametrize("B, H, W, max_ctas", [
    (8, 290, 387, 132),  # the main path: one group, 16 CTAs a lane
    (16, 290, 387, 132),  # two groups of 8
    (9, 290, 387, 132),
    (5, 96, 128, 3),  # one lane a group, 3 CTAs each
    (7, 500, 700, 132),  # groups of 2, 2 and 3
    (3, 1, 1, 132),
])
def test_plan_groups_covers_lanes_within_capacity(B, H, W, max_ctas):
    n_pix = H * W
    groups = bini_fused.plan_groups(B, n_pix, max_ctas)
    lanes = [g.lane0 + i for g in groups for i in range(g.lanes)]
    assert lanes == list(range(B))  # every lane in exactly one group, in order
    assert max(g.lanes for g in groups) - min(g.lanes for g in groups) <= 1
    for g in groups:
        assert g.lanes * g.cpl <= max_ctas  # all CTAs of a group resident at once
        assert 1 <= g.ppt <= bini_fused.PPT_CAP
        chunk = bini_fused.PCG_THREADS * g.ppt
        assert (g.cpl - 1) * chunk < n_pix <= g.cpl * chunk  # no CTA without pixels
        assert g.lanes * n_pix <= max_ctas * bini_fused.PCG_THREADS * bini_fused.PPT_CAP


def test_plan_groups_rejects_a_lane_too_large():
    cap = 132 * bini_fused.PCG_THREADS * bini_fused.PPT_CAP
    assert len(bini_fused.plan_groups(1, cap, 132)) == 1
    with pytest.raises(ValueError, match="co-resident"):
        bini_fused.plan_groups(1, cap + 1, 132)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng, cuda, monkeypatch):
    """K2 on the card vs its plain version on the same card: the PCG core
    with the main path's tolerance (one launch, run-to-run identical, an
    inactive lane untouched, a batch split into two lane groups equal to
    the groups run alone), and the fixed-budget solve."""
    depth_gt, normals = plane_scene(rng)
    lanes = [_np(make_inputs(plane_scene(rng, noise=s)[0], normals)) for s in (0.03, 0.05)]
    inp = convert.bini_inputs(_stack(lanes), device=cuda)
    p = tbini.BiniParams(max_iter=3, cg_max_iter=300, cg_tol=1e-3)
    wx, wy = bini_fused.weights(inp.z0, p.k)
    st, b, dg = tbini._operator(inp, p, wx, wy)
    args = (st, b, dg, inp.z0, p.cg_max_iter, p.cg_tol)
    active = torch.tensor([True, True], device=cuda)
    n0 = bini_fused.KERNEL.launches
    x, it = bini_fused.pcg(*args, active)
    torch.cuda.synchronize()
    assert bini_fused.KERNEL.launches == n0 + 1
    xr, itr = bini_fused.pcg_plain(*args, active)
    assert (it - itr).abs().max() <= 1
    assert float((x - xr).abs().max()) < CARD_TOL
    x2, it2 = bini_fused.pcg(*args, active)
    assert torch.equal(x2, x) and torch.equal(it2, it)
    x3, it3 = bini_fused.pcg(*args, torch.tensor([False, True], device=cuda))
    assert torch.equal(x3[0], inp.z0[0]) and int(it3[0]) == 0
    assert torch.equal(x3[1], x[1]) and int(it3[1]) == int(it[1])  # lanes are independent

    max_ctas = 3  # a card holding 3 CTAs: 2 hold a 96×128 lane, so one lane a group, 3 CTAs each
    assert len(bini_fused.plan_groups(2, inp.z0[0].numel(), max_ctas)) == 2
    monkeypatch.setattr(bini_fused, "_capacity", lambda dev, W: max_ctas)
    n0 = bini_fused.KERNEL.launches
    x4, it4 = bini_fused.pcg(*args, active)
    torch.cuda.synchronize()
    assert bini_fused.KERNEL.launches == n0 + 2
    assert (it4 - itr).abs().max() <= 1
    assert float((x4 - xr).abs().max()) < CARD_TOL
    for lane in range(2):
        one = [f[lane:lane + 1] for f in (*st, b, dg, inp.z0)]
        x1, it1 = bini_fused.pcg(bini_fused.Stencil(*one[:3]), *one[3:], p.cg_max_iter, p.cg_tol, active[:1])
        assert torch.equal(x1[0], x4[lane]) and int(it1[0]) == int(it4[lane])
    monkeypatch.undo()

    z = bini_fused.bini_solve_fused(inp, p)
    zr = bini_fused.bini_solve_fused_plain(inp, p)
    assert float((z - zr).abs().max()) < CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("H, W, max_ctas", [
    (64, 700, None),  # 2W > 1024 halo pixels: the halo's tail loop; the card's own capacity
    (8, 700, 22),  # one pixel a thread: a CTA's 512 pixels are fewer than W
])
def test_kernel_wide_images_on_card(rng, cuda, monkeypatch, H, W, max_ctas):
    """K2's PCG on images wider than 512 pixels vs its plain version, on a
    random diagonally dominant stencil at two lanes."""
    ex, ey, pa, b, x0 = (torch.as_tensor(rng.random((2, H, W), dtype=np.float32), device=cuda)
                         for _ in range(5))
    ex[..., -1] = 0.0  # no edge beyond the last column and row
    ey[..., -1, :] = 0.0
    st = bini_fused.Stencil(ex, ey, 0.05 + 0.1 * pa)
    args = (st, b - 0.5, bini_fused.diag(st), x0, 1000, 1e-3)
    active = torch.tensor([True, True], device=cuda)
    if max_ctas is not None:
        monkeypatch.setattr(bini_fused, "_capacity", lambda dev, W: max_ctas)
    (g,) = bini_fused.plan_groups(2, H * W, bini_fused._capacity(x0.device.index, W))
    assert W > bini_fused.PCG_THREADS and (max_ctas is None or bini_fused.PCG_THREADS * g.ppt < W)
    x, it = bini_fused.pcg(*args, active)
    xr, itr = bini_fused.pcg_plain(*args, active)
    assert int(itr.min()) > 10
    assert (it - itr).abs().max() <= 1
    assert float((x - xr).abs().max()) < CARD_TOL
