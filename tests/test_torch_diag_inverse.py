"""The uncertainty chain's BiNI side: diag(H⁻¹) by deflated PCG, the
downscaled z0, and the updated keypoint depth variances — the PyTorch port
against the JAX package on the CPU.

Both packages get the same numpy inputs (slanted planes on 48×64 grids,
anchors of every slot code, chunks of 8 queries). On the CPU the port's
deflated PCG runs its plain version (integration/bini_diag.py); the JAX
package runs _diag_inverse_at_impl as XLA ops.

Tolerances: variances 1e-3 relative (measured on the CPU: 4.4e-6
relative at 16 iterations, see ROADMAP.md queue 3);
resize_log_dev 1e-6 absolute in log-depth (exp/log of two libraries);
the updated variances and flags exactly (they are elementwise float32
ops); Z bit for bit.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.integration import bini as jbini
from mpsfm_tpu.scene import image_priors as jip
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.integration import bini as tbini
from mpsfm_tpu_torch.integration import bini_diag
from mpsfm_tpu_torch.scene import image_priors as tip

from test_torch_bini import GH, GW, _np, _plane_lane, make_anchors, make_cov

VAR_RTOL = 1e-3
P16 = dict(max_iter=10, cg_max_iter=16, cg_tol=1e-3, tol=5e-2, k=1.0, lambda1=1.0, lambda2=1.0)


def _problem(rng, B=2, Kp=24):
    Pc = 5
    cov = make_cov(rng, Pc)
    pairs = [_plane_lane(rng, 0.03 + 0.02 * b) for b in range(B)]
    anch = make_anchors(rng, (GH, GW), 24, 12, [q[1][1] for q in pairs], Pc)
    rowcol = np.stack([rng.integers(0, GH, (B, Kp)), rng.integers(0, GW, (B, Kp))], 1).astype(np.int32)
    rowcol[:, :, -3:] = 0  # padded queries: pixel (0, 0), computed too
    return anch, cov, pairs, rowcol


def _jax(pairs):
    return [(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs]


def _packed(anch, cov, pairs):
    """The JAX package's packed (B,11,H,W) rows of the problem, numpy."""
    _, packed = jbini.bini_energy_batch_anchors(jnp.asarray(anch), jbini.BiniParams(), jnp.asarray(cov), *_jax(pairs))
    return np.array(packed)


@pytest.mark.parametrize("n", [2, 3, 24, 32, 48, 64, 145, 193])
def test_linspace_matches_jax(n):
    """Z's axes equal the JAX package's jitted jnp.linspace bit for bit (in
    the program of _diag_inverse_at_impl), where torch.linspace does not."""
    ref = np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)[:, None]
                             * jnp.ones((1, 2), jnp.float32))())[:, 0]
    np.testing.assert_array_equal(bini_diag.linspace_f32(n).numpy(), ref)
    Z = bini_diag.basis(bini_diag.linspace_f32(n), bini_diag.linspace_f32(3)).numpy()
    np.testing.assert_array_equal(Z[1, 0], ref)
    np.testing.assert_array_equal(Z[2, :, 0], np.asarray(jax.jit(lambda: jnp.linspace(-1.0, 1.0, 3, dtype=jnp.float32))()))


def test_diag_inverse_at_matches_jax(rng):
    anch, cov, pairs, rowcol = _problem(rng, B=1)
    q = _packed(anch, cov, pairs)[0]
    fields = {f: q[i] for i, f in enumerate(jbini.TRANSPORT_ORDER)}
    p = jbini.BiniParams(**P16)
    ref = np.asarray(jbini.diag_inverse_at(jbini.BiniInputs(**{k: jnp.asarray(v) for k, v in fields.items()}), p,
                                           jnp.asarray(q[0]), jnp.asarray(rowcol[0, 0]), jnp.asarray(rowcol[0, 1]),
                                           chunk=8))
    got = tbini.diag_inverse_at(convert.bini_inputs(fields, device="cpu"), tbini.BiniParams(**P16),
                                torch.as_tensor(q[0]), torch.as_tensor(rowcol[0, 0]), torch.as_tensor(rowcol[0, 1]),
                                chunk=8).numpy()
    assert (ref > 0).all()
    np.testing.assert_allclose(got, ref, rtol=VAR_RTOL)


def test_diag_inverse_at_batch_matches_jax(rng):
    anch, cov, pairs, rowcol = _problem(rng)
    packed = _packed(anch, cov, pairs)
    ref = np.asarray(jbini.diag_inverse_at_batch(jnp.asarray(packed), jbini.BiniParams(**P16),
                                                 jnp.asarray(rowcol[:, 0]), jnp.asarray(rowcol[:, 1]), chunk=8))
    got = tbini.diag_inverse_at_batch(torch.as_tensor(packed), tbini.BiniParams(**P16), torch.as_tensor(rowcol[:, 0]),
                                      torch.as_tensor(rowcol[:, 1]), chunk=8).numpy()
    np.testing.assert_allclose(got, ref, rtol=VAR_RTOL)


def test_diag_inverse_at_batch_anchors_matches_jax(rng):
    anch, cov, pairs, rowcol = _problem(rng)
    ref = np.asarray(jbini.diag_inverse_at_batch_anchors(jnp.asarray(anch), jnp.asarray(rowcol),
                                                         jbini.BiniParams(**P16), 8, jnp.asarray(cov), *_jax(pairs)))
    a, _, c, prs = convert.anchor_state(anch, np.zeros((2, 2)), cov, pairs, device="cpu")
    got = tbini.diag_inverse_at_batch_anchors(a, torch.as_tensor(rowcol), tbini.BiniParams(**P16), 8, c, *prs).numpy()
    np.testing.assert_allclose(got, ref, rtol=VAR_RTOL)


@pytest.mark.parametrize("changed", [[0.0, 1.0], [0.0, 0.0]])
def test_diag_inverse_gated_matches_jax(rng, changed):
    """Every lane is solved when any changed; zeros when none did."""
    anch, cov, pairs, rowcol = _problem(rng)
    flags = np.asarray(changed, np.float32)
    ref = np.asarray(jbini.diag_inverse_gated_batch_anchors(
        jnp.asarray(anch), jnp.asarray(rowcol), jbini.BiniParams(**P16), 8, jnp.asarray(cov), jnp.asarray(flags),
        *_jax(pairs)))
    a, _, c, prs = convert.anchor_state(anch, np.zeros((2, 2)), cov, pairs, device="cpu")
    got = tbini.diag_inverse_gated_batch_anchors(a, torch.as_tensor(rowcol), tbini.BiniParams(**P16), 8, c,
                                                 torch.as_tensor(flags), *prs).numpy()
    assert got.shape == ref.shape == rowcol[:, 0].shape
    if any(changed):
        assert (ref > 0).all()
        np.testing.assert_allclose(got, ref, rtol=VAR_RTOL)
    else:
        assert (ref == 0).all() and (got == 0).all()


# ---- properties, on the port alone (tests/test_integration_bini.py's, on 48×64) ----

FX = 60.0


def _inputs(depth, normals, unc, sparse=None):
    covs = np.zeros((GH, GW, 3, 3))
    for k in range(3):
        covs[..., k, k] = (np.pi / 180 * 2) ** 2
    kw = {} if sparse is None else dict(sparse_px=sparse[0], sparse_depth=sparse[1], sparse_zvar=sparse[2])
    inp = tbini.build_integration_inputs(depth, (depth * unc) ** 2, np.ones((GH, GW), bool), normals, covs,
                                         FX, FX, GW / 2, GH / 2, **kw)
    return convert.bini_inputs(_np(inp), device="cpu")


def _plane():
    n = np.array([0.3, -0.2, -1.0])
    n /= np.linalg.norm(n)
    xx, yy = np.meshgrid(np.arange(GW, dtype=np.float64), np.arange(GH, dtype=np.float64))
    depth = n[2] * 5.0 / (n[0] * (xx - GW / 2) / FX + n[1] * (yy - GH / 2) / FX + n[2])
    return depth, np.broadcast_to(n, (GH, GW, 3)).copy()


def test_anchored_pixel_more_certain(rng):
    depth, normals = _plane()
    xs, ys = rng.integers(3, GW // 2, 60), rng.integers(3, GH - 3, 60)  # anchors in the left half only
    inp = _inputs(depth, normals, 2.0, (np.stack([xs, ys], -1).astype(np.float64), depth[ys, xs], np.full(60, 1e-6)))
    p = tbini.BiniParams(cg_max_iter=300)
    z, _ = tbini.bini_solve(inp, p)
    var = tbini.diag_inverse_at(inp, p, z, torch.tensor([GH // 2, GH // 2]), torch.tensor([GW // 4, GW - 4]),
                                chunk=2).numpy()
    assert (var > 0).all()
    assert var[0] < var[1]


def test_deflation_accuracy_on_discontinuous_scene(rng):
    """16 deflated iterations within 10% of 400 on a depth step, both sides."""
    depth = np.full((GH, GW), 4.0)
    depth[GH // 2:] = 2.0
    normals = np.zeros((GH, GW, 3))
    normals[..., 2] = -1.0
    inp = _inputs(depth * np.exp(rng.normal(scale=0.01, size=depth.shape)), normals, 0.08)
    z, _ = tbini.bini_solve(inp, tbini.BiniParams(max_iter=4, cg_max_iter=300))
    rows = torch.tensor([4, GH // 4, GH // 2 - 2, GH // 2 + 2, 3 * GH // 4, GH - 4])
    cols = torch.tensor([5, GW // 2, GW - 5, 5, GW // 2, GW - 5])
    ref = tbini.diag_inverse_at(inp, tbini.BiniParams(cg_max_iter=400), z, rows, cols, chunk=8).numpy()
    lo = tbini.diag_inverse_at(inp, tbini.BiniParams(cg_max_iter=16), z, rows, cols, chunk=8).numpy()
    assert (ref > 0).all() and (lo > 0).all()
    assert (np.abs(lo - ref) / ref).max() < 0.10


# ---- the chain's small device functions ----

@pytest.mark.parametrize("shift, out_hw", [(0.0, (24, 32)), (0.3, (17, 45))])
def test_resize_log_dev_matches_jax(rng, shift, out_hw):
    z = np.log(rng.uniform(1.0, 5.0, (GH, GW))).astype(np.float32)
    ref = np.asarray(jbini.resize_log_dev(jnp.asarray(z), jnp.float32(shift), out_hw))
    got = tbini.resize_log_dev(torch.as_tensor(z), shift, out_hw).numpy()
    assert got.shape == ref.shape == out_hw
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_take_z(rng):
    zb = rng.normal(size=(3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(tbini.take_z(torch.as_tensor(zb), 2).numpy(), np.asarray(jbini.take_z(jnp.asarray(zb), 2)))


def test_changed_flag_and_updated_unc_match_jax(rng):
    """info4 rows [e0, e, refine, aborted]: changed = refine and not aborted;
    the new variance is floored at (floor·dprior)² and 1e-12, and only
    changed lanes take it."""
    info4 = np.array([[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 0]], np.float32)
    varlog = rng.uniform(0, 2e-4, (3, 16)).astype(np.float32)
    varlog[:, :2] = 0.0  # below every floor
    old = rng.uniform(0.01, 0.1, 16).astype(np.float32)
    dprior = rng.uniform(1.0, 6.0, 16).astype(np.float32)
    for lane in range(3):
        assert float(tip._changed_flag_dev(torch.as_tensor(info4), lane)) == float(
            jip._changed_flag_dev(jnp.asarray(info4), jnp.int32(lane)))
        for floor in (0.01, 0.0):
            ref = np.asarray(jip._updated_unc_dev(jnp.asarray(varlog), jnp.int32(lane), jnp.asarray(old),
                                                  jnp.asarray(dprior), jnp.asarray(info4), jnp.int32(lane),
                                                  jnp.float32(floor)))
            got = tip._updated_unc_dev(torch.as_tensor(varlog), lane, torch.as_tensor(old), torch.as_tensor(dprior),
                                       torch.as_tensor(info4), lane, floor).numpy()
            np.testing.assert_array_equal(got, ref)
            assert (got == old).all() == (lane != 0)


# ---- K3's launch plan (csrc/bini_diag.cu), on the CPU ----

def _cu_define(name):
    src = (Path(bini_diag.__file__).resolve().parents[1] / "csrc" / "bini_diag.cu").read_text()
    return re.search(rf"^#define {name} (.+)$", src, re.M).group(1).strip()


def test_plan_constants_match_kernel_source():
    """The planner's copies of the kernel's layout constants."""
    assert int(_cu_define("DG_THREADS")) == bini_diag.THREADS
    assert int(_cu_define("DG_RMAX")) == bini_diag.R_MAX
    assert int(_cu_define("DG_CMAX")) == bini_diag.C_MAX
    assert int(_cu_define("DG_SMEM_BYTES")) == bini_diag.SMEM_BYTES
    assert _cu_define(r"DG_RED_FLOATS\(R\)") == "(2 * (DG_WARPS + 2) * 3 * (R))"
    assert bini_diag.smem_bytes(145, 193, 8, 7) == 4 * (2 * 7 * 19 * 193 + 2 * (16 + 2) * 3 * 7)


@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_plan_fits_every_grid_up_to_387(orientation):
    """Every grid with a long side up to 387 (the integration grid's cap,
    int_covs at full or half size) gets a plan: a cluster of at most 8 CTAs,
    1 to 8 right-hand sides, within one CTA's shared memory (none in global
    memory)."""
    seen = set()
    for long in range(1, 388):
        for short in range(1, long + 1):
            H, W = (short, long) if orientation == "landscape" else (long, short)
            pl = bini_diag.plan(H, W)
            assert not pl.gmem
            assert pl.C in (1, 2, 4, 8) and pl.C <= bini_diag.C_MAX and 1 <= pl.R <= bini_diag.R_MAX
            assert pl.bh == -(-H // pl.C)
            assert pl.smem == bini_diag.smem_bytes(H, W, pl.C, pl.R) <= bini_diag.SMEM_BYTES
            # R is the most that fits at C_MAX, and no smaller C reaches it
            assert bini_diag.smem_bytes(H, W, bini_diag.C_MAX, pl.R + 1) > bini_diag.SMEM_BYTES or pl.R == bini_diag.R_MAX
            assert pl.C == 1 or bini_diag.smem_bytes(H, W, pl.C // 2, pl.R) > bini_diag.SMEM_BYTES
            seen.add((pl.C, pl.R))
    assert (8, 1) in seen and (1, 8) in seen


@pytest.mark.parametrize("H, W, C, R", [
    (145, 193, 8, 7),  # the main path's int_covs grid
    (155, 193, 8, 7),
    (193, 193, 8, 5),
    (290, 387, 8, 2),  # downscaled: False at 4:3
    (387, 387, 8, 1),
    (48, 64, 1, 8),
    (26, 1100, 8, 6),  # 4 rows a band: the eighth band is empty
    (232, 1000, 8, 1),  # 29 000 pixels a band, the most that fits
])
def test_plan_examples(H, W, C, R):
    pl = bini_diag.plan(H, W)
    assert (pl.C, pl.R) == (C, R)


@pytest.mark.parametrize("H, W", [(232, 1001), (233, 1000), (400, 600), (1000, 1000)])
def test_plan_keeps_bands_in_global_memory(H, W):
    """A band of C = 8 at R = 1 above a CTA's shared memory (more than 29 002
    pixels) is not refused: p and r go to global memory, C = 8, R = R_MAX,
    and the CTA's shared memory holds the reduction buffers only."""
    assert bini_diag.smem_bytes(H, W, 8, 1) > bini_diag.SMEM_BYTES
    pl = bini_diag.plan(H, W)
    assert pl.gmem and (pl.C, pl.R) == (8, bini_diag.R_MAX)
    assert pl.bh == -(-H // 8)
    assert pl.smem == bini_diag.smem_bytes(H, W, 8, bini_diag.R_MAX, gmem=True) == 4 * 2 * (16 + 2) * 3 * 8


@pytest.mark.parametrize("H, W, K, active, slots", [
    (400, 600, 64, 15, 15),  # 2 lanes x 64 queries: 16 groups of 8, 15 clusters co-resident
    (400, 600, 16, 15, 4),  # fewer groups than clusters: one cluster a group
    (232, 1001, 2048, 16, 16),
    (145, 193, 2051, 15, 586),  # shared memory: one cluster a group, no workspace
])
def test_workspace_size(H, W, K, active, slots):
    """The workspace the wrapper allocates: in global mode min(groups,
    active) clusters of C CTAs, each CTA a slice of p and r of its band for
    R right-hand sides, 2·R·⌈H/C⌉·W floats; none in shared-memory mode."""
    pl = bini_diag.plan(H, W)
    groups = 2 * K // pl.R
    n, floats = bini_diag.workspace(pl, W, groups, active)
    assert n == slots
    assert floats == (slots * 8 * 2 * 8 * -(-H // 8) * W if pl.gmem else 0)
    if (H, W) == (400, 600):  # ~15 MB a cluster
        assert floats * 4 / slots == 8 * 2 * 8 * 50 * 600 * 4 == 15_360_000


@pytest.mark.parametrize("K, R", [(41, 7), (40, 5), (1, 8), (3, 1)])
def test_pad_queries(rng, K, R):
    """Queries are padded with pixel (0, 0) to a multiple of R; the real
    ones keep their place."""
    rows = torch.as_tensor(rng.integers(1, 50, (2, K)))
    cols = torch.as_tensor(rng.integers(1, 50, (2, K)), dtype=torch.int32)
    rp, cp = bini_diag.pad_queries(rows, cols, R)
    Kp = -(-K // R) * R
    assert rp.shape == cp.shape == (2, Kp) and rp.dtype == rows.dtype and cp.dtype == cols.dtype
    assert torch.equal(rp[:, :K], rows) and torch.equal(cp[:, :K], cols)
    assert (rp[:, K:] == 0).all() and (cp[:, K:] == 0).all()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_problem(rng, dev, H, W, K):
    """2 lanes of random diagonally dominant stencils on H×W, their
    deflation set-up and K queries each, pixel (0, 0) among them."""
    from mpsfm_tpu_torch.integration import bini_fused

    ex, ey, pa = (torch.as_tensor(rng.random((2, H, W), dtype=np.float32), device=dev) for _ in range(3))
    ex[..., -1] = 0.0
    ey[..., -1, :] = 0.0
    st = bini_fused.Stencil(ex, ey, 1e-3 * pa)
    dfl = bini_diag.deflation(st, bini_fused.diag(st))
    rows = torch.as_tensor(rng.integers(0, H, (2, K)), device=dev)
    cols = torch.as_tensor(rng.integers(0, W, (2, K)), device=dev)
    rows[:, 0] = cols[:, 0] = 0
    return st, dfl, rows, cols


@pytest.mark.cuda
@pytest.mark.parametrize("H, W, K", [
    (GH, GW, 40), (145, 193, 40), (26, 1100, 40),
    (155, 193, 41), (193, 193, 41), (290, 387, 41), (387, 387, 41),
    (400, 600, 64), (232, 1001, 64),
])
def test_kernel_matches_plain_on_card(rng, cuda, H, W, K):
    """K3 against its plain version on the card: 2 lanes of random
    diagonally dominant stencils, K queries each (pixel (0, 0) among
    them), 16 iterations; bit-identical from run to run, one launch. 48×64
    is one CTA a cluster with 8 right-hand sides; the others take clusters
    of 8 CTAs whose bands split H unevenly (26×1100: the eighth band is
    empty); 155×193 and larger were refused by one block a right-hand side;
    41 queries are no multiple of any R > 1 (padded queries); 400×600 and
    232×1001 keep their bands in global memory (C = 8, R = 8)."""
    st, dfl, rows, cols = _card_problem(rng, cuda, H, W, K)
    n0 = bini_diag.KERNEL.launches
    v = bini_diag.deflated_pcg(st, dfl, rows, cols, 16)
    torch.cuda.synchronize()
    assert bini_diag.KERNEL.launches == n0 + 1
    assert v.shape == (2, K)
    ref = bini_diag.deflated_pcg_plain(st, dfl, rows, cols, 16)
    assert bool((ref > 0).all())
    assert float(((v - ref).abs() / ref).max()) <= VAR_RTOL
    assert torch.equal(bini_diag.deflated_pcg(st, dfl, rows, cols, 16), v)


@pytest.mark.cuda
def test_global_mode_equals_shared_mode_on_card(rng, cuda):
    """At the same (C, R) the global mode runs the shared-memory mode's
    arithmetic in the same order: the variances are equal bit for bit (145×193,
    C = 8, R = 7, 64 queries; the global mode loops over the groups on fewer
    clusters than groups when the card holds fewer)."""
    st, dfl, rows, cols = _card_problem(rng, cuda, 145, 193, 64)
    pl = bini_diag.plan(145, 193)
    assert not pl.gmem
    shared = bini_diag._pcg_cuda(st, dfl, rows, cols, 16)
    glob = bini_diag._pcg_cuda(st, dfl, rows, cols, 16, pl._replace(gmem=True, smem=bini_diag.smem_bytes(
        145, 193, pl.C, pl.R, gmem=True)))
    assert torch.equal(glob, shared)
