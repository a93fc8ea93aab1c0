"""Dense LM-Schur BA: the PyTorch port against the JAX package on the CPU.

The port's reduced solve runs K1's plain version on the CPU; the JAX
package solves it with XLA's cho_factor. Tolerances: the same accepted
count, cost0 to 1e-5 relative, cost and cost_history to 1e-3 relative,
quat/t to 1e-4 and xyz to 1e-3 absolute (tighter than tests/test_ba.py's
5e-3 / 2e-2 between the sparse and dense JAX solvers).

Gaps measured on the CPU at 8 cams × 256 pts: cost0 equal, cost 1e-6
relative; with depth |Δquat| 1.0e-7, |Δt| 1.4e-6, |Δxyz| 2.9e-6; without
depth |Δquat| 3.3e-6, |Δt| 6.7e-5, |Δxyz| 6.0e-4. The rel_tol latch
(stop at the first accepted step that moves the cost by < 1e-6
relative) fires at different iterations in the two packages, because
the last steps' cost changes sit at float32 rounding level: the JAX
loop runs 12 iterations (5 accepted), the port's 5 (5 accepted). So the
latch case compares cost_history over the iterations both loops ran,
and not the accepted count, which would rest on the order of the sums.
The LM decisions are compared where they do not: with rel_tol = 0 over
the first DECISION_ITERS iterations, whose relative cost changes (0.97,
1.5e-2, 1.3e-4 on this bundle) are far above float32 resolution; the
fourth is 3.6e-6, below the 1e-5 the test requires of them.
"""

import numpy as np
import pytest

from __graft_entry__ import _synthetic_ba_data
from mpsfm_tpu.ba.dense import densify as jdensify
from mpsfm_tpu.ba.dense import solve_ba_dense as jsolve
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.ba import dense as tdense


def _ran(hist, cost0):
    """Iterations the loop ran: the JAX while_loop leaves cost0 after its exit."""
    hist = np.asarray(hist)
    n = len(hist)
    while n > 0 and hist[n - 1] == cost0:
        n -= 1
    return n


DECISION_ITERS = 3  # LM iterations whose relative cost change is ≥ 1e-5 on the 8 × 256 bundle


def _compare(C, P, with_depth, max_iters=20, rel_tol=1e-6):
    """Port vs JAX. With rel_tol = 0 (no latch) the accepted count and the
    whole cost history must agree, and every step must move the cost by at
    least 1e-5 relative in JAX, far above float32 resolution."""
    sparse = _synthetic_ba_data(n_cams=C, n_pts=P, with_depth=with_depth)
    jd = jdensify(sparse, C, P)
    qj, tj, xj, ij = jsolve(jd, max_iters=max_iters, rel_tol=rel_tol)
    arrays = {k: np.asarray(v) for k, v in jd._asdict().items()}
    qt, tt, xt, it = tdense.solve_ba_dense(
        convert.dense_ba_data(arrays, device="cpu"), max_iters=max_iters, rel_tol=rel_tol
    )
    cost0 = float(ij["cost0"])
    if rel_tol == 0.0:
        hj = np.asarray(ij["cost_history"], np.float64)
        prev = np.concatenate([[cost0], hj[:-1]])
        assert ((prev - hj) / prev >= 1e-5).all(), (prev - hj) / prev
        assert it["accepted"] == int(ij["accepted"]) == max_iters
    np.testing.assert_allclose(float(it["cost0"]), cost0, rtol=1e-5)
    np.testing.assert_allclose(float(it["cost"]), float(ij["cost"]), rtol=1e-3)
    assert float(it["cost"]) < cost0
    hj, ht = np.asarray(ij["cost_history"]), it["cost_history"].numpy()
    n = min(_ran(hj, cost0), _ran(ht, float(it["cost0"])))
    assert n >= it["accepted"]
    np.testing.assert_allclose(ht[:n], hj[:n], rtol=1e-3)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-3)


@pytest.mark.parametrize("mode", ["latch", "decisions"])
@pytest.mark.parametrize("with_depth", [True, False])
def test_solve_ba_dense_matches_jax(with_depth, mode):
    """latch: the default run (20 iterations, rel_tol 1e-6); decisions:
    rel_tol 0 over the iterations whose cost changes are far above float32
    resolution, where the accepted counts must agree."""
    if mode == "latch":
        _compare(8, 256, with_depth)
    else:
        _compare(8, 256, with_depth, max_iters=DECISION_ITERS, rel_tol=0.0)


@pytest.mark.slow
def test_solve_ba_dense_matches_jax_bench_size():
    _compare(64, 8192, True)


def test_densify_matches_jax():
    class Host:
        pass

    sparse = _synthetic_ba_data(n_cams=6, n_pts=64)
    host = Host()
    for k, v in sparse._asdict().items():
        setattr(host, k, np.asarray(v))
    jd = jdensify(sparse, 6, 64)
    td = tdense.densify(host, 6, 64, device="cpu")
    for f in jd._fields:
        np.testing.assert_array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f)))


def test_cost_and_normal_equations_match_jax():
    """The assembled normal equations (Hcc, g_c, Hpp, g_p, T) at the start."""
    from mpsfm_tpu.ba import dense as jd_mod
    from mpsfm_tpu.ba import losses as jl

    sparse = _synthetic_ba_data(n_cams=5, n_pts=96)
    jd = jdensify(sparse, 5, 96)
    td = convert.dense_ba_data({k: np.asarray(v) for k, v in jd._asdict().items()}, device="cpu")
    nej = jd_mod._assemble_ne_dense(jd, jd.quat, jd.t, jd.xyz, jl.SOFT_L1, jl.CAUCHY)
    net = tdense._assemble_ne_dense(td, td.quat, td.t, td.xyz, jl.SOFT_L1, jl.CAUCHY)
    for a, b in zip(net, nej):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    cj = float(jd_mod._cost_only(jd, jd.quat, jd.t, jd.xyz, jl.SOFT_L1, jl.CAUCHY))
    ct = float(tdense._cost_only(td, td.quat, td.t, td.xyz, jl.SOFT_L1, jl.CAUCHY))
    np.testing.assert_allclose(ct, cj, rtol=1e-6)
