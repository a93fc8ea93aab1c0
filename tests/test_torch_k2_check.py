"""chip_smoke.k2_pcg_check's rule on the CPU, with stand-ins for K2.

A lane passes with iteration counts on K2 and on the plain version within
K2_STALL and max |Δx| <= K2_TOL. A lane that fails that at counts that
differ stopped elsewhere (a residual stagnating near the tolerance) and is
held by k2_stall_rule: at a fixed budget of its larger count K2 within
K2_TOL of the plain version over K2_SHORT iterations and no farther from a
float64 run than K2_RATIO times the plain version, and K2's count within
the plain version's counts at the tolerance times and over K2_RATIO. A
lane with equal counts and max |Δx| > K2_TOL fails. Here K2's lane 1
is made to stop elsewhere: at 1.9 times the tolerance it passes; at 64
times, where it stopped fails it; K2 on a stencil 1% off stops elsewhere
and fails the fixed-budget rule; a lane off by 1e-3 at equal counts fails;
K2 equal to the plain version passes with no lane on the stall rule.
k2_flake_probe.py's probe runs on the CPU at the phase's small size.
"""

import pytest
import torch

import chip_smoke
from mpsfm_tpu_torch.integration import bini_fused

PLAIN = bini_fused.pcg_plain


def problem(B=3, H=24, W=32, seed=0):
    """A stencil with a weak diagonal on B lanes (~110-120 iterations to
    the tolerance 1e-4, ~70-80 to 64 times it)."""
    g = torch.Generator().manual_seed(seed)
    ex, ey, b, x0 = (torch.rand((B, H, W), generator=g) for _ in range(4))
    ex[..., -1] = 0.0
    ey[..., -1, :] = 0.0
    st = bini_fused.Stencil(ex, ey, torch.full_like(ex, 0.002))
    return (st, b, bini_fused.diag(st), x0, 2000, 1e-4), torch.ones(B, dtype=torch.bool)


def early_on_lane(lane, factor=64.0):
    """The plain PCG, but `lane` stopped at a tolerance `factor` times
    looser; a float64 run and a fixed budget are left as they are."""
    def run(st, b, dg, x0, budget, tol, active):
        x, it = PLAIN(st, b, dg, x0, budget, tol, active)
        if b.dtype == torch.float64 or tol < 0:
            return x, it
        xe, ite = PLAIN(st, b, dg, x0, budget, tol * factor, active)
        x, it = x.clone(), it.clone()
        x[lane], it[lane] = xe[lane], ite[lane]
        return x, it

    return run


def check(monkeypatch, kernel, plain=PLAIN):
    monkeypatch.setattr(bini_fused, "pcg", kernel)
    monkeypatch.setattr(bini_fused, "pcg_plain", plain)
    args, active = problem()
    return chip_smoke.k2_pcg_check("stand-in", args, active)


def test_equal_versions_pass_without_the_stall_rule(monkeypatch, capsys):
    x, iters, err, xr, iters_r = check(monkeypatch, PLAIN)
    assert err == 0.0 and torch.equal(iters, iters_r)
    assert "stopped elsewhere" not in capsys.readouterr().out


def test_a_lane_stopped_within_the_plain_versions_window_is_held_by_the_stall_rule(monkeypatch, capsys):
    """K2's lane 1 stops at 1.9 times the tolerance, several iterations
    before the plain version but after the plain version at twice it."""
    x, iters, err, xr, iters_r = check(monkeypatch, early_on_lane(1, 1.9))
    assert int((iters - iters_r).abs()[1]) > chip_smoke.K2_STALL and err > chip_smoke.K2_TOL
    assert int((iters - iters_r).abs()[[0, 2]].max()) == 0
    out = capsys.readouterr().out
    assert "lanes [1] stopped elsewhere" in out and ": [True]; (b)" in out and out.count("[True]") == 2


def test_a_lane_where_the_kernel_stops_early_fails(monkeypatch, capsys):
    with pytest.raises(AssertionError, match="K2 PCG disagrees"):
        check(monkeypatch, early_on_lane(1))
    assert ": [True]; (b)" in capsys.readouterr().out  # the arithmetic is sound; where it stopped fails it


def test_a_kernel_off_in_its_arithmetic_fails_the_fixed_budget_rule(monkeypatch, capsys):
    """K2 on a stencil 1% off (its lanes stop elsewhere, lane 1 at a 64
    times tighter tolerance): the fixed-budget rule fails it."""
    late = early_on_lane(1, 1 / 64)

    def off(st, *args):
        return late(bini_fused.Stencil(st.ex, st.ey, st.pa * 1.01), *args)

    with pytest.raises(AssertionError, match="K2 PCG disagrees"):
        check(monkeypatch, off)
    out = capsys.readouterr().out
    assert "stopped elsewhere" in out and "False" in out.split("(a) ")[1].split("; (b)")[0]


def test_a_lane_off_at_equal_counts_fails(monkeypatch):
    def off(*args):
        x, it = PLAIN(*args)
        x = x.clone()
        x[0] += 1e-3
        return x, it

    with pytest.raises(AssertionError, match="K2 PCG disagrees"):
        check(monkeypatch, off)


def test_k2_flake_probe_on_the_cpu():
    """k2_flake_probe.probe at the dense modes phase's small size, every
    device the CPU (K2 is its plain version there): both PCGs kept, run to
    run identical, no draw failing either rule; without a card the script
    exits 1."""
    import k2_flake_probe

    out = k2_flake_probe.probe(torch.device("cpu"), {}, "small", 2)
    assert set(out["pcgs"]) == {"K2 widest", "K2 busiest"}
    for row in out["pcgs"].values():
        assert row["run_to_run_identical"] and row["iterations"] == row["plain_iterations"]
        assert row["old_rule_failures"] == row["repaired_rule_failures"] == 0 and row["failed_draws"] == []
    if not torch.cuda.is_available():
        assert k2_flake_probe.main() == 1
