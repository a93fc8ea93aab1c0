"""K1, the reduced-camera Cholesky solve: the port against the JAX package.

On the CPU the port's cholesky_solve runs its plain version (the kernel's
blocked algorithm in torch: 32-wide panels, the last one ragged); the JAX
package's Pallas kernel runs in interpret mode. Tolerance atol 1e-4, the
bar of tests/test_ba.py::test_pallas_cholesky_solve_interpret. Gaps
measured on the CPU (max |Δx|; max |x| is 0.18 at K = 6 and 0.005 at
K = 390; K = 1 gives the JAX kernel's value exactly), at K = 6 / 32 /
42 / 192 / 198 / 384 / 390: vs interpret mode 7.5e-9 / 7.5e-9 / 9.3e-9 /
7.0e-9 / 9.3e-9 / 5.1e-9 / 5.6e-9, vs a float64 solve 1.8e-8 / 1.3e-8 /
9.6e-9 / 4.3e-9 / 3.5e-9 / 1.8e-9 / 2.0e-9; vs a float64 solve 1.1e-9
at K = 1024. A zeroed row and column (djj = 0, clamped to 1e-20) give
x = 0 there in both packages; the rest agrees to 1.5e-8 with the JAX
kernel and 1.0e-8 with a float64 solve. The less dominant S (shift
0.01; max |x| 4.3 / 2.0 / 0.46 / 0.19) at K = 6 / 42 / 198 / 390: max |Δx|
/ max |x| vs interpret mode 2.2e-7 / 7.2e-6 / 5.2e-6 / 6.5e-6, vs a
float64 solve 1.1e-6 / 9.5e-7 / 2.8e-6 / 2.9e-6; residual 1.0e-6 /
5.1e-6 / 4.2e-6 / 5.7e-6.

The card-only cases hold the kernel against the plain version on the
card at both shifts and on the zeroed row and column, by the same
absolute, relative and residual bounds.

With many right-hand sides (rhs (K,N), the point covariances' solve) the
plain version is held against jax.scipy.linalg.cho_factor + cho_solve at
ragged K and N, atol 1e-4 and the relative and residual bounds of REL; on
the card the kernel (csrc/cholesky_many.cu) against the plain version,
at the covariances' shape and at ragged ones.
"""

import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from mpsfm_tpu.ba.pallas_cholesky import cholesky_solve as jchol
from mpsfm_tpu_torch.ba import cholesky


# S = A·Aᵀ + shift·K·I. For each shift, the bound on max |Δx| / max |x| between
# two solves and on the residual ‖S·x − b‖ / ‖b‖ (float64). Two float32
# orders differ by about a tenth of it; a trailing update that misses one
# 32×64 tile of one panel is off by a hundred times it or more. At shift 1
# S is strongly diagonally dominant (|x| ~ 1e-3); at shift 0.01 an update
# that goes missing shows more.
REL = {1.0: 1e-5, 0.01: 1e-4}


def _spd(rng, K, shift=1.0):
    A = rng.normal(size=(K, K)).astype(np.float32)
    S = A @ A.T + shift * K * np.eye(K, dtype=np.float32)
    return S, rng.normal(size=(K,)).astype(np.float32)


def _rel_gap(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _residual(S, b, x):
    S, b, x = (np.asarray(a, np.float64) for a in (S, b, x))
    return float(np.linalg.norm(S @ x - b) / np.linalg.norm(b))


@pytest.mark.parametrize("K", [1, 6, 32, 42, 192, 198, 384, 390])
def test_cholesky_solve_matches_pallas_interpret(rng, K):
    S, b = _spd(rng, K)
    x = cholesky.cholesky_solve(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    xj = np.asarray(jchol(jnp.asarray(S), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(x, xj, atol=1e-4)
    np.testing.assert_allclose(x, np.linalg.solve(S, b), atol=1e-4)


@pytest.mark.parametrize("K", [6, 42, 198, 390])
def test_cholesky_solve_less_dominant(rng, K):
    """S = A·Aᵀ + 0.01·K·I, where a missing or misplaced update of the
    blocked order would show: relative gaps to the JAX kernel and to a
    float64 solve, and the residual, within REL[0.01]."""
    S, b = _spd(rng, K, 0.01)
    x = cholesky.cholesky_solve(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    xj = np.asarray(jchol(jnp.asarray(S), jnp.asarray(b), interpret=True))
    x64 = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(x, xj, atol=1e-4)
    assert _rel_gap(x, xj) <= REL[0.01]
    assert _rel_gap(x, x64) <= REL[0.01]
    assert _residual(S, b, x) <= REL[0.01]


def test_cholesky_solve_clamped_pivot(rng):
    """A zero row and column: djj = 0 is clamped to 1e-20, the column of L
    is 0 and x there is 0, as in the JAX kernel; the rest is the solve of
    the remaining system."""
    K, z = 42, 35  # z lies in the ragged last panel (columns 32-41)
    S, b = _spd(rng, K)
    S[z, :] = 0.0
    S[:, z] = 0.0
    b[z] = 0.0
    x = cholesky.cholesky_solve(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    xj = np.asarray(jchol(jnp.asarray(S), jnp.asarray(b), interpret=True))
    assert np.isfinite(x).all() and x[z] == 0.0
    np.testing.assert_allclose(x, xj, atol=1e-4)
    keep = np.arange(K) != z
    np.testing.assert_allclose(x[keep], np.linalg.solve(S[keep][:, keep], b[keep]), atol=1e-4)


def test_cholesky_solve_k1024(rng):
    S, b = _spd(rng, 1024)
    x = cholesky.cholesky_solve(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(S.astype(np.float64), b.astype(np.float64)), atol=1e-4)


@pytest.mark.parametrize("K, N", [(6, 1), (42, 7), (198, 33), (390, 100)])
def test_cholesky_solve_many_matches_jax(rng, K, N):
    for shift, rel in REL.items():
        S, _ = _spd(rng, K, shift)
        B = rng.normal(size=(K, N)).astype(np.float32)
        X = cholesky.cholesky_solve(torch.from_numpy(S), torch.from_numpy(B)).numpy()
        Xj = np.asarray(jsl.cho_solve(jsl.cho_factor(jnp.asarray(S), lower=True), jnp.asarray(B)))
        np.testing.assert_allclose(X, Xj, atol=1e-4)
        assert _rel_gap(X, Xj) <= rel, shift
        assert _residual(S, B, X) <= rel, shift


def test_cholesky_solve_rejects_bad_input():
    S = torch.eye(4)
    with pytest.raises(ValueError):
        cholesky.cholesky_solve(S, torch.ones(3))
    with pytest.raises(TypeError):
        cholesky.cholesky_solve(S.double(), torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        cholesky.cholesky_solve(S, torch.ones(3, 2))
    with pytest.raises(ValueError):
        cholesky.cholesky_solve(S, torch.ones(4, 2, 1))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [6, 390, 384, 1024])
def test_kernel_matches_plain_on_card(rng, cuda, K):
    for shift, rel in REL.items():
        S, b = _spd(rng, K, shift)
        St, bt = torch.from_numpy(S).to(cuda), torch.from_numpy(b).to(cuda)
        n0 = cholesky.KERNEL.launches
        x = cholesky.cholesky_solve(St, bt)
        torch.cuda.synchronize()
        assert cholesky.KERNEL.launches == n0 + 1
        ref = cholesky.cholesky_solve_plain(St, bt)
        torch.testing.assert_close(x, ref, rtol=0, atol=1e-4)
        x, ref = x.cpu().numpy(), ref.cpu().numpy()
        assert _rel_gap(x, ref) <= rel, shift
        assert _residual(S, b, x) <= rel, shift


@pytest.mark.cuda
@pytest.mark.parametrize("K, z", [(42, 35), (390, 100)])
def test_kernel_clamped_pivot_on_card(rng, cuda, K, z):
    """A zero row and column: the kernel's clamp (djj = 0 → 1e-20) gives a
    finite x with x[z] = 0, and the plain version's x elsewhere."""
    S, b = _spd(rng, K)
    S[z, :] = 0.0
    S[:, z] = 0.0
    b[z] = 0.0
    St, bt = torch.from_numpy(S).to(cuda), torch.from_numpy(b).to(cuda)
    x = cholesky.cholesky_solve(St, bt).cpu().numpy()
    ref = cholesky.cholesky_solve_plain(St, bt).cpu().numpy()
    assert np.isfinite(x).all() and x[z] == 0.0
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-4)
    assert _rel_gap(x, ref) <= REL[1.0]
    assert _residual(S, b, x) <= REL[1.0]


@pytest.mark.cuda
@pytest.mark.parametrize("K, N", [(6, 1), (390, 1000), (384, 24576), (1024, 33), (3072, 1000), (384, 65),
                                  (33, 24577)])
def test_kernel_many_matches_plain_on_card(rng, cuda, K, N):
    """K1 with many right-hand sides: ragged last blocks (K = 6, 390, 33) and
    column tiles (N = 1, 1000, 33, 65, 24 577; N not a multiple of 4 takes the
    4-byte staging), the covariances' shape (384 × 24 576) and the JAX
    package's largest dense covariance (512 cameras, K = 3072)."""
    for shift, rel in REL.items():
        S, _ = _spd(rng, K, shift)
        B = rng.normal(size=(K, N)).astype(np.float32)
        St, Bt = torch.from_numpy(S).to(cuda), torch.from_numpy(B).to(cuda)
        n0 = cholesky.KERNEL_MANY.launches
        X = cholesky.cholesky_solve(St, Bt)
        torch.cuda.synchronize()
        assert cholesky.KERNEL_MANY.launches == n0 + 1
        ref = cholesky.cholesky_solve_plain(St, Bt)
        torch.testing.assert_close(X, ref, rtol=0, atol=1e-4)
        X, ref = X.cpu().numpy(), ref.cpu().numpy()
        assert _rel_gap(X, ref) <= rel, shift
        assert _residual(S, B, X) <= rel, shift
