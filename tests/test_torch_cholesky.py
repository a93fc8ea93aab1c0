"""K1, the reduced-camera Cholesky solve: the port against the JAX package.

On the CPU the port's cholesky_solve runs its plain version (the kernel's
right-looking algorithm in torch); the JAX package's Pallas kernel runs in
interpret mode. Tolerance atol 1e-4, the bar of
tests/test_ba.py::test_pallas_cholesky_solve_interpret. Gaps measured on
the CPU (max |Δx|, |x| ~ 0.1): vs interpret mode 7.5e-9 / 3.7e-9 / 3.3e-9
and vs a float64 solve 1.3e-8 / 9.8e-9 / 6.7e-9 at K = 32 / 192 / 384;
vs a float64 solve 3.1e-9 at K = 1024.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpsfm_tpu.ba.pallas_cholesky import cholesky_solve as jchol
from mpsfm_tpu_torch.ba import cholesky


def _spd(rng, K):
    A = rng.normal(size=(K, K)).astype(np.float32)
    S = A @ A.T + K * np.eye(K, dtype=np.float32)
    return S, rng.normal(size=(K,)).astype(np.float32)


@pytest.mark.parametrize("K", [32, 192, 384])
def test_cholesky_solve_matches_pallas_interpret(rng, K):
    S, b = _spd(rng, K)
    x = cholesky.cholesky_solve(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    xj = np.asarray(jchol(jnp.asarray(S), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(x, xj, atol=1e-4)
    np.testing.assert_allclose(x, np.linalg.solve(S, b), atol=1e-4)


def test_cholesky_solve_k1024(rng):
    S, b = _spd(rng, 1024)
    x = cholesky.cholesky_solve(torch.from_numpy(S), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(S.astype(np.float64), b.astype(np.float64)), atol=1e-4)


def test_cholesky_solve_rejects_bad_input():
    S = torch.eye(4)
    with pytest.raises(ValueError):
        cholesky.cholesky_solve(S, torch.ones(3))
    with pytest.raises(TypeError):
        cholesky.cholesky_solve(S.double(), torch.ones(4, dtype=torch.float64))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [384, 1024])
def test_kernel_matches_plain_on_card(rng, cuda, K):
    S, b = _spd(rng, K)
    St, bt = torch.from_numpy(S).to(cuda), torch.from_numpy(b).to(cuda)
    n0 = cholesky.KERNEL.launches
    x = cholesky.cholesky_solve(St, bt)
    torch.cuda.synchronize()
    assert cholesky.KERNEL.launches == n0 + 1
    ref = cholesky.cholesky_solve_plain(St, bt)
    torch.testing.assert_close(x, ref, rtol=0, atol=1e-4)
