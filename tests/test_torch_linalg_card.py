"""The port's batched eigh (geometry/linalg.py) where the library refuses a
float32 batch: cuSOLVER's batched Jacobi does not converge on the nearly
repeated eigenvalues of FᵀF for an essential-like F (two equal singular
values), so that batch is solved again in float64.

This file imports no JAX, so its card case runs on the card's host: the two
3×3 matrices (their float32 bits) that an H100 run refused inside a batch
of RANSAC hypotheses, against the CPU's LAPACK. On the CPU: the retry path
with the library's refusal simulated.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu_torch.geometry import linalg as tla

# FᵀF of two 8-point hypotheses of chip_smoke's neural pipeline run (float32 bits, row-major)
REFUSED = [
    [833531160, 949125467, -1191220452, 949125467, 1081617933, 904673391, -1191220452, 904673391, 1081617976],
    [869431373, 965779759, -1172203660, 965779759, 1083500660, -1214809501, -1172203660, -1214809501, 1083500860],
]


def refused():
    return torch.tensor(REFUSED, dtype=torch.int32).view(torch.float32).reshape(-1, 3, 3)


def batch_with_refused(n=512, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    S = torch.tensor(A @ A.transpose(0, 2, 1))
    S[173], S[301] = refused()
    return S


def test_refused_matrices_have_nearly_repeated_eigenvalues():
    w, _ = torch.linalg.eigh(refused().double())
    assert ((w[:, 2] - w[:, 1]) / w[:, 2] < 3e-5).all() and (w[:, 0].abs() < 1e-12).all()


def test_a_refused_float32_batch_is_solved_in_float64(monkeypatch):
    S = batch_with_refused()
    orig = torch.linalg.eigh
    calls = []

    def library(x):
        calls.append(x.dtype)
        if x.dtype == torch.float32:
            raise torch.linalg.LinAlgError("linalg.eigh: (Batch element 173): The algorithm failed to converge")
        return orig(x)

    monkeypatch.setattr(torch.linalg, "eigh", library)
    w, v = tla.eigh(S)
    assert calls == [torch.float32, torch.float64] and w.dtype == v.dtype == torch.float32
    w64, v64 = orig(S.double())
    np.testing.assert_array_equal(w.numpy(), w64.float().numpy())
    np.testing.assert_array_equal(v.numpy(), v64.float().numpy())


def test_a_refused_float64_batch_is_not_retried(monkeypatch):
    def refuse(x):
        raise torch.linalg.LinAlgError("refused")

    monkeypatch.setattr(torch.linalg, "eigh", refuse)
    with pytest.raises(torch.linalg.LinAlgError):
        tla.eigh(batch_with_refused().double())


@pytest.mark.cuda
def test_eigh_of_the_refused_batch_on_the_card():
    """The batch the card refused in float32 goes through, its eigenvalues
    within 1e-5 of the largest of the CPU's and its smallest eigenvector's
    direction within 1e-3 (the two near-equal eigenvectors are not
    determined at float32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    S = batch_with_refused()
    w, v = tla.eigh(S.cuda())
    wc, vc = torch.linalg.eigh(S)
    w, v = w.cpu(), v.cpu()
    assert torch.isfinite(w).all() and torch.isfinite(v).all()
    assert ((w - wc).abs() <= 1e-5 * wc.abs().amax(-1, keepdim=True)).all()
    dots = (v[..., 0] * vc[..., 0]).sum(-1).abs()
    assert (dots >= 1 - 1e-3).all()
