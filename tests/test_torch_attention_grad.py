"""K4's gradient and its head-width-48 route (extraction/matchers/
attention.py): `_AttentionF32`, the float32 route as an autograd Function
(the kernel's forward, the einsum + softmax path's gradient in torch ops),
and heads of 48 on the float32 kernel's attention_row_kernel<48>.

This file imports no JAX, so its card cases run on the card's host. On the
CPU: the Function's gradients against attention_plain's own autograd at hd
16, 48 and 64 with padded keys, a batch element without a real key and a
cross call (N != M), within 1e-5 of each gradient's largest magnitude
(float32's summation order); a call without a gradient returns no graph;
the bfloat16 route refuses a gradient. On the card: the forward (the
kernel, launched once) and the gradients against the CPU's on the same
inputs, and the hd 48 route against attention_plain within chip_smoke's
K4_TOL, at the trained prior's shape.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu_torch.extraction.matchers import attention as tatt

GRAD_REL = 1e-5
CASES = {  # (B, N, M, H, hd, real keys of each batch element; None = all)
    "hd16_padded": (2, 40, 70, 2, 16, (70, 53)),
    "hd48_trained_prior": (8, 81, 81, 2, 48, None),  # train_mono's default net on a 160 x 128 frame
    "hd48_no_real_key": (2, 33, 90, 2, 48, (90, 0)),
    "hd64_cross": (1, 50, 130, 4, 64, (101,)),
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def case(name, device="cpu", seed=0):
    B, N, M, H, hd, real = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device=device)
                  for s in ((B, N, H, hd), (B, M, H, hd), (B, M, H, hd), (B, N, H, hd)))
    real = real or (M,) * B
    mask = torch.as_tensor(np.arange(M)[None] < np.asarray(real)[:, None], device=device)
    return q, k, v, mask, hd ** -0.5, g


def grads(fn, q, k, v, mask, scale, g):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*leaves, mask, scale)
    out.backward(g)
    return out.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("name", list(CASES))
def test_function_gradients_equal_plain_autograd(name):
    q, k, v, mask, scale, g = case(name)
    out, got = grads(tatt.attention, q, k, v, mask, scale, g)
    ref_out, want = grads(tatt.attention_plain, q, k, v, mask, scale, g)
    assert out.grad_fn is None and torch.equal(out, ref_out)
    for a, b, what in zip(got, want, "qkv"):
        assert (a - b).abs().max() <= GRAD_REL * b.abs().max(), what
    B, N, M, H, hd, real = CASES[name]
    if real and 0 in real:  # a batch element without a real key: its weights are uniform and where() passes nothing
        i = real.index(0)
        assert got[0][i].abs().max() == 0 and got[1][i].abs().max() == 0


def test_attention_builds_the_function_only_for_a_gradient():
    q, k, v, mask, scale, _ = case("hd48_trained_prior")
    qg = q.clone().requires_grad_(True)
    assert type(tatt.attention(qg, k, v, mask, scale).grad_fn).__name__ == "_AttentionF32Backward"
    assert tatt.attention(q, k, v, mask, scale).grad_fn is None
    with torch.no_grad():
        assert tatt.attention(qg, k, v, mask, scale).grad_fn is None
    with pytest.raises(ValueError, match="inference-only"):
        tatt.attention(qg.bfloat16(), k.bfloat16(), v.bfloat16(), mask, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_card_forward_and_gradients_equal_the_cpu(name):
    """The kernel's forward (one launch) within 2e-5 of the CPU's, the torch-ops backward on the card within
    GRAD_REL · 10 of the CPU's (the card's GEMMs sum in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = case(name)
    dev = [t.cuda() if torch.is_tensor(t) else t for t in cpu]
    n = tatt.KERNEL.launches
    out, got = grads(tatt.attention, *dev)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches == n + 1
    ref_out, want = grads(tatt.attention, *cpu)
    assert (out.cpu() - ref_out).abs().max() <= 2e-5
    for a, b, what in zip(got, want, "qkv"):
        assert (a.cpu() - b).abs().max() <= 10 * GRAD_REL * b.abs().max(), what


@pytest.mark.cuda
def test_hd48_route_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, mask, scale, _ = (t.cuda() if torch.is_tensor(t) else t for t in case("hd48_trained_prior"))
    got = tatt.attention(q, k, v, mask, scale)
    assert got.shape == q.shape
    assert (got - tatt.attention_plain(q, k, v, mask, scale)).abs().max() <= 2e-5

