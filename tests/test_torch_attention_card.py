"""K4, LightGlue's attention kernel (csrc/attention.cu), and its wrapper.

This file imports no JAX, so its card-only cases run on the card's host:
K4 against attention_plain at the cases of tests/test_torch_attention.py
(test_lightglue_attention_paths_agree's shapes and masks, a cross call with
N != M, a first 64-key tile all masked, one real key, whole tiles masked
between real keys, a batch element without a real key) in float32 (2e-5)
and bfloat16 (one bfloat16 ulp of the float32 result on the rounded
inputs, plus 2e-5 where that result is near zero). On the CPU: the
wrapper's bfloat16 semantics and what it refuses.
"""

import numpy as np
import pytest
import torch

from mpsfm_tpu_torch.extraction.matchers import attention as tatt

ATOL = 2e-5  # tests/test_extraction.py::test_lightglue_attention_paths_agree


def masks(kind, B, M):
    m = np.ones((B, M), bool)
    if kind == "ragged":  # test_lightglue_attention_paths_agree's: the second set 17 keys short
        m[1, M - 17:] = False
    elif kind == "first_tile_masked":  # every key of the first 64-key tile padded
        m[:, :70] = False
    elif kind == "one_key":
        m[0, 1:] = False
    elif kind == "masked_tiles_between":  # two whole 64-key tiles padded between real keys, a ragged end
        m[:, 64:192] = False
        m[1, M - 20:] = False
    elif kind == "no_real_key":  # the second set all padding: uniform weights over its keys
        m[1] = False
    return m


CASES = {
    # (B, N, M, H, hd, mask): test_lightglue_attention_paths_agree's shapes, a cross call, the official head width
    "paths_agree": (2, 96, 80, 2, 16, "ragged"),
    "cross_n_ne_m": (2, 130, 200, 4, 16, "ragged"),
    "first_tile_masked": (1, 70, 160, 4, 64, "first_tile_masked"),
    "one_real_key": (1, 33, 128, 2, 16, "one_key"),
    "masked_tiles_between": (2, 50, 300, 4, 64, "masked_tiles_between"),
    "no_real_key": (2, 40, 150, 2, 16, "no_real_key"),
}


def case_arrays(name, seed=0):
    B, N, M, H, hd, kind = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, N, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, M, H, hd)).astype(np.float32)
    v = rng.normal(size=(B, M, H, hd)).astype(np.float32)
    return q, k, v, masks(kind, B, M), 1.0 / np.sqrt(hd)


def test_attention_bfloat16_is_the_float32_function_rounded():
    """bfloat16 inputs: the float32 result on the rounded inputs, rounded
    to bfloat16 (within one bfloat16 ulp of it)."""
    q, k, v, m, scale = case_arrays("cross_n_ne_m")
    tq, tk, tv = (torch.as_tensor(a).bfloat16() for a in (q, k, v))
    got = tatt.attention(tq, tk, tv, torch.as_tensor(m), scale)
    ref = tatt.attention_plain(tq.float(), tk.float(), tv.float(), torch.as_tensor(m), scale)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.bfloat16())
    assert (got.float() - ref).abs().le(bf16_ulp(ref)).all()


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significand bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def test_attention_refuses_what_the_kernel_does_not_take():
    q, k, v, m, scale = case_arrays("paths_agree")
    tq, tk, tv, tm = (torch.as_tensor(a) for a in (q, k, v, m))
    with pytest.raises(ValueError, match="do not match"):
        tatt.attention(tq, tk[:, :-1], tv, tm, scale)
    with pytest.raises(TypeError):
        tatt.attention(tq.double(), tk.double(), tv.double(), tm, scale)
    with pytest.raises(TypeError):
        tatt.attention(tq, tk, tv, tm.float(), scale)
    with pytest.raises(ValueError, match="no keys"):
        tatt.attention(tq, tk[:, :0], tv[:, :0], tm[:, :0], scale)
    full = torch.ones(1, 8192, dtype=torch.bool)
    assert tatt.attention_flops(8192, 4, 64, full) == 4 * 4 * 8192 * 8192 * 64
    assert tatt.KERNEL.launches == 0  # CPU tensors never reach the kernel


def test_attention_flops_count_the_real_keys():
    """The bound's FLOP: a batch element's real keys only (a masked key's
    weight is 0), all M keys for one with none (its weights are uniform)."""
    m = torch.zeros(3, 8192, dtype=torch.bool)
    m[0, :4942] = True
    m[1, 100:200] = True
    assert tatt.attention_flops(8192, 4, 64, m) == 4 * 4 * 8192 * 64 * (4942 + 100 + 8192)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_equals_plain_on_the_card(name, dtype):
    """K4 against attention_plain on the same inputs: float32 within 2e-5,
    bfloat16 within one bfloat16 ulp of the float32 result on the rounded
    inputs; padded query rows finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, m, scale = case_arrays(name)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.as_tensor(a, device="cuda").to(dt) for a in (q, k, v))
    tm = torch.as_tensor(m, device="cuda")
    n = tatt.KERNEL.launches
    got = tatt.attention(tq, tk, tv, tm, scale)
    torch.cuda.synchronize()
    assert tatt.KERNEL.launches == n + 1 and got.dtype == dt and torch.isfinite(got.float()).all()
    ref = tatt.attention_plain(tq.float(), tk.float(), tv.float(), tm, scale)
    if dtype == "float32":
        assert (got - ref).abs().max().item() <= ATOL
    else:  # ATOL too where the result is near zero and float32 order alone moves it past one ulp
        assert (got.float() - ref).abs().le(bf16_ulp(ref) + ATOL).all()
