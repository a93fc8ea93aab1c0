"""K4, LightGlue's attention kernels (csrc/attention.cu for float32,
csrc/attention_tc.cu, the tensor-core route, for bfloat16), and their
wrapper.

This file imports no JAX, so its card-only cases run on the card's host:
each kernel against attention_plain at the cases of
tests/test_torch_attention.py (test_lightglue_attention_paths_agree's
shapes and masks, a cross call with N != M, a first 64-key tile all masked,
one real key, whole tiles masked between real keys, a batch element
without a real key; M not a multiple of 64, N not a multiple of the query
tile, so padded queries) in float32 (2e-5) and bfloat16 (chip_smoke's
k4_bf16_bound: 2u · plain(q, k, |v|) + one bfloat16 ulp + 2e-5, the spread
of rounding P to bfloat16, which tests/test_torch_attention_bf16.py holds
the JAX package's own bfloat16 path to), the output rows past N left
untouched, and unaligned operands. On the CPU: the wrapper's bfloat16
semantics and what it refuses.
"""

import numpy as np
import pytest
import torch

import chip_smoke
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
    assert tatt.KERNEL.launches == 0 and tatt.KERNEL_TC.launches == 0  # CPU tensors never reach a kernel


def test_attention_flops_count_the_real_keys():
    """The bound's FLOP: a batch element's real keys only (a masked key's
    weight is 0), all M keys for one with none (its weights are uniform)."""
    m = torch.zeros(3, 8192, dtype=torch.bool)
    m[0, :4942] = True
    m[1, 100:200] = True
    assert tatt.attention_flops(8192, 4, 64, m) == 4 * 4 * 8192 * 64 * (4942 + 100 + 8192)


def card_case(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, m, scale = case_arrays(name)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.as_tensor(a, device="cuda").to(dt) for a in (q, k, v))
    return tq, tk, tv, torch.as_tensor(m, device="cuda"), scale


def assert_k4_close(got, tq, tk, tv, tm, scale):
    """float32 within 2e-5 of attention_plain; bfloat16 within k4_bf16_bound."""
    if tq.dtype == torch.float32:
        ref = tatt.attention_plain(tq, tk, tv, tm, scale)
        assert (got - ref).abs().max().item() <= ATOL
    else:
        ref, bound = chip_smoke.k4_bf16_bound(tq, tk, tv, tm, scale)
        d = (got.float() - ref).abs()
        assert d.le(bound).all(), (d.max().item(), (d / bound).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_equals_plain_on_the_card(name, dtype):
    """Each dtype's kernel, launched once, against attention_plain on the
    same inputs (float32 within 2e-5, bfloat16 within k4_bf16_bound); the
    result in q's dtype, finite, padded query rows included."""
    tq, tk, tv, tm, scale = card_case(name, dtype)
    kernel = tatt.KERNEL_TC if dtype == "bfloat16" else tatt.KERNEL
    n, n_other = kernel.launches, (tatt.KERNEL if dtype == "bfloat16" else tatt.KERNEL_TC).launches
    got = tatt.attention(tq, tk, tv, tm, scale)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1 and got.dtype == tq.dtype and torch.isfinite(got.float()).all()
    assert (tatt.KERNEL if dtype == "bfloat16" else tatt.KERNEL_TC).launches == n_other
    assert_k4_close(got, tq, tk, tv, tm, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cross_n_ne_m", "masked_tiles_between"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_leaves_rows_past_n_untouched(name, dtype):
    """The kernel writes the B·N·H rows of its output and nothing after
    them: its output is the head of a longer buffer of NaNs (N is not a
    multiple of the query tile, so the last tile's padded rows would land
    there), called through the C entry point."""
    tq, tk, tv, tm, scale = card_case(name, dtype)
    B, N, H, hd = tq.shape
    buf = torch.full((tq.numel() + 128 * H * hd,), float("nan"), dtype=tq.dtype, device="cuda")
    kernel, fn = (tatt.KERNEL_TC, "attention_bf16") if dtype == "bfloat16" else (tatt.KERNEL, "attention_f32")
    kernel.call(fn, tq.data_ptr(), tk.data_ptr(), tv.data_ptr(), tm.data_ptr(), buf.data_ptr(), B, N,
                tk.shape[1], H, hd, float(scale), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.isnan(buf[tq.numel():].float()).all()
    got = buf[:tq.numel()].view(tq.shape)
    assert torch.isfinite(got.float()).all()
    assert_k4_close(got, tq, tk, tv, tm, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_takes_strided_and_unaligned_operands(dtype):
    """q from a transposed view (not contiguous) and k, v as views at an
    element offset (not 16-byte aligned for TMA): the wrapper copies them,
    and the result is the kernel's on the copies."""
    tq, tk, tv, tm, scale = card_case("cross_n_ne_m", dtype)
    qt = tq.transpose(1, 2).contiguous().transpose(1, 2)
    kb, vb = (torch.cat([t.reshape(-1)[:1], t.reshape(-1)]) for t in (tk, tv))
    ko, vo = kb[1:].view(tk.shape), vb[1:].view(tv.shape)
    assert not qt.is_contiguous() and ko.data_ptr() % 16 != 0
    got = tatt.attention(qt, ko, vo, tm, scale)
    assert torch.equal(got, tatt.attention(tq, tk, tv, tm, scale))
    assert_k4_close(got, tq, tk, tv, tm, scale)


def test_k4_probe_edits_the_kernel_source():
    """k4_probe.py's variants are the tensor-core kernel's source with its
    CTA shape's three #defines replaced, each once; without a card the
    probe exits 1."""
    import k4_probe

    src = tatt.KERNEL_TC.source.read_text()
    out = k4_probe.variant_source(src, (1, 3, 4))
    for name, value in zip(k4_probe.NAMES, (1, 3, 4)):
        assert f"\n#define {name} {value} " in out
    assert len(out.splitlines()) == len(src.splitlines())
    with pytest.raises(RuntimeError, match="no #define TC_WG"):
        k4_probe.variant_source(src.replace("#define TC_WG", "#define TC_WGX"), (1, 3, 4))
    if not torch.cuda.is_available():
        assert k4_probe.main() == 1
