"""K4's bfloat16 rule (chip_smoke.k4_bf16_bound) on the CPU.

The tensor-core kernel (csrc/attention_tc.cu) rounds P to bfloat16 for
P·V. Its rule against attention_plain on the same bfloat16 inputs is, per
element, |K4 - plain| <= 2u · attention_plain(q, k, |v|) + one bfloat16
ulp of plain + K4_TOL, u = 2^-8. Here, at the cases of
tests/test_torch_attention_card.py:

- the JAX package's own bfloat16 path, LightGlue._attention_qchunk (P
  rounded to bfloat16, lightglue.py:312), lies within it: the bound is the
  reference's own spread, not a loosening;
- a torch emulation of the kernel's arithmetic (64-key tiles skipped when
  they hold no real key, running max in the log2 domain, float32 sum, P
  rounded to bfloat16 per tile, the result rounded once) lies within it;
- the same emulation with a planted fault falls outside it: a real-key tile
  skipped, the heads' rows swapped, P rounded to 4 significand bits.
tests/test_torch_attention_card.py holds the kernel itself on the card.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
import jax.numpy as jnp
from mpsfm_tpu.extraction.matchers.lightglue import LightGlue as JLightGlue

from test_torch_attention_card import CASES, case_arrays

LOG2E = 1.4426950408889634


def bf16_case(name):
    """A case's inputs rounded to bfloat16, as torch tensors on the CPU."""
    q, k, v, m, scale = case_arrays(name)
    return (*(torch.as_tensor(a).bfloat16() for a in (q, k, v)), torch.as_tensor(m), scale)


def bound_ratio(got, q, k, v, mask, scale):
    """max |got - plain| / k4_bf16_bound: at most 1 when the rule holds."""
    ref, bound = chip_smoke.k4_bf16_bound(q, k, v, mask, scale)
    assert bound.shape == ref.shape == tuple(q.shape) and bool((bound > 0).all())
    return float(((got.float() - ref).abs() / bound).max())


def round_significand(x, bits):
    """x rounded to `bits` significand bits (8: bfloat16's rounding)."""
    if bits == 8:
        return x.bfloat16().float()
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2 ** bits) / 2 ** bits, e)


def k4_emulation(q, k, v, mask, scale, p_bits=8, drop_tile=None, swap_heads=False):
    """The tensor-core kernel's arithmetic in torch: logits in the log2
    domain (a masked key -1e9·log2 e, a key past M -inf), 64-key tiles, a
    tile without a real key skipped unless the batch element has none, the
    running max and the float32 sum rescaled by exp2(m_old - m_new), P
    rounded to `p_bits` significand bits for P·V, the result rounded to
    bfloat16. Planted faults: drop_tile (that tile skipped although it holds
    real keys), swap_heads (the heads' rows written in reverse order)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    B, N, H, hd = q.shape
    M = k.shape[1]
    T = -(-M // 64)
    pad = 64 * T - M
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * (scale * LOG2E)
    s = torch.where(mask[:, None, None, :], s, torch.tensor(-1e9 * LOG2E))
    s = torch.cat([s, torch.full((B, H, N, pad), -math.inf)], -1)
    vp = torch.cat([vf, torch.zeros(B, pad, H, hd)], 1)
    real = torch.cat([mask, torch.zeros(B, pad, dtype=torch.bool)], 1).view(B, T, 64).any(-1)
    skip = real.any(-1)
    m = torch.full((B, H, N), -math.inf)
    l = torch.zeros(B, H, N)
    o = torch.zeros(B, H, N, hd)
    for t in range(T):
        on = real[:, t] | ~skip
        if t == drop_tile:
            on = on & ~real[:, t]
        on = on[:, None, None]
        st = s[..., 64 * t:64 * t + 64]
        n = torch.maximum(m, st.amax(-1))
        corr = torch.exp2(m - n)
        p = torch.exp2(st - n[..., None])
        pv = torch.einsum("bhnk,bkhd->bhnd", round_significand(p, p_bits), vp[:, 64 * t:64 * t + 64])
        l = torch.where(on, l * corr + p.sum(-1), l)
        o = torch.where(on[..., None], o * corr[..., None] + pv, o)
        m = torch.where(on, n, m)
    out = (o / l[..., None]).transpose(1, 2)
    return (out.flip(2) if swap_heads else out).bfloat16()


@pytest.mark.parametrize("name", list(CASES))
def test_jax_bfloat16_path_lies_within_the_bound(name):
    """The JAX package's bfloat16 query-chunked path against the port's
    plain version on the same rounded inputs."""
    q, k, v, m, scale = bf16_case(name)
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    out = JLightGlue._attention_qchunk(jq, jk, jv, jnp.asarray(m.numpy()), scale, block=32)
    assert out.dtype == jnp.bfloat16
    got = torch.as_tensor(np.array(out.astype(jnp.float32))).bfloat16()
    assert bound_ratio(got, q, k, v, m, scale) <= 1


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_emulation_lies_within_the_bound(name):
    q, k, v, m, scale = bf16_case(name)
    got = k4_emulation(q, k, v, m, scale)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    assert bound_ratio(got, q, k, v, m, scale) <= 1


def first_real_tile(mask):
    """The 64-key tile holding batch element 0's first real key."""
    return int(np.flatnonzero(mask[0].numpy())[0]) // 64


FAULTS = {
    "real_key_tile_skipped": lambda m: dict(drop_tile=first_real_tile(m)),
    "heads_swapped": lambda m: dict(swap_heads=True),
    "p_rounded_to_4_bits": lambda m: dict(p_bits=4),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fall_outside_the_bound(fault, name):
    """Each fault breaks the rule on every case where it changes the
    function: with one real key all weight is on it, P = 1 exactly, so
    rounding P to 4 bits changes nothing there (and the rule holds)."""
    q, k, v, m, scale = bf16_case(name)
    ratio = bound_ratio(k4_emulation(q, k, v, m, scale, **FAULTS[fault](m)), q, k, v, m, scale)
    if fault == "p_rounded_to_4_bits" and name == "one_real_key":
        assert ratio <= 1
    else:
        assert not ratio <= 1, ratio  # NaN (an element with no tile left) fails too
