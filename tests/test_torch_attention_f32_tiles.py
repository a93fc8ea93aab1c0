"""K4's float32 kernels' schedules (csrc/attention.cu) emulated in torch on
the CPU, against the JAX package's einsum path.

The hd 64 kernel (attention_tile_kernel) takes a CTA's 64 query rows
against 64-key tiles: a tile without a real key skipped unless the batch
element has none, the tile's mask codes (a real key's logit q.k · scale ·
log2 e, a masked key's -1e9 · log2 e, a key past M -inf), one rescale of
the running max, the sum and the accumulator a tile by exp2(m_old -
m_new), the sum kept as 16 partial sums a row (thread tx owns the keys tx
+ 16 j of every tile) and added up once at the end, O += P V with P in
float32, the rows past N dropped. The hd 16 kernel (attention_row_kernel)
rescales every 8 keys, in the natural domain. `f32_emulation` runs either
schedule at either width, and the tests hold it within 2e-5 (the JAX
package's own bound between its attention paths) of LightGlue._attention
with MPSFM_LG_ATTN unset (its einsum path on the CPU) at small MASt3R-like
shapes (every key real, N = M not a multiple of 64), LightGlue-like ones
(keys padded at the end, a cross call) and the cases of
tests/test_torch_attention_card.py (whole tiles masked, one real key, a
batch element without a real key), at hd 16 and 64. Planted faults (a real
tile skipped, the accumulator not rescaled, keys past M weighed as masked
ones) fall outside the bound. tests/test_torch_attention_card.py holds the
kernels on the card.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mpsfm_tpu.extraction.matchers.lightglue import LightGlue as JLightGlue

from test_torch_attention_card import ATOL, CASES, masks

LOG2E = 1.4426950408889634
TILE = 64  # keys of a tile and query rows of a CTA, both kernels
LANES = 16  # threads sharing a query row in the tile kernel

# (B, N, M, H, hd, mask kind): N and M not multiples of 64, so the last query tile is padded and the last key tile
# ragged
SHAPES = {
    "mast3r_like": (2, 150, 150, 4, 64, "all_real"),  # both views batched, every key real
    "mast3r_cross_like": (1, 150, 150, 3, 64, "all_real"),
    "lightglue_like_self": (2, 200, 200, 2, 64, "ragged"),  # padded keypoints at the end
    "lightglue_like_cross": (2, 130, 330, 2, 64, "masked_tiles_between"),
    "lightglue_like_hd16": (2, 200, 200, 4, 16, "ragged"),
    "no_real_key_hd64": (2, 40, 150, 2, 64, "no_real_key"),
    **CASES,
}


def arrays(name, seed=0):
    B, N, M, H, hd, kind = SHAPES[name]
    rng = np.random.default_rng(seed)
    q = (2 * rng.normal(size=(B, N, H, hd))).astype(np.float32)  # logits of a few units, as a net's
    k = rng.normal(size=(B, M, H, hd)).astype(np.float32)
    v = rng.normal(size=(B, M, H, hd)).astype(np.float32)
    return q, k, v, masks(kind, B, M), 1.0 / np.sqrt(hd)


def f32_emulation(q, k, v, mask, scale, schedule, drop_tile=None, acc_not_rescaled=False, past_m_masked=False):
    """softmax(q kᵀ · scale) v by the float32 kernel's schedule on CPU
    tensors: "tile" (hd 64's kernel: one rescale a 64-key tile, log2
    domain, 16 partial sums a row) or "row" (hd 16's: a rescale every 8
    keys, natural domain). Planted faults: drop_tile (that tile skipped
    although it holds real keys), acc_not_rescaled (the running max and the
    sum rescaled, the accumulator not), past_m_masked (keys past M given the
    masked logit, not weight 0)."""
    B, N, H, hd = q.shape
    M = k.shape[1]
    T = -(-M // TILE)
    pad = TILE * T - M
    ln2 = LOG2E if schedule == "tile" else 1.0
    real = torch.cat([mask, torch.zeros(B, pad, dtype=torch.bool)], 1)
    inside = torch.arange(TILE * T) < M
    kp = torch.cat([k, torch.zeros(B, pad, H, hd)], 1)
    vp = torch.cat([v, torch.zeros(B, pad, H, hd)], 1)
    tile_real = real.view(B, T, TILE).any(-1)
    skip = tile_real.any(-1)  # a batch element with no real key takes every tile
    qp = torch.cat([q, torch.zeros(B, -(-N // TILE) * TILE - N, H, hd)], 1)  # padded query rows: zeros
    n_rows = qp.shape[1]
    m = torch.full((B, H, n_rows), -1e30)
    lanes = LANES if schedule == "tile" else 1
    l = torch.zeros(B, H, n_rows, lanes)
    o = torch.zeros(B, H, n_rows, hd)
    chunk = TILE if schedule == "tile" else 8
    masked = torch.tensor(-1e9 * ln2)
    past = masked if past_m_masked else torch.tensor(-math.inf)
    for t in range(T):
        on = (tile_real[:, t] | ~skip) & (t != drop_tile)
        if not bool(on.any()):
            continue
        keys = slice(TILE * t, TILE * t + TILE)
        s = torch.einsum("bnhd,bmhd->bhnm", qp, kp[:, keys]) * (scale * ln2)
        code_real, code_in = real[:, keys][:, None, None], inside[keys]
        s = torch.where(code_real, s, torch.where(code_in, masked, past))
        for c in range(0, TILE, chunk):
            sc = s[..., c:c + chunk]
            mn = torch.maximum(m, sc.amax(-1))
            corr = torch.exp2(m - mn) if schedule == "tile" else torch.exp(m - mn)
            p = torch.exp2(sc - mn[..., None]) if schedule == "tile" else torch.exp(sc - mn[..., None])
            part = p.view(*p.shape[:-1], -1, lanes).sum(-2)  # thread tx sums the keys tx + 16 j
            pv = torch.einsum("bhnk,bkhd->bhnd", p, vp[:, keys][:, c:c + chunk])
            sel = on[:, None, None]
            l = torch.where(sel[..., None], l * corr[..., None] + part, l)
            o = torch.where(sel[..., None], (o if acc_not_rescaled else o * corr[..., None]) + pv, o)
            m = torch.where(sel, mn, m)
    out = o / l.sum(-1, keepdim=True)
    return out.transpose(1, 2)[:, :N].contiguous()


def jax_einsum(q, k, v, m, scale, monkeypatch):
    monkeypatch.delenv("MPSFM_LG_ATTN", raising=False)
    return np.asarray(JLightGlue._attention(*(jnp.asarray(a) for a in (q, k, v)), None, jnp.asarray(m), scale))


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("schedule", ["tile", "row"])
def test_f32_schedule_equals_jax_einsum_path(name, schedule, monkeypatch):
    """Either schedule, at each shape, within 2e-5 of the JAX einsum path;
    every row finite, the padded query rows included before the cut."""
    q, k, v, m, scale = arrays(name)
    got = f32_emulation(*(torch.as_tensor(a) for a in (q, k, v, m)), scale, schedule)
    assert tuple(got.shape) == q.shape and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), jax_einsum(q, k, v, m, scale, monkeypatch), atol=ATOL)


FAULTS = {
    "real_tile_skipped": lambda m: dict(drop_tile=int(np.flatnonzero(m[0])[0]) // TILE),
    "acc_not_rescaled": lambda m: dict(acc_not_rescaled=True),
    "past_m_weighed_as_masked": lambda m: dict(past_m_masked=True),
}
# each fault on a shape where it changes the function: keys past M matter only to a batch element with no real key
FAULT_SHAPES = {"real_tile_skipped": "lightglue_like_cross", "acc_not_rescaled": "mast3r_like",
                "past_m_weighed_as_masked": "no_real_key_hd64"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fall_outside_the_bound(fault, monkeypatch):
    q, k, v, m, scale = arrays(FAULT_SHAPES[fault])
    got = f32_emulation(*(torch.as_tensor(a) for a in (q, k, v, m)), scale, "tile", **FAULTS[fault](m))
    gap = np.abs(got.numpy() - jax_einsum(q, k, v, m, scale, monkeypatch)).max()
    assert not gap <= ATOL, gap  # NaN (a row with no weight left) fails too
