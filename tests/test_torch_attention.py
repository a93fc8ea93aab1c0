"""LightGlue's attention on the port (K4's plain version) against the JAX
package's attention paths.

attention_plain and the wrapper on CPU tensors hold the JAX package's
einsum path (LightGlue._attention off the TPU), its query-chunked and its
streaming paths within 2e-5 (tests/test_extraction.py's bound between
them) at test_lightglue_attention_paths_agree's shapes and masks, plus a
cross call with N != M, a key set whose first 64-key tile is all masked,
whole tiles masked between real keys, a key set without a real key, and
padded query rows (finite, as in the einsum path).
tests/test_torch_attention_card.py holds K4 itself on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mpsfm_tpu.extraction.matchers.lightglue import LightGlue as JLightGlue
from mpsfm_tpu_torch.extraction.matchers import attention as tatt

from test_torch_attention_card import ATOL, CASES, case_arrays


@pytest.mark.parametrize("name", list(CASES))
def test_attention_plain_equals_jax_einsum_path(name):
    q, k, v, m, scale = case_arrays(name)
    ref = np.asarray(JLightGlue._attention(*(jnp.asarray(a) for a in (q, k, v)), None, jnp.asarray(m), scale))
    got = tatt.attention(*(torch.as_tensor(a) for a in (q, k, v, m)), scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(), tatt.attention_plain(*(torch.as_tensor(a) for a in (q, k, v, m)),
                                                                    scale).numpy())


@pytest.mark.parametrize("name", ["paths_agree", "cross_n_ne_m"])
@pytest.mark.parametrize("path", ["qchunk", "stream"])
def test_attention_plain_equals_jax_tiled_paths(name, path):
    """The JAX package's TPU tilings compute the same function; they need
    N (qchunk) or M (stream) divisible by their block."""
    q, k, v, m, scale = case_arrays(name)
    args = (*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(m), scale)
    ref = np.asarray(JLightGlue._attention_qchunk(*args, block=32) if path == "qchunk"
                     else JLightGlue._attention_streaming(*args, block=16))
    got = tatt.attention_plain(*(torch.as_tensor(a) for a in (q, k, v, m)), scale)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
