"""The flash-attention kernel's plain version against the reference.

Inputs are made with numpy from a seed and fed to both sides.  fp32
tolerance 1e-5: the reference kernels and the plain version sum the same
terms in a different order (tiled online softmax vs one dense softmax).
The CUDA kernel itself is held to the plain version on the card, by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref, flash_attention
from repro.models.layers import blockwise_attention
from repro_torch.kernels.flash_attention import attention_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, skv, d), dtype=np.float32)
    return q, k, v


def _plain(q, k, v, **kw):
    return attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("hq,hkv", [(2, 2), (6, 2)])          # groups 1, 3
@pytest.mark.parametrize("s", [128, 100])                     # aligned, ragged
@pytest.mark.parametrize("window", [None, 24])
def test_plain_matches_pallas_and_ref(hq, hkv, s, window):
    q, k, v = _qkv(1, hq, hkv, s, s, 16, seed=s + hq)
    ours = _plain(q, k, v, causal=True, window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    pallas = np.asarray(flash_attention(jq, jk, jv, causal=True,
                                        window=window, interpret=True))
    ref = np.asarray(attention_ref(jq, jk, jv, causal=True, window=window))
    np.testing.assert_allclose(ours, pallas, **TOL)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("lo,c,window", [(0, 8, None), (8, 8, None),
                                          (13, 7, None), (16, 8, 6),
                                          (24, 9, 5)])
def test_plain_q_offset_matches_blockwise(lo, c, window):
    """Chunk rows at absolute positions [lo, lo+c) against a full-length
    scratch whose rows past lo+c are still zero — the chunked-prefill
    call, held against the reference's blockwise_attention(q_offset=lo)."""
    s = 33
    q, k, v = _qkv(2, 6, 2, c, s, 16, seed=lo)
    k[:, :, lo + c:] = 0.0
    v[:, :, lo + c:] = 0.0
    ours = _plain(q, k, v, causal=True, window=window, q_offset=lo)
    ref = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, q_chunk=4, kv_chunk=8, q_offset=lo))
    np.testing.assert_allclose(ours, ref, **TOL)


def test_default_offset_is_right_aligned():
    q, k, v = _qkv(1, 4, 2, 5, 12, 16, seed=3)
    np.testing.assert_array_equal(_plain(q, k, v),
                                  _plain(q, k, v, q_offset=7))
    ref = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(_plain(q, k, v), ref, **TOL)


def test_rows_that_see_nothing_are_zero():
    """Non-causal with a window: rows whose window lies wholly past the
    keys see nothing and come out 0, as in the Pallas kernel."""
    q, k, v = _qkv(1, 2, 2, 4, 8, 16, seed=4)
    out = _plain(q, k, v, causal=False, window=2, q_offset=20)
    np.testing.assert_array_equal(out, np.zeros_like(out))


def test_bf16_out_in_q_dtype():
    q, k, v = _qkv(1, 2, 1, 16, 16, 32, seed=5)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = attention_plain(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    ref = attention_plain(tq.float(), tk.float(), tv.float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=3e-2, atol=3e-2)
