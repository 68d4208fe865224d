"""The flash-attention kernel's plain version against the reference.

Inputs are made with numpy from a seed and fed to both sides.  fp32
tolerance 1e-5: the reference kernels and the plain version sum the same
terms in a different order (tiled online softmax vs one dense softmax).
The CUDA kernel itself is held to the plain version on the card, by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

The bf16 kernel's split-KV plan (``kv_split_plan``) is held here as a pure
function, and its split-and-merge arithmetic (``attention_split_plain``)
against the reference at the same 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.flash_attention import attention_ref, flash_attention
from repro.models.layers import blockwise_attention
from repro_torch.kernels.flash_attention import (
    KvSplitPlan,
    attention_plain,
    attention_split_plain,
    kv_split_plan,
    split_ranges,
)
from repro_torch.kernels.flash_attention import flash_attention as port_flash
from repro_torch.kernels.flash_attention.ops import BLOCK_KV, BLOCK_Q

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


@pytest.mark.parametrize("hq,hkv", [(2, 2), (6, 2)])          # groups 1, 3
def test_plain_matches_pallas_at_head_dim_112(hq, hkv):
    """zamba2-7b's head dim, which the CUDA kernel takes as seven k16
    steps: the plain version against the reference's Pallas kernel."""
    q, k, v = _qkv(1, hq, hkv, 128, 128, 112, seed=112 + hq)
    ours = _plain(q, k, v, causal=True)
    pallas = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True,
                                        interpret=True))
    np.testing.assert_allclose(ours, pallas, **TOL)


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


@pytest.mark.parametrize("sq,skv,lo,scale", [
    (40, 40, None, None),           # bulk, the default DK ** -0.5 scale
    (40, 40, None, 96 ** -0.5),     # bulk, MLA's scale passed explicitly
    (17, 150, 70, 0.125),           # a ragged chunk at an offset
    (64, 256, 128, None),           # a chunk the kernel would split
])
def test_unequal_head_dims_match_blockwise(sq, skv, lo, scale):
    """MLA's q/k head dim 96 and v head dim 64 (40 heads, no GQA): both
    plain versions against the reference's blockwise_attention (the route
    the reference takes for unequal dims); a chunk's scratch rows past
    its end are still zero.  The output takes v's head dim."""
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((1, 40, sq, 96), dtype=np.float32)
    k = rng.standard_normal((1, 40, skv, 96), dtype=np.float32)
    v = rng.standard_normal((1, 40, skv, 64), dtype=np.float32)
    if lo is not None:
        k[:, :, lo + sq:] = 0.0
        v[:, :, lo + sq:] = 0.0
    kw = dict(causal=True, scale=scale, q_offset=lo)
    ours = _plain(q, k, v, **kw)
    assert ours.shape == (1, 40, sq, 64)
    ref = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=16,
        kv_chunk=32, **kw))
    np.testing.assert_allclose(ours, ref, **TOL)
    off = skv - sq if lo is None else lo
    for plan in (kv_split_plan(sq, skv, off, True, None, 40),
                 KvSplitPlan(-(-skv // BLOCK_KV), 1)):
        split = attention_split_plain(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            plan, **kw).numpy()
        np.testing.assert_allclose(split, ref, **TOL)
    np.testing.assert_allclose(
        port_flash(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), **kw).numpy(), ours, rtol=0, atol=0)


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


@pytest.mark.parametrize("sq", [20, 37])
def test_unmasked_call_takes_any_q_offset(sq):
    """No causal mask and no window (the whisper encoder, and a decoder's
    cross-attention over 16 encoder rows): more q rows than k/v rows, so
    the default offset Skv − Sq is negative, and the call matches the
    reference's blockwise attention.  Under a causal mask or a window a
    negative offset raises, on the CPU as on the card."""
    q, k, v = _qkv(1, 6, 2, sq, 16, 16, seed=8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        q_chunk=4, kv_chunk=8))
    np.testing.assert_allclose(port_flash(tq, tk, tv, causal=False).numpy(),
                               ref, **TOL)
    np.testing.assert_array_equal(
        port_flash(tq, tk, tv, causal=False, q_offset=-3).numpy(),
        port_flash(tq, tk, tv, causal=False, q_offset=5).numpy())
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        with pytest.raises(ValueError, match="q_offset"):
            port_flash(tq, tk, tv, **kw)


def test_bf16_out_in_q_dtype():
    q, k, v = _qkv(1, 2, 1, 16, 16, 32, seed=5)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = attention_plain(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    ref = attention_plain(tq.float(), tk.float(), tv.float())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=3e-2, atol=3e-2)


def _visible(i0, i1, skv, q_offset, causal, window):
    """Columns visible to some row of [i0, i1), by brute force."""
    rows = q_offset + np.arange(i0, i1)[:, None]
    cols = np.arange(skv)[None, :]
    mask = np.ones((i1 - i0, skv), bool)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return np.flatnonzero(mask.any(0))


@settings(max_examples=150, deadline=None)
@given(sq=st.integers(1, 300), extra=st.integers(0, 700),
       q_offset=st.integers(0, 900), causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(0, 400)),
       hq=st.sampled_from([1, 3, 15, 32]))
def test_kv_split_plan_covers_visible_tiles(sq, extra, q_offset, causal,
                                            window, hq):
    """Each q tile's splits cover every kv tile holding a column visible to
    the tile's rows exactly once, and no tile wholly masked; the plan does
    not change with Skv beyond the visible range."""
    skv = q_offset + sq + extra
    plan = kv_split_plan(sq, skv, q_offset, causal, window, hq)
    assert plan.splits >= 1 and plan.tiles_per_split >= 1
    for qt in range(-(-sq // BLOCK_Q)):
        i0, i1 = qt * BLOCK_Q, min((qt + 1) * BLOCK_Q, sq)
        want = sorted(set(_visible(i0, i1, skv, q_offset, causal, window)
                          // BLOCK_KV))
        got = [t for lo, hi in split_ranges(plan, qt, sq, skv, q_offset,
                                            causal, window)
               for t in range(lo, hi)]
        assert got == want          # each visible tile once, in order
    if causal:                      # the visible range ends at the last row
        for longer in (skv + 1, skv + 517):
            assert kv_split_plan(sq, longer, q_offset, causal, window,
                                 hq) == plan


def test_kv_split_plan_fills_a_wave():
    """A prefill chunk (2 q tiles x 15 heads) splits to about a wave of
    SMs; a bulk prefill (32 q tiles x 15 heads) does not split."""
    assert kv_split_plan(2048, 2048, 0, True, None, 15).splits == 1
    chunk = kv_split_plan(128, 2048, 1024, True, None, 15)
    assert chunk == KvSplitPlan(5, 4)
    assert 30 * chunk.splits >= 132
    assert kv_split_plan(128, 2048, 0, True, None, 15).splits == 1


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,q_offset,window", [
    (1, 2, 2, 128, 128, 16, None, None),    # group 1, bulk
    (1, 6, 2, 100, 100, 64, None, None),    # group 3, ragged bulk
    (1, 6, 2, 128, 512, 64, 256, None),     # a chunk mid-sequence
    (1, 6, 2, 128, 512, 64, 0, None),       # the first chunk
    (1, 3, 1, 100, 512, 16, 300, None),     # a ragged chunk
    (1, 8, 2, 128, 512, 80, 256, 64),       # D 80, windowed chunk
    (2, 6, 2, 64, 320, 80, 200, None),      # batch 2, ragged Skv
    (1, 6, 2, 128, 128, 64, None, 0),       # window 0: no row sees a column
    (1, 6, 2, 128, 512, 64, 256, 0),        # window 0, a chunk
])
@pytest.mark.parametrize("forced", [False, True])
def test_split_plain_matches_ref(b, hq, hkv, sq, skv, d, q_offset, window,
                                 forced):
    """The split-and-merge arithmetic at the plan the wrapper would pick
    (or one kv tile a split) against the reference's dense oracle: the
    chunk's rows placed at q_offset in a full-length q."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, seed=sq + d)
    off = skv - sq if q_offset is None else q_offset
    plan = kv_split_plan(sq, skv, off, True, window, hq)
    if forced:
        longest = max(hi - lo for qt in range(-(-sq // BLOCK_Q))
                      for lo, hi in split_ranges(KvSplitPlan(1, 1), qt, sq,
                                                 skv, off, True, window))
        plan = KvSplitPlan(max(longest, 1), 1)   # window 0: none visible
    ours = attention_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), plan,
        causal=True, window=window, q_offset=q_offset).numpy()
    np.testing.assert_allclose(
        ours, _plain(q, k, v, causal=True, window=window, q_offset=q_offset),
        **TOL)
    q_full = np.random.default_rng(1).standard_normal(
        (b, hq, skv, d), dtype=np.float32)
    q_full[:, :, off:off + sq] = q
    ref = np.asarray(attention_ref(jnp.asarray(q_full), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   window=window))[:, :, off:off + sq]
    np.testing.assert_allclose(ours, ref, **TOL)


def test_window_zero_sees_nothing_like_ref():
    """Only ``None`` means no window: at ``window=0`` (causal, Sq == Skv,
    q offset 0) every row sees no column, and both plain versions output
    zeros as the reference does."""
    q, k, v = _qkv(1, 6, 2, 100, 100, 16, seed=7)
    ref = np.asarray(attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=0))
    assert not ref.any()
    kw = dict(causal=True, window=0, q_offset=0)
    plan = kv_split_plan(100, 100, 0, True, 0, 6)
    assert plan == KvSplitPlan(1, 1)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for ours in (attention_plain(tq, tk, tv, **kw).numpy(),
                 attention_split_plain(tq, tk, tv, plan, **kw).numpy()):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
