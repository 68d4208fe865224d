"""The CUDA kernels on the card, held to their plain versions.

Marked ``gpu``: each test skips where there is no CUDA device (decided
inside the fixture, never at import).  On the card run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Flash-attention tolerances are those of the reference's kernel tests: fp32
2e-4 with TF32 off (set here), bf16 3e-2.  The bf16 chunks of a long cache
(split over kv) are held tighter, to 1e-2 of the largest plain output (one
bf16 rounding step of that output is at most 2^-7 of it), against the
plain version and against the split-and-merge plain version.  SSD
tolerances are relative to the largest output: y 1e-4 in fp32 and 2e-2 in
bf16 (y is written in bf16), the fp32 state 1e-4 in both.  The SSD
backward's (``SSD_BWD_TOL``) are relative to each gradient's largest
magnitude, against the plain backward on the inputs upcast to fp32; its
bf16 kernels are also held to their rounding plan, ``ssd_bwd_bf16_emulated``
on the same kept states (``SSD_BWD_EMU_TOL``).  DLA matmul
tolerances are relative to the largest output: fp32 in and out 1e-5, bf16
in and fp32 out 1e-4, a bf16 output 1e-2.  The PGAS tests hold
peer-mapped heaps (PUT/GET as stores into the peers' partitions) to the
card's gloo wire and to CPU ranks bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    FLASH,
    attention_plain,
    flash_attention,
)
from repro_torch.kernels.ssd import (
    SSD,
    SSD_BWD,
    ssd,
    ssd_bwd,
    ssd_bwd_bf16_emulated,
    ssd_bwd_plain,
    ssd_plain,
)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
BF16_SPLIT_REL = 1e-2       # max |error| over max |plain|, split bf16 chunks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape_q, shape_kv, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda s: torch.randn(s, generator=g, device=device).to(dtype)
    return mk(shape_q), mk(shape_kv), mk(shape_kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (77, 77, None, None),        # ragged bulk
    (128, 128, None, 40),        # aligned, windowed
    (24, 300, 200, None),        # a mid-sequence chunk
    (40, 300, 150, 33),          # a windowed chunk
    (128, 128, None, 0),         # window 0: no row sees a column (zeros)
])
def test_kernel_matches_plain(cuda, dtype, d, sq, skv, q_offset, window):
    q, k, v = _qkv((2, 6, sq, d), (2, 2, skv, d), dtype, cuda, seed=d + sq)
    before = FLASH.launches
    got = flash_attention(q, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    want = attention_plain(q, k, v, window=window, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


def _split_rel_err(got, q, k, v, **kw):
    """max |got − want| / max |want| against the plain version and against
    the split-and-merge plain version at the kernel's plan (bf16)."""
    from repro_torch.kernels.flash_attention import (
        attention_split_plain,
        kv_split_plan,
    )

    from repro_torch.kernels.flash_attention.ops import resolve_q_offset

    sq, skv = q.shape[2], k.shape[2]
    causal = kw.get("causal", True)
    off = resolve_q_offset(sq, skv, kw.get("q_offset"), causal,
                           kw.get("window"))
    plan = kv_split_plan(sq, skv, off, causal, kw.get("window"), q.shape[1])
    kw = dict(kw, q_offset=off)
    errs = []
    for want in (attention_plain(q, k, v, **kw),
                 attention_split_plain(q, k, v, plan, **kw)):
        want = want.float()
        errs.append(((got.float() - want).abs().max()
                     / want.abs().max()).item())
    return errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 112, 128])
@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (128, 1024, 512, None),      # a chunk the bf16 kernel splits over kv
    (100, 1024, 0, None),        # a ragged first chunk
    (128, 1024, 768, 200),       # a windowed chunk, split
])
def test_split_chunks_match_plain(cuda, dtype, d, sq, skv, q_offset,
                                  window):
    """Chunks of a long cache: fp32 at 2e-4; bf16 (split over kv) to the
    plain and the split-and-merge plain versions at BF16_SPLIT_REL."""
    q, k, v = _qkv((2, 6, sq, d), (2, 2, skv, d), dtype, cuda, seed=d + sq)
    kw = dict(window=window, q_offset=q_offset)
    before = FLASH.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        want = attention_plain(q, k, v, **kw)
        err = (got - want).abs().max().item()
        assert err <= TOL[dtype], err
    else:
        errs = _split_rel_err(got, q, k, v, **kw)
        assert max(errs) <= BF16_SPLIT_REL, errs


def test_strided_inputs_and_empty_rows(cuda):
    """q as a transposed projection view; rows that see no key output 0."""
    x = torch.randn(1, 50, 4, 64, device=cuda)
    q = x.transpose(1, 2)                       # (1, 4, 50, 64), strided
    k = torch.randn(1, 2, 50, 64, device=cuda)
    v = torch.randn(1, 2, 50, 64, device=cuda)
    got = flash_attention(q, k, v)
    torch.testing.assert_close(got, attention_plain(q, k, v),
                               rtol=2e-4, atol=2e-4)
    empty = flash_attention(q, k, v, causal=False, window=4, q_offset=100)
    assert torch.count_nonzero(empty).item() == 0


@pytest.mark.parametrize("d", [64, 80, 112])
@pytest.mark.parametrize("lo", [0, 128, 384])
def test_bf16_model_views_match_split_plain(cuda, d, lo):
    """bf16 as the model calls it: q a transposed projection, k/v layer
    slices of a (L, B, Hkv, S, D) scratch; held to the plain version and
    to the split-and-merge plain version at the kernel's plan, at
    BF16_SPLIT_REL."""
    g = torch.Generator(device=cuda).manual_seed(d + lo)
    proj = torch.randn(2, 128, 6 * d, generator=g, device=cuda).bfloat16()
    q = proj.view(2, 128, 6, d).transpose(1, 2)          # (2, 6, 128, d)
    scratch = torch.randn(3, 2, 2, 512, d, generator=g,
                          device=cuda).bfloat16()
    k, v = scratch[1], scratch[2]
    got = flash_attention(q, k, v, q_offset=lo)
    torch.cuda.synchronize()
    errs = _split_rel_err(got, q, k, v, q_offset=lo)
    assert max(errs) <= BF16_SPLIT_REL, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,skv,d,causal,q_offset", [
    (6, 6, 1500, 1500, 64, False, None),   # whisper's encoder
    (6, 6, 1, 1500, 64, False, None),      # cross-attention, one row
    (6, 6, 37, 1500, 64, False, None),     # a ragged decoder chunk
    (6, 6, 448, 1500, 64, False, None),    # the whole decoder prompt
    (6, 6, 1600, 1500, 64, False, None),   # more q rows than k/v rows
    (16, 8, 384, 384, 128, True, None),    # internvl2 bulk
    (16, 8, 128, 640, 128, True, 256),     # internvl2 chunk
])
def test_frontend_shapes_match_plain(cuda, dtype, hq, hkv, sq, skv, d,
                                     causal, q_offset):
    """The whisper and internvl2 shapes: non-causal over 1500 rows (the
    ragged tile 1500 = 23 × 64 + 28 hidden only by the column bound), the
    cross shapes whose few q rows the bf16 kernel splits over kv, and
    causal D 128 at 16/8 heads.  fp32 at 2e-4; bf16 to the plain and the
    split-and-merge plain versions at BF16_SPLIT_REL."""
    q, k, v = _qkv((1, hq, sq, d), (1, hkv, skv, d), dtype, cuda,
                   seed=sq + skv + d)
    kw = dict(causal=causal, q_offset=q_offset)
    before = FLASH.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        err = (got - attention_plain(q, k, v, **kw)).abs().max().item()
        assert err <= TOL[dtype], err
    else:
        errs = _split_rel_err(got, q, k, v, **kw)
        assert max(errs) <= BF16_SPLIT_REL, errs


def test_wrapper_rejects(cuda):
    q = torch.randn(1, 2, 8, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q[..., :48], q[..., :48], q[..., :48])  # head dim
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        t = q.transpose(2, 3)                     # head dim not contiguous
        flash_attention(t, t, t)
    # bf16 takes 16-byte copies: a base or a stride off 16 bytes raises,
    # it never falls back to another kernel or to the plain version
    before = FLASH.launches
    buf = torch.randn(2 * 8 * 64 + 1, device=cuda).bfloat16()
    off = buf[1:].view(1, 2, 8, 64)               # base 2 bytes off
    with pytest.raises(ValueError):
        flash_attention(off, off, off)
    wide = torch.randn(1, 2, 8, 68, device=cuda).bfloat16()[..., :64]
    with pytest.raises(ValueError):               # row stride 136 bytes
        flash_attention(wide, wide, wide)
    long_q = torch.randn(1, 2, 12, 64, device=cuda)
    with pytest.raises(ValueError, match="q_offset"):  # causal, Sq > Skv
        flash_attention(long_q, q, q)
    assert FLASH.launches == before


def test_reduced_model_on_card_matches_cpu(cuda):
    """The reduced models in fp32: prefill through the kernel on the card
    against the plain version on the CPU, same parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import prefill

    for name in ("smollm-360m", "h2o-danube-1.8b"):
        cfg = get_config(name).reduced()
        params = init_params(cfg, seed=0, device="cpu")
        on_card = params_to(params, cuda)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, size=(2, 37))).long()
        c_cpu, l_cpu = prefill(cfg, params, toks, cache_len=64)
        before = FLASH.launches
        c_gpu, l_gpu = prefill(cfg, on_card, toks.to(cuda), cache_len=64)
        assert FLASH.launches == before + cfg.n_layers
        torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(c_gpu["k"].cpu(), c_cpu["k"],
                                   rtol=1e-4, atol=1e-4)


def _ssd_inputs(bsz, s, h, g, n, p, dtype, device, seed, init, pad=8):
    """x, B and C as strided views of one conv-output-like buffer, as the
    model passes them (``pad`` more columns: with 8 every row starts on 16
    bytes); dt, a and d drawn as the model makes them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    width = h * p + 2 * g * n + pad
    buf = torch.randn(bsz, s, width, generator=gen, device=device).to(dtype)
    x = buf[..., :h * p].reshape(bsz, s, h, p)
    b = buf[..., h * p:h * p + g * n].reshape(bsz, s, g, n)
    c = buf[..., h * p + g * n:h * p + 2 * g * n].reshape(bsz, s, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, s, h, generator=gen, device=device))
    a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device=device)))
    d = torch.ones(h, device=device)
    state = (torch.randn(bsz, h, n, p, generator=gen, device=device)
             if init else None)
    return (x, dt, a, b, c, d), state


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,init", [
    (1, 300, 8, 1, 128, 64, 128, True),   # mamba2 widths, ragged, a state
    (2, 256, 4, 1, 128, 64, 128, False),  # two full chunks
    (2, 77, 4, 2, 16, 16, 8, True),       # reduced widths, two groups
    (1, 200, 6, 3, 64, 32, 32, False),    # strip-sized chunks, 3 groups
    (2, 17, 2, 1, 8, 16, 4, False),       # the reference's smallest case
])
def test_ssd_kernel_matches_plain(cuda, dtype, bsz, s, h, g, n, p, chunk,
                                  init):
    args, state = _ssd_inputs(bsz, s, h, g, n, p, dtype, cuda,
                              seed=s + n, init=init)
    before = SSD.launches
    y, st = ssd(*args, chunk=chunk, init_state=state)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    y_want, st_want = ssd_plain(*args, chunk=chunk, init_state=state)
    assert y.dtype == dtype and y.shape == y_want.shape
    assert st.dtype == torch.float32 and st.shape == st_want.shape
    assert _rel(y, y_want) <= (1e-4 if dtype == torch.float32 else 2e-2)
    assert _rel(st, st_want) <= 1e-4


def test_ssd_wrapper_rejects(cuda):
    args, _ = _ssd_inputs(1, 16, 2, 1, 16, 16, torch.float32, cuda, 0, False)
    x, dt, a, b, c, d = args
    with pytest.raises(TypeError):
        ssd(x.half(), dt, a, b.half(), c.half(), d, chunk=8)
    with pytest.raises(TypeError):
        ssd(x, dt.double(), a, b, c, d, chunk=8)
    with pytest.raises(ValueError):
        ssd(x.transpose(2, 3), dt, a, b, c, d, chunk=8)   # last dim strided
    with pytest.raises(ValueError):
        ssd(x, dt, a, b[..., :12], c[..., :12], d, chunk=8)   # n % 8
    big, _ = _ssd_inputs(1, 16, 2, 1, 128, 64, torch.float32, cuda, 0,
                         False)
    with pytest.raises(ValueError, match="chunk"):
        ssd(*big, chunk=256)              # more than two 64-row tiles
    big, _ = _ssd_inputs(1, 16, 2, 1, 256, 64, torch.float32, cuda, 0,
                         False)
    with pytest.raises(ValueError, match="shared memory"):
        ssd(*big, chunk=128)              # fp32 C and B tiles: 266 KB
    with pytest.raises(ValueError):                       # state shape
        ssd(x, dt, a, b, c, d, chunk=8,
            init_state=torch.zeros(1, 2, 16, 8, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,s,h,g,n,p,init,plan,pad", [
    (1, 2048, 80, 1, 128, 64, True, None, 8),  # 16 chunks: the state chain
    (1, 2100, 8, 1, 128, 64, True, None, 8),   # 17 chunks, the last ragged
    (1, 128, 80, 1, 128, 64, True, None, 8),   # the serving chunk, a state
    (1, 256, 7, 1, 128, 64, False, (4, 32), 8),  # 7 heads: tiles of 4, 3
    (2, 300, 10, 2, 128, 64, True, (3, 32), 8),  # 2 groups of 5: 3, 2
    (1, 200, 4, 1, 64, 64, True, None, 2),     # rows off 16 bytes
])
def test_ssd_kernel_chunks_tiles_and_fills(cuda, monkeypatch, dtype, bsz, s,
                                           h, g, n, p, init, plan, pad):
    """The chunk-parallel kernel at chunk 128 against the plain version:
    many chunks through the ordered state pass, the one-launch serving
    chunk, head tiles that do not divide the heads, several heads a group,
    and views whose rows start off 16 bytes (the element fill instead of
    TMA or cp.async).  ``plan`` forces the heads and P columns of a
    block."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    if plan is not None:
        monkeypatch.setattr(ssd_ops, "ssd_plan", lambda *a, **k: plan)
    args, state = _ssd_inputs(bsz, s, h, g, n, p, dtype, cuda, seed=s + h,
                              init=init, pad=pad)
    x, _, _, b, c, _ = args
    assert ssd_ops._aligned16(x, b, c) == (pad * x.element_size() % 16 == 0)
    before = SSD.launches
    y, st = ssd(*args, chunk=128, init_state=state)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    y_want, st_want = ssd_plain(*args, chunk=128, init_state=state)
    assert _rel(y, y_want) <= (1e-4 if dtype == torch.float32 else 2e-2)
    assert _rel(st, st_want) <= 1e-4


def test_reduced_mamba2_on_card_matches_cpu(cuda):
    """Reduced mamba2 in fp32: bulk prefill through the SSD kernel on the
    card against its plain version on the CPU, same parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import prefill

    cfg = get_config("mamba2-2.7b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 37))).long()
    c_cpu, l_cpu = prefill(cfg, params, toks)
    before = SSD.launches
    c_gpu, l_gpu = prefill(cfg, params_to(params, cuda), toks.to(cuda))
    assert SSD.launches == before + cfg.n_layers
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c_gpu["ssm_state"].cpu(), c_cpu["ssm_state"],
                               rtol=1e-4, atol=1e-4)



def test_reduced_zamba2_on_card_matches_cpu(cuda):
    """Reduced zamba2-7b in fp32: bulk prefill through the SSD kernel (a
    launch a Mamba-2 layer) and the flash kernel (one a shared
    application) on the card against their plain versions on the CPU,
    same parameters, at mamba2's tolerance: logits, final SSD states and
    every application's K/V."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, n_applications, \
        params_to
    from repro_torch.models.prefill import prefill

    cfg = get_config("zamba2-7b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 37))).long()
    c_cpu, l_cpu = prefill(cfg, params, toks)
    before = (FLASH.launches, SSD.launches)
    c_gpu, l_gpu = prefill(cfg, params_to(params, cuda), toks.to(cuda))
    assert (FLASH.launches, SSD.launches) == (
        before[0] + n_applications(cfg), before[1] + cfg.n_layers)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    for k in ("ssm_state", "attn_k", "attn_v"):
        torch.testing.assert_close(c_gpu[k].cpu(), c_cpu[k], rtol=1e-4,
                                   atol=1e-4)

GRADS = ("dx", "ddt", "da", "db", "dc", "dd", "dinit")
#: the SSD backward against the plain backward on fp32-upcast inputs, max
#: |error| over max |plain| by gradient.  fp32: full fp32 on the CUDA cores
#: in another order, 1e-4; ddt and da 5e-4, sums of both signs through the
#: reverse cumsum of dcum (the fp32 plain version alone is up to 6e-5 from
#: fp64 at S 2048).  bf16: 1e-2 -- dx, dB and dC are written in bf16 (half
#: an ulp is 2^-8 of a value) and the entering states the forward keeps
#: are bf16 (~2^-9 of the terms that read them).
SSD_BWD_TOL = {torch.float32: dict.fromkeys(GRADS, 1e-4)
               | {"ddt": 5e-4, "da": 5e-4},
               torch.bfloat16: dict.fromkeys(GRADS, 1e-2)}
#: the bf16 backward against ``ssd_bwd_bf16_emulated`` (the kernels'
#: roundings in plain PyTorch) on the same inputs and kept states, d
#: init_state with or without one: dx, dB and dC 2^-8 (written in bf16:
#: fp32 sums in another order may round to the neighbouring bf16), dd and d
#: init_state 1e-4, each between the sound build's reading and that of a
#: build whose split fp32 operands lose their low parts (``probe_bwd``'s
#: ``no_lo``); ddt and da 5e-4, as the fp32 backward's (sum-order noise
#: through the reverse cumsum, as large at S 2048 as the low parts' share)
SSD_BWD_EMU_TOL = dict.fromkeys(("dx", "db", "dc"), 2.0 ** -8) | \
    dict.fromkeys(("dd", "dinit"), 1e-4) | dict.fromkeys(("ddt", "da"), 5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,init", [
    (1, 300, 8, 1, 128, 64, 128, True),   # mamba2 widths, ragged, a state
    (2, 256, 4, 1, 128, 64, 128, False),  # two full chunks, from zeros
    (2, 77, 4, 2, 16, 16, 8, True),       # reduced widths, two groups
    (1, 200, 6, 3, 64, 32, 32, False),    # three groups of two heads
    (1, 128, 4, 1, 64, 128, 128, True),   # one chunk, P 128
])
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, bsz, s, h, g, n, p,
                                      chunk, init):
    """The backward kernels (dlocal, the reverse pass, the chunks, the
    reduction over heads) against ``ssd_bwd_plain``, reading the entering
    states the forward kept; a second call gives the same bits."""
    from repro_torch.kernels.ssd.ops import _forward

    args, state = _ssd_inputs(bsz, s, h, g, n, p, dtype, cuda,
                              seed=s + n + 1, init=init)
    gen = torch.Generator(device=cuda).manual_seed(s)
    dy = torch.randn(bsz, s, h, p, generator=gen, device=cuda).to(dtype)
    dstate = (torch.randn(bsz, h, n, p, generator=gen, device=cuda)
              if init else None)
    _, _, s_in = _forward(*args, chunk, state)
    before = SSD_BWD.launches
    kw = dict(chunk=chunk, init_state=state, s_in=s_in)
    got = ssd_bwd(*args, dy, dstate, **kw)
    again = ssd_bwd(*args, dy, dstate, **kw)
    torch.cuda.synchronize()
    assert SSD_BWD.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    up = [t.float() for t in args]
    want = ssd_bwd_plain(*up, dy.float(), dstate, chunk=chunk,
                         init_state=state)
    for name, u, w in zip(GRADS, got, want):
        assert u.shape == w.shape, name
        assert u.dtype == (dtype if name in ("dx", "db", "dc")
                           else torch.float32), name
        if name == "dinit" and not init:
            continue
        assert _rel(u, w) <= SSD_BWD_TOL[dtype][name], (name, _rel(u, w))


def _bwd_case(cuda, dtype, bsz, s, h, g, n, p, chunk, init, pad, seed):
    """Inputs, cotangents and the forward's kept states of a backward
    case."""
    from repro_torch.kernels.ssd.ops import _forward

    args, state = _ssd_inputs(bsz, s, h, g, n, p, dtype, cuda, seed=seed,
                              init=init, pad=pad)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(bsz, s, h, p, generator=gen, device=cuda).to(dtype)
    dstate = (torch.randn(bsz, h, n, p, generator=gen, device=cuda)
              if init else None)
    _, _, s_in = _forward(*args, chunk, state)
    return args, state, dy, dstate, s_in


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,init,ht,pad", [
    (1, 300, 6, 1, 128, 64, 128, True, 4, 8),    # tiles of 4 and 2
    (1, 256, 80, 1, 128, 64, 128, False, 3, 8),  # 80 heads in tiles of 3
    (2, 200, 10, 2, 64, 32, 64, True, 2, 8),     # chunk 64, groups of 5
    (1, 200, 6, 3, 64, 64, 64, False, 2, 2),     # rows off 16 bytes
    (1, 150, 4, 1, 32, 128, 128, True, 3, 2),    # P 128, off 16 bytes
    (1, 300, 4, 1, 128, 128, 128, True, 2, 8),   # N and P 128: s over g_lo
])
def test_ssd_bwd_head_tiles_chunks_and_fills(cuda, monkeypatch, dtype, bsz,
                                             s, h, g, n, p, chunk, init, ht,
                                             pad):
    """The backward against ``ssd_bwd_plain`` where the bf16 kernels take
    other routes: head tiles that do not divide a group's heads (``ht``
    forces the plan; fp32 takes one head a block whatever it says), chunk
    64, x/B/C as slices of one buffer whose rows start off 16 bytes (the
    element fill instead of TMA or cp.async), P 128, and N and P 128 (the
    entering state loaded over g_k's low part); two calls bitwise equal."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    monkeypatch.setattr(ssd_ops, "ssd_bwd_plan", lambda *a, **k: ht)
    args, state, dy, dstate, s_in = _bwd_case(cuda, dtype, bsz, s, h, g, n,
                                              p, chunk, init, pad, s + h)
    x, _, _, b, c, _ = args
    assert ssd_ops._aligned16(x, b, c) == (pad * x.element_size() % 16 == 0)
    kw = dict(chunk=chunk, init_state=state, s_in=s_in)
    before = SSD_BWD.launches
    got = ssd_bwd(*args, dy, dstate, **kw)
    again = ssd_bwd(*args, dy, dstate, **kw)
    torch.cuda.synchronize()
    assert SSD_BWD.launches == before + 2
    assert ssd_ops.BWD_LAUNCHED["heads_a_block"] == (
        min(ht, h // g) if dtype == torch.bfloat16 else 1)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = ssd_bwd_plain(*[t.float() for t in args], dy.float(), dstate,
                         chunk=chunk, init_state=state)
    for name, u, w in zip(GRADS, got, want):
        if name == "dinit" and not init:
            continue
        assert _rel(u, w) <= SSD_BWD_TOL[dtype][name], (name, _rel(u, w))


@pytest.mark.parametrize("bsz,s,h,g,n,p,chunk,init,pad", [
    (1, 300, 6, 1, 128, 64, 128, True, 8),    # ragged, a state, TMA
    (1, 512, 80, 1, 128, 64, 128, False, 8),  # mamba2 heads, the plan's tile
    (2, 200, 10, 2, 64, 32, 64, True, 8),     # chunk 64, two groups
    (1, 200, 6, 3, 64, 64, 64, False, 2),     # rows off 16 bytes
    (1, 300, 4, 1, 128, 128, 128, True, 8),   # N and P 128
])
def test_ssd_bwd_bf16_matches_emulation(cuda, bsz, s, h, g, n, p, chunk,
                                        init, pad):
    """The bf16 kernels hold their precision plan: against
    ``ssd_bwd_bf16_emulated`` with the head tile the call launched and the
    same kept entering states, within ``SSD_BWD_EMU_TOL``, which dropping
    the low parts of the split fp32 operands exceeds (dx, dB, dC and d
    init_state)."""
    from repro_torch.kernels.ssd import ops as ssd_ops

    args, state, dy, dstate, s_in = _bwd_case(
        cuda, torch.bfloat16, bsz, s, h, g, n, p, chunk, init, pad, 3 * s + h)
    kw = dict(chunk=chunk, init_state=state, s_in=s_in)
    got = ssd_bwd(*args, dy, dstate, **kw)
    want = ssd_bwd_bf16_emulated(
        *args, dy, dstate, ht=ssd_ops.BWD_LAUNCHED["heads_a_block"], **kw)
    for name, u, w in zip(GRADS, got, want):
        assert _rel(u, w) <= SSD_BWD_EMU_TOL[name], (name, _rel(u, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_cuda_kernels_a_call(cuda, dtype):
    """One backward call is exactly ``ops.SSD_BWD_KERNELS`` CUDA kernels on
    the card (the profiler's device events), and one wrapper launch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssd import ops as ssd_ops

    args, state, dy, dstate, s_in = _bwd_case(cuda, dtype, 1, 300, 8, 1,
                                              128, 64, 128, True, 8, 7)
    kw = dict(chunk=128, init_state=state, s_in=s_in)
    ssd_bwd(*args, dy, dstate, **kw)
    torch.cuda.synchronize()
    before = SSD_BWD.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ssd_bwd(*args, dy, dstate, **kw)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert SSD_BWD.launches == before + 1
    assert len(events) == ssd_ops.SSD_BWD_KERNELS, [e.name for e in events]
    assert all("ssd_bwd_" in e.name for e in events)


def test_ssd_bwd_takes_cotangents_off_16_bytes(cuda):
    """dy and dstate as contiguous views that start 4 bytes into their
    storage give the bits of aligned copies (the wrapper copies them: the
    kernels read them as vectors)."""
    from repro_torch.kernels.ssd.ops import _forward

    args, state = _ssd_inputs(1, 200, 4, 1, 64, 64, torch.float32, cuda,
                              seed=5, init=True)
    gen = torch.Generator(device=cuda).manual_seed(6)
    flat = torch.randn(1 + 200 * 4 * 64, generator=gen, device=cuda)
    dy = flat[1:].view(1, 200, 4, 64)
    dst = torch.randn(1 + 4 * 64 * 64, generator=gen, device=cuda)[1:].view(
        1, 4, 64, 64)
    assert dy.data_ptr() % 16 and dst.data_ptr() % 16
    _, _, s_in = _forward(*args, 128, state)
    kw = dict(chunk=128, init_state=state, s_in=s_in)
    got = ssd_bwd(*args, dy, dst, **kw)
    want = ssd_bwd(*args, dy.clone(), dst.clone(), **kw)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_ssd_autograd_on_card_matches_cpu(cuda):
    """The scan's autograd Function on the card (forward kernel, then the
    backward kernels) against the same Function on the CPU (the plain
    versions), fp32, with a state; one forward and one backward launch."""
    args, state = _ssd_inputs(2, 150, 4, 2, 32, 16, torch.float32, cuda,
                              seed=3, init=True)
    gen = torch.Generator(device=cuda).manual_seed(4)
    dy = torch.randn(2, 150, 4, 16, generator=gen, device=cuda)
    dst = torch.randn(2, 4, 32, 16, generator=gen, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        ins = [t.detach().to(dev).requires_grad_(True)
               for t in (*args, state)]
        launches = (SSD.launches, SSD_BWD.launches)
        y, st = ssd(*ins[:6], chunk=32, init_state=ins[6])
        torch.autograd.backward([y, st], [dy.to(dev), dst.to(dev)])
        if dev.type == "cuda":
            assert (SSD.launches, SSD_BWD.launches) == (launches[0] + 1,
                                                        launches[1] + 1)
        grads.append([t.grad.cpu() for t in ins])
    for name, u, w in zip(GRADS, *grads):
        assert _rel(u, w) <= SSD_BWD_TOL[torch.float32][name], name


def test_reduced_mamba2_tp1_step_on_card_matches_cpu(cuda):
    """Two tp-1 steps of reduced mamba2-2.7b in fp32 (microbatches 2) on the
    card against the CPU from the same parameters and batches: loss and
    grad norm 1e-4 relative, parameters 1e-4; the SSD forward and backward
    kernels launched once per layer and microbatch, flash never."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.group import Group
    from repro_torch.dist.steps import (
        StepConfig,
        build_init,
        build_train_step,
        init_opt,
    )
    from repro_torch.models.model import params_to

    cfg = get_config("mamba2-2.7b").reduced()
    scfg = StepConfig(microbatches=2, seq_chunk=8, warmup_steps=1)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=41,
                                  global_batch=4))
    cpu = Group(rank=0, size=1, device=torch.device("cpu"))
    card = Group(rank=0, size=1, device=cuda)
    p_cpu, o_cpu = build_init(cfg, cpu, scfg)(0)
    p_gpu = params_to(p_cpu, cuda)
    o_gpu = init_opt(p_gpu, scfg)
    launches = (FLASH.launches, SSD.launches, SSD_BWD.launches)
    for k in range(2):
        batch = data.global_batch(k)
        p_cpu, o_cpu, m_cpu = build_train_step(cfg, cpu, scfg)(
            p_cpu, o_cpu, batch, k)
        p_gpu, o_gpu, m_gpu = build_train_step(cfg, card, scfg)(
            p_gpu, o_gpu, batch, k)
        for key in ("loss", "grad_norm"):
            assert abs(m_gpu[key] - m_cpu[key]) <= 1e-4 * abs(m_cpu[key])
    per_run = 2 * 2 * cfg.n_layers                # steps x microbatches
    assert (FLASH.launches, SSD.launches, SSD_BWD.launches) == (
        launches[0], launches[1] + per_run, launches[2] + per_run)
    for (_, a), (_, b) in zip(sharding.leaves(p_gpu),
                              sharding.leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)



def test_reduced_zamba2_tp1_step_on_card_matches_cpu(cuda):
    """Two tp-1 steps of reduced zamba2-7b in fp32 (microbatches 2) on the
    card against the CPU, as mamba2's: loss and grad norm 1e-4 relative,
    parameters 1e-4; the SSD forward and backward kernels launched once
    per Mamba-2 layer and microbatch, flash never (the shared attention
    trains through blockwise attention)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.group import Group
    from repro_torch.dist.steps import (
        StepConfig,
        build_init,
        build_train_step,
        init_opt,
    )
    from repro_torch.models.model import params_to

    cfg = get_config("zamba2-7b").reduced()
    scfg = StepConfig(microbatches=2, seq_chunk=8, warmup_steps=1)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=41,
                                  global_batch=4))
    cpu = Group(rank=0, size=1, device=torch.device("cpu"))
    card = Group(rank=0, size=1, device=cuda)
    p_cpu, o_cpu = build_init(cfg, cpu, scfg)(0)
    p_gpu = params_to(p_cpu, cuda)
    o_gpu = init_opt(p_gpu, scfg)
    launches = (FLASH.launches, SSD.launches, SSD_BWD.launches)
    for k in range(2):
        batch = data.global_batch(k)
        p_cpu, o_cpu, m_cpu = build_train_step(cfg, cpu, scfg)(
            p_cpu, o_cpu, batch, k)
        p_gpu, o_gpu, m_gpu = build_train_step(cfg, card, scfg)(
            p_gpu, o_gpu, batch, k)
        for key in ("loss", "grad_norm"):
            assert abs(m_gpu[key] - m_cpu[key]) <= 1e-4 * abs(m_cpu[key])
    per_run = 2 * 2 * cfg.n_layers                # steps x microbatches
    assert (FLASH.launches, SSD.launches, SSD_BWD.launches) == (
        launches[0], launches[1] + per_run, launches[2] + per_run)
    for (_, a), (_, b) in zip(sharding.leaves(p_gpu),
                              sharding.leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)

# ---------------------------------------------------------------------------
# the fused collective matmul's hop kernels (csrc/cc_matmul.cu)
# ---------------------------------------------------------------------------

#: relative to the largest output: fp32 FMAs in another order, and bf16
#: products (exact in fp32) summed by the tensor cores in fp32
HOP_TOL = {(torch.float32, torch.float32): 1e-5,
           (torch.float32, torch.bfloat16): 1e-5,
           (torch.bfloat16, torch.bfloat16): 1e-4}


def _hop_case(entry, bsz, m, n, k, dx, dw, device, seed):
    """Operands as the ring hands them over: x a row block of a taller
    buffer, the scratch a (2, B, M, ·) double buffer read at slot 1, w a
    column slice of a wider weight."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    w = randn(k, n + 5, dtype=dw)[:, 2:2 + n]
    if entry == "matmul_tile":
        x = randn(bsz, 3 * m, k, dtype=dx)[:, m:2 * m]
        return (x, w), {}
    if entry == "consume_matmul":
        return (randn(2, bsz, m, k, dtype=dx), w), {"slot": 1}
    x = randn(bsz, 3 * m, k, dtype=dx)[:, 2 * m:]
    return (randn(2, bsz, m, n), x, w), {"slot": 1}


@pytest.mark.parametrize("entry", ["matmul_tile", "consume_matmul",
                                   "consume_matmul_acc"])
@pytest.mark.parametrize("dx,dw", list(HOP_TOL))
@pytest.mark.parametrize("bsz,m,n,k", [
    (1, 64, 64, 64),          # one tile
    (2, 77, 45, 130),         # ragged M, N and K, a batch of 2
    (2, 256, 640, 2560),      # the h2o-danube TP-4 q edge
    (2, 256, 3456, 2560),     # the up|gate edge (128 x 128 bf16 tiles)
    (1, 1, 3, 1),             # smaller than a tile every way
])
def test_hop_kernel_matches_plain(cuda, entry, dx, dw, bsz, m, n, k):
    from repro_torch.kernels.cc_matmul import ops as cc_ops
    from repro_torch.kernels.cc_matmul import ref as cc_ref

    args, kw = _hop_case(entry, bsz, m, n, k, dx, dw, cuda, seed=m + n + k)
    wrapper = getattr(cc_ops, entry)
    plain = getattr(cc_ref, entry + "_plain")
    kernel = cc_ops.HOP_KERNELS[entry]
    before, plain_before = kernel.launches, dict(cc_ops.PLAIN_CALLS)
    got = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert cc_ops.PLAIN_CALLS == plain_before
    want = plain(*args, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert _rel(got, want) <= HOP_TOL[(dx, dw)]


@pytest.mark.parametrize("dx,dw", [(torch.float32, torch.float32),
                                   (torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("m,k,n", [(256, 2560, 1728), (512, 640, 1024)])
def test_fp32_loop_same_sums_in_every_tile(cuda, dx, dw, m, k, n):
    """The fp32 loop sums each output in an order set by K alone.  The
    down edge backward (2 x 256 x 2560 @ 2560 x 1728: 32 x 64 tiles of 8
    k-groups, 16-byte copies) against a 128-column slice of the same w
    (32 x 32 tiles), aligned and not (L2-only scalar loads); at K 640
    (2 x 512 x 640 @ 640 x 1024: 64 x 64 tiles of 4 groups) against 32 x
    64 tiles likewise.  Equal bit for bit."""
    from repro_torch.kernels.cc_matmul import matmul_tile

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2, m, k, generator=g, device=cuda).to(dx)
    w = torch.randn(k, n, generator=g, device=cuda).to(dw)
    full = matmul_tile(x, w)
    for lo in (0, 2):            # w's rows 16-byte aligned, then not
        part = matmul_tile(x, w[:, lo:lo + 128])
        torch.cuda.synchronize()
        assert torch.equal(part, full[..., lo:lo + 128]), lo


@pytest.mark.parametrize("m,k,n", [(256, 2560, 640), (77, 130, 45),
                                   (512, 640, 1280)])
def test_dla_and_hops_share_the_loop(cuda, m, k, n):
    """The DLA matmul without bias or activation, fp32 out, is bitwise the
    hop kernels' product: fp32 against ``matmul_tile``, bf16 operands
    against ``consume_matmul``."""
    from repro_torch.kernels.cc_matmul import consume_matmul, matmul_tile
    from repro_torch.kernels.matmul import matmul

    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda)
    w = torch.randn(k, n, generator=g, device=cuda)
    assert torch.equal(matmul(x, w), matmul_tile(x, w))
    xb, wb = x.bfloat16(), w.bfloat16()
    scratch = torch.stack([torch.zeros_like(xb), xb])
    got = matmul(xb, wb, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, consume_matmul(scratch, wb, slot=1))


def test_hop_kernel_two_dim_and_rejects(cuda):
    from repro_torch.kernels.cc_matmul import (
        consume_matmul,
        consume_matmul_plain,
        matmul_tile,
    )

    x = torch.randn(10, 16, device=cuda)
    w = torch.randn(16, 12, device=cuda)
    scr = torch.randn(2, 10, 16, device=cuda)
    assert matmul_tile(x, w).shape == (10, 12)
    torch.testing.assert_close(consume_matmul(scr, w, slot=0),
                               consume_matmul_plain(scr, w, slot=0),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        matmul_tile(x.half(), w.half())
    with pytest.raises(ValueError):
        matmul_tile(x, w.t())                    # w's last dim strided
    with pytest.raises(ValueError):
        matmul_tile(x, w.cpu())
    with pytest.raises(ValueError):
        consume_matmul(scr, w, slot=2)


def test_fused_ops_on_card_match_cpu(cuda):
    """Two ranks sharing the card against two CPU ranks: the fused AG and
    RS ops and their gradients, fp32 (TF32 off in the ranks' plain
    GEMMs is torch's default)."""
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    rng = np.random.default_rng(0)
    n = 2
    cases = {"ag": (rng.standard_normal((n, 2, 32, 48)),
                    rng.standard_normal((n, 2, 64, 40))),
             "rs": (rng.standard_normal((n, 2, 64, 48)),
                    rng.standard_normal((n, 2, 32, 40)))}
    ws = rng.standard_normal((n, 48, 40)).astype(np.float32)
    with RankPool(n, device="cuda") as pool:
        for op, (xs, gs) in cases.items():
            xs, gs = xs.astype(np.float32), gs.astype(np.float32)
            card = pool.run(rank_tasks.fused_op, op, xs, ws, gs, True)
            cpu = pool.run(rank_tasks.fused_op, op, xs, ws, gs, True,
                           device="cpu")
            for a, b in zip(card, cpu):
                assert sum(a["launches"].values()) > 0
                assert sum(a["plain"].values()) == 0
                for key in ("out", "dx", "dw"):
                    np.testing.assert_allclose(a[key], b[key], rtol=1e-5,
                                               atol=1e-4)


# ---------------------------------------------------------------------------
# the whole-ring kernels (ag_matmul_ring / rs_matmul_ring): rank processes
# sharing the card, each mapping its ring neighbours' channels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_pools():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.dist.group import RankPool

    pools = {n: RankPool(n, device="cuda") for n in (2, 4)}
    yield pools
    for pool in pools.values():
        pool.close()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["ag", "rs"])
@pytest.mark.parametrize("dx,dw", [("bfloat16", "bfloat16"),
                                   ("float32", "bfloat16"),
                                   ("float32", "float32")])
@pytest.mark.parametrize("bsz,b,nn,k", [(2, 77, 45, 130), (1, 64, 64, 64),
                                        (1, 1, 3, 1), (2, 256, 3072, 256)])
def test_ring_kernel_matches_plain(card_pools, n, op, dx, dw, bsz, b, nn, k):
    """Both ring directions against the unfused composition over gloo;
    x a row block and w a column slice (strided views)."""
    from repro_torch.dist import rank_tasks

    cases = [dict(op=op, direction=d, B=bsz, b=b, N=nn, K=k, dx=dx, dw=dw)
             for d in (1, -1)]
    res = card_pools[n].run(rank_tasks.ring_kernels, cases, iters=1)
    tol = HOP_TOL[(getattr(torch, dx), getattr(torch, dw))]
    for i in range(len(cases)):
        rows = [r[i] for r in res]
        assert all(r["finite"] for r in rows)
        assert all(r["launches"][f"{op}_matmul_ring"] == 1 for r in rows)
        assert all(r["ring_kernels"] == n for r in rows)
        err = max(r["max_abs_err"] for r in rows)
        assert err <= tol * max(r["max_plain"] for r in rows)


def test_fused_ops_in_kernel_ring_equal_emulated(cuda):
    """At 4 ranks, bidirectional: the fused ops and their gradients on the
    in-kernel ring equal the emulated schedule's bit for bit (the same
    tile arithmetic, the same add order)."""
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    rng = np.random.default_rng(1)
    n = 4
    cases = {"ag": (rng.standard_normal((n, 2, 24, 40)),
                    rng.standard_normal((n, 2, 96, 36))),
             "rs": (rng.standard_normal((n, 2, 96, 40)),
                    rng.standard_normal((n, 2, 24, 36)))}
    ws = rng.standard_normal((n, 40, 36)).astype(np.float32)
    got = {}
    for peer in (True, False):
        with RankPool(n, device="cuda", peer_memory=peer) as pool:
            got[peer] = {op: pool.run(rank_tasks.fused_op, op,
                                      xs.astype(np.float32), ws,
                                      gs.astype(np.float32), True)
                         for op, (xs, gs) in cases.items()}
    for op in cases:
        for a, b in zip(got[True][op], got[False][op]):
            assert a["launches"]["ag_matmul_ring"] == 2
            assert a["launches"]["rs_matmul_ring"] == 2
            assert b["launches"]["ag_matmul_ring"] == 0
            assert sum(a["plain"].values()) == sum(b["plain"].values()) == 0
            for key in ("out", "dx", "dw"):
                np.testing.assert_array_equal(a[key], b[key])


def test_ring_wrappers_need_peer_memory(cuda):
    from repro_torch.dist.group import Group
    from repro_torch.kernels.cc_matmul import ag_matmul_ring, rs_matmul_ring

    group = Group(rank=0, size=2, device=cuda)
    x = torch.randn(4, 8, device=cuda)
    w = torch.randn(8, 6, device=cuda)
    with pytest.raises(ValueError, match="peer memory"):
        ag_matmul_ring(x, w, group)
    with pytest.raises(ValueError, match="peer memory"):
        rs_matmul_ring(x, w, group)


# ---------------------------------------------------------------------------
# the DLA matmul kernel (csrc/matmul.cu)
# ---------------------------------------------------------------------------


def _dla_tol(din, dout):
    """Relative to the largest output: fp32 FMAs in another order (TF32
    off); bf16 products, exact in fp32, summed in fp32 by the tensor
    cores; a bf16 output rounds once more."""
    if dout == torch.bfloat16:
        return 1e-2
    return 1e-4 if din == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("din,dout", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("act", ["none", "relu", "relu2", "silu", "gelu"])
@pytest.mark.parametrize("batch,m,k,n,bias", [
    ((), 128, 128, 128, False), ((), 100, 200, 150, True),
    ((), 1, 7, 3, True), ((), 77, 130, 45, True), ((3,), 40, 64, 32, True),
    ((), 512, 512, 512, True),
    ((2,), 256, 2560, 640, False),   # the hop tests' q-edge shape
])
def test_dla_kernel_matches_plain(cuda, din, dout, act, batch, m, k, n,
                                  bias):
    from repro_torch.kernels.matmul import MATMUL, PLAIN_CALLS, matmul
    from repro_torch.kernels.matmul import matmul_plain

    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(*batch, m, k, generator=g, device=cuda).to(din)
    w = torch.randn(k, n + 3, generator=g, device=cuda).to(din)[:, :n]
    b = torch.randn(n, generator=g, device=cuda).to(din) if bias else None
    before, plain = MATMUL.launches, PLAIN_CALLS["matmul"]
    got = matmul(x, w, b, activation=act, out_dtype=dout)
    torch.cuda.synchronize()
    assert MATMUL.launches == before + 1 and PLAIN_CALLS["matmul"] == plain
    want = matmul_plain(x, w, b, activation=act, out_dtype=dout)
    assert got.dtype == dout and got.shape == want.shape
    assert _rel(got.float(), want.float()) <= _dla_tol(din, dout)


def test_dla_kernel_rejects(cuda):
    from repro_torch.kernels.matmul import matmul, matmul_plain

    x = torch.randn(10, 16, device=cuda)
    w = torch.randn(16, 12, device=cuda)
    with pytest.raises(TypeError):
        matmul(x, w.bfloat16())
    with pytest.raises(TypeError):
        matmul(x.half(), w.half())
    with pytest.raises(ValueError):
        matmul(x, w, torch.zeros(11, device=cuda))
    with pytest.raises(ValueError):
        matmul(x, w.cpu())
    wt = torch.randn(12, 16, device=cuda).t()     # unit row stride: copied
    torch.testing.assert_close(matmul(x, wt), matmul_plain(x, wt),
                               rtol=1e-5, atol=1e-4)
    assert matmul(x[:0], w).shape == (0, 12)


# ---------------------------------------------------------------------------
# forward-only kernels: the wrappers refuse autograd; training avoids them
# ---------------------------------------------------------------------------


def _forward_only_call(kernel, device):
    """(call, inputs, the kernel's CudaKernel) at a small shape."""
    g = torch.Generator(device=device).manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    if kernel == "flash_attention":
        from repro_torch.kernels.flash_attention import FLASH

        return (lambda q, k, v: flash_attention(q, k, v),
                [rnd(1, 4, 64, 64), rnd(1, 2, 64, 64), rnd(1, 2, 64, 64)],
                FLASH)
    from repro_torch.kernels.matmul import MATMUL, matmul

    return (lambda x, w: matmul(x, w), [rnd(32, 64), rnd(64, 48)], MATMUL)


@pytest.mark.parametrize("kernel", ["flash_attention", "matmul"])
def test_wrapper_refuses_autograd(cuda, kernel):
    """An input that requires grad while autograd records raises instead
    of returning an output with no ``grad_fn``; under ``no_grad`` (or with
    no input requiring grad) the kernel launches."""
    call, inputs, counter = _forward_only_call(kernel, cuda)
    before = counter.launches
    for i in range(len(inputs)):
        args = [t.clone().requires_grad_(j == i) for j, t in
                enumerate(inputs)]
        with pytest.raises(RuntimeError, match="no backward"):
            call(*args)
    assert counter.launches == before
    with torch.no_grad():
        call(*[t.clone().requires_grad_(True) for t in inputs])
    call(*inputs)
    torch.cuda.synchronize()
    assert counter.launches == before + 2


def test_tp1_train_step_on_card_matches_cpu(cuda):
    """Two tp-1 steps of reduced smollm-360m in fp32 (microbatches 2) on
    the card against the CPU from the same parameters and batches: loss and
    grad norm 1e-4 relative, parameters 1e-4; no flash or SSD launch."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.group import Group
    from repro_torch.dist.steps import (
        StepConfig,
        build_init,
        build_train_step,
        init_opt,
    )
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.models.model import params_to

    cfg = get_config("smollm-360m").reduced()
    scfg = StepConfig(microbatches=2, seq_chunk=8, warmup_steps=1)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=33,
                                  global_batch=4))
    cpu = Group(rank=0, size=1, device=torch.device("cpu"))
    card = Group(rank=0, size=1, device=cuda)
    p_cpu, o_cpu = build_init(cfg, cpu, scfg)(0)
    p_gpu = params_to(p_cpu, cuda)
    o_gpu = init_opt(p_gpu, scfg)
    launches = (FLASH.launches, SSD.launches)
    for k in range(2):
        batch = data.global_batch(k)
        p_cpu, o_cpu, m_cpu = build_train_step(cfg, cpu, scfg)(
            p_cpu, o_cpu, batch, k)
        p_gpu, o_gpu, m_gpu = build_train_step(cfg, card, scfg)(
            p_gpu, o_gpu, batch, k)
        for key in ("loss", "grad_norm"):
            assert abs(m_gpu[key] - m_cpu[key]) <= 1e-4 * abs(m_cpu[key])
    assert (FLASH.launches, SSD.launches) == launches
    for (_, a), (_, b) in zip(sharding.leaves(p_gpu),
                              sharding.leaves(p_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the PGAS substrate on the card: peer-mapped heaps against the wire
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pgas_pools():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (peer memory is the card's)")
    from repro_torch.dist.group import RankPool

    pools = {"peer": RankPool(4, device="cuda"),
             "wire": RankPool(4, device="cuda", peer_memory=False),
             "cpu": RankPool(4, device="cpu")}
    yield pools
    for pool in pools.values():
        pool.close()


def _pgas_ops(n, rng):
    def pay(words):
        return rng.standard_normal((n, words)).astype(np.float32)

    ring = [(i, (i + 1) % n) for i in range(n)]
    return [("put", pay(16), 5, [(0, 2)]), ("put_ring", pay(16), 30, 1),
            ("put_slice", 30, 16, 34, ring), ("get", 34, 16, ring),
            ("get", 90, 16, [(1, 2), (2, 3)]),
            ("write_block", "blocks", 8, pay(8), 5, [(0, 1)]),
            ("read_symbol", "blocks", [(3, 1)]),
            ("gasnet_put", pay(8), 70, [(1, 3)]),
            ("gasnet_get", 70, 0, 8, [(0, 3)]),
            ("am_short", "SCALE", (0, 3, 50), [(2, 0)]),
            ("am_medium", "ACCUM", (10,), pay(16), [(0, 1), (1, 0)]),
            ("am_long", "SCALE", (0, 2, 60), pay(16), 20, [(3, 2)])]


def test_peer_heaps_equal_wire_and_cpu(pgas_pools):
    """The same one-sided program through peer stores, the card's gloo
    wire and CPU ranks: bit-identical heaps and deliveries."""
    from repro_torch.dist import rank_tasks

    rng = np.random.default_rng(0)
    ops = _pgas_ops(4, rng)
    init = rng.standard_normal((4, 96)).astype(np.float32)
    res = {k: p.run(rank_tasks.pgas_program, 96, [("blocks", 32)], ops,
                    init) for k, p in pgas_pools.items()}
    assert all(r["peer"] for r in res["peer"])
    assert not any(r["peer"] for r in res["wire"] + res["cpu"])
    for tag in ("peer", "wire"):
        for a, b in zip(res[tag], res["cpu"]):
            np.testing.assert_array_equal(a["heap"], b["heap"])
            for x, y in zip(a["outputs"], b["outputs"]):
                np.testing.assert_array_equal(x, y)


def test_quickstart_peer_equals_wire_and_cpu(pgas_pools):
    from repro_torch.dist import rank_tasks

    res = {k: p.run(rank_tasks.quickstart) for k, p in pgas_pools.items()}
    for tag in ("peer", "wire"):
        for a, b in zip(res[tag], res["cpu"]):
            np.testing.assert_array_equal(a["heap"], b["heap"])
            assert a["art_err"] < 2e-4
    assert np.all(res["peer"][2]["heap"][16:32] == 20.0)


def test_put_get_sweep_reads_back(pgas_pools):
    from repro_torch.dist import rank_tasks

    for tag in ("peer", "wire"):
        rows = pgas_pools[tag].run(rank_tasks.put_get_sweep,
                                   [1, 1000, 1 << 16], 1 << 17, 2, 2)[0]
        assert [r["read_back"] for r in rows] == [True] * 3


def test_dropped_heaps_are_freed(pgas_pools):
    """A heap's partition is unmapped and freed once the heap has gone on
    every rank: a pool that runs program after program holds one."""
    from repro_torch.dist import rank_tasks

    for r in pgas_pools["peer"].run(rank_tasks.heap_churn, 4, 1 << 20):
        assert r == {"partitions": [1] * 4, "read_back": True}


def test_unmapped_heap_on_a_peer_group_raises(cuda):
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    with RankPool(2, device="cuda") as pool:
        with pytest.raises(RuntimeError, match="mapped"):
            pool.run(rank_tasks.pgas_program, 16, [],
                     [("put", np.ones((2, 4), np.float32), 0, [(0, 1)])],
                     device="cuda")


def test_reduced_vlm_on_card_matches_cpu(cuda):
    """Reduced internvl2-2b in fp32: bulk prefill over 8 patch rows and 29
    tokens, the same rows in chunks cut inside the patches, and two
    decode steps, through the flash kernel on the card (n_layers launches
    a pass or chunk) against the plain version on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.decode import decode_step
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import (
        init_prefill_scratch,
        prefill,
        prefill_chunk,
    )

    cfg = get_config("internvl2-2b").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    on_card = params_to(params, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=(2, 29))).long()
    fe = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32))
    c_cpu, l_cpu = prefill(cfg, params, toks, fe, cache_len=64)
    before = FLASH.launches
    c_gpu, l_gpu = prefill(cfg, on_card, toks.to(cuda), fe.to(cuda),
                           cache_len=64)
    assert FLASH.launches == before + cfg.n_layers
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c_gpu["k"].cpu(), c_cpu["k"], rtol=1e-4,
                               atol=1e-4)
    n, s = cfg.frontend_tokens, cfg.frontend_tokens + 29
    scr = init_prefill_scratch(cfg, 2, s, cuda)
    for lo, hi in ((0, 5), (5, 20), (20, s)):
        before = FLASH.launches
        scr, l_chunk = prefill_chunk(
            cfg, on_card, scr, toks[:, max(0, lo - n):max(0, hi - n)].to(cuda), lo,
            fe[:, lo:min(hi, n)].to(cuda) if lo < n else None)
        assert FLASH.launches == before + cfg.n_layers
    torch.testing.assert_close(l_chunk.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    step = torch.tensor([3, 7])
    for _ in range(2):
        c_cpu, d_cpu = decode_step(cfg, params, c_cpu, step)
        c_gpu, d_gpu = decode_step(cfg, on_card, c_gpu, step.to(cuda))
        torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-4, atol=1e-4)


def test_reduced_encdec_on_card_matches_cpu(cuda):
    """Reduced whisper-tiny in fp32: bulk prefill of 20 decoder tokens
    over 16 frames (the encoder's, the decoder's self- and its
    cross-attention through the flash kernel: n_encoder_layers + 2 ×
    n_layers launches), chunked prefill (the encoder on chunk 0 only), and
    two decode steps (no kernel), on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.decode import decode_step
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import (
        init_prefill_scratch,
        prefill,
        prefill_chunk,
    )

    cfg = get_config("whisper-tiny").reduced()
    params = init_params(cfg, seed=0, device="cpu")
    on_card = params_to(params, cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=(2, 20))).long()
    fe = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32))
    c_cpu, l_cpu = prefill(cfg, params, toks, fe, cache_len=32)
    before = FLASH.launches
    c_gpu, l_gpu = prefill(cfg, on_card, toks.to(cuda), fe.to(cuda),
                           cache_len=32)
    assert FLASH.launches == before + cfg.n_encoder_layers + 2 * cfg.n_layers
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    for key in ("k", "cross_k", "cross_v"):
        torch.testing.assert_close(c_gpu[key].cpu(), c_cpu[key], rtol=1e-4,
                                   atol=1e-4)
    scr = init_prefill_scratch(cfg, 2, 20, cuda)
    for lo, hi in ((0, 3), (3, 20)):
        before = FLASH.launches
        scr, l_chunk = prefill_chunk(cfg, on_card, scr, toks[:, lo:hi].to(
            cuda), lo, fe.to(cuda) if lo == 0 else None)
        assert FLASH.launches == before + 2 * cfg.n_layers + (
            cfg.n_encoder_layers if lo == 0 else 0)
    torch.testing.assert_close(l_chunk.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    step = torch.tensor([3, 7])
    before = FLASH.launches
    for _ in range(2):
        c_cpu, d_cpu = decode_step(cfg, params, c_cpu, step)
        c_gpu, d_gpu = decode_step(cfg, on_card, c_gpu, step.to(cuda))
        torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-4, atol=1e-4)
    assert FLASH.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,sq,skv,q_offset", [
    (40, 77, 77, None),          # ragged bulk
    (40, 384, 384, None),        # bulk, six q tiles
    (40, 128, 1024, 512),        # a chunk of a long scratch (split in bf16)
    (40, 100, 1100, 1000),       # a ragged chunk at the scratch's end
    (6, 24, 300, 200),           # few heads: a split even at Sq 24
])
def test_mla_head_dims_match_plain(cuda, dtype, hq, sq, skv, q_offset):
    """MLA's (q/k 96, v 64) pair at minicpm3's 40 heads, k contiguous and
    v a transposed (B, S, H, 64) view as the model passes them, MLA's
    scale: fp32 at 2e-4 against the plain version; bf16 at 3e-2 and, to
    the plain and the split-and-merge plain versions, at BF16_SPLIT_REL.
    The output has v's head dim."""
    g = torch.Generator(device=cuda).manual_seed(sq + skv)
    q = torch.randn(1, hq, sq, 96, generator=g, device=cuda).to(dtype)
    k = torch.randn(1, hq, skv, 96, generator=g, device=cuda).to(dtype)
    v = torch.randn(1, skv, hq * 64, generator=g, device=cuda).to(
        dtype).view(1, skv, hq, 64).transpose(1, 2)
    kw = dict(scale=96 ** -0.5, q_offset=q_offset)
    before = FLASH.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    assert got.dtype == dtype and got.shape == (1, hq, sq, 64)
    assert torch.isfinite(got).all()
    err = (got.float() - attention_plain(q, k, v, **kw).float()).abs().max()
    assert err.item() <= TOL[dtype], err.item()
    if dtype == torch.bfloat16:
        errs = _split_rel_err(got, q, k, v, **kw)
        assert max(errs) <= BF16_SPLIT_REL, errs


def test_unsupported_head_dim_pair_raises(cuda):
    """Only the pairs of ``ops.HEAD_DIM_PAIRS`` launch: (128, 64) or
    (64, 96) raise, in either dtype, and launch nothing."""
    before = FLASH.launches
    for dtype in (torch.float32, torch.bfloat16):
        for dk, dv in ((128, 64), (64, 96), (96, 32)):
            q = torch.randn(1, 2, 8, dk, device=cuda).to(dtype)
            v = torch.randn(1, 2, 8, dv, device=cuda).to(dtype)
            with pytest.raises(ValueError, match="head dims"):
                flash_attention(q, q, v)
    q = torch.randn(1, 2, 8, 96, device=cuda)
    with pytest.raises(ValueError):             # v's rows are not k's
        flash_attention(q, q, torch.randn(1, 2, 9, 64, device=cuda))
    assert FLASH.launches == before


def test_reduced_mla_on_card_matches_cpu(cuda):
    """Reduced minicpm3-4b at the full width's head dims (q/k 96, v 64)
    in fp32: bulk prefill of 37 tokens, the same rows in chunks (flash
    n_layers times a pass or chunk at (96, 64)), and two decode steps (no
    kernel: the absorbed form over the latent), on the card against the
    plain versions on the CPU."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.decode import decode_step
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import (
        init_prefill_scratch,
        prefill,
        prefill_chunk,
    )

    cfg = dataclasses.replace(get_config("minicpm3-4b").reduced(),
                              qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
                              head_dim=96)
    params = init_params(cfg, seed=0, device="cpu")
    on_card = params_to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 37))).long()
    c_cpu, l_cpu = prefill(cfg, params, toks, cache_len=64)
    before = FLASH.launches
    c_gpu, l_gpu = prefill(cfg, on_card, toks.to(cuda), cache_len=64)
    assert FLASH.launches == before + cfg.n_layers
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    for key in ("ckv", "krope"):
        torch.testing.assert_close(c_gpu[key].cpu(), c_cpu[key], rtol=1e-4,
                                   atol=1e-4)
    scr = init_prefill_scratch(cfg, 2, 37, cuda)
    for lo, hi in ((0, 5), (5, 20), (20, 37)):
        before = FLASH.launches
        scr, l_chunk = prefill_chunk(cfg, on_card, scr,
                                     toks[:, lo:hi].to(cuda), lo)
        assert FLASH.launches == before + cfg.n_layers
    torch.testing.assert_close(l_chunk.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    step = torch.tensor([3, 7])
    before = FLASH.launches
    for _ in range(2):
        c_cpu, d_cpu = decode_step(cfg, params, c_cpu, step)
        c_gpu, d_gpu = decode_step(cfg, on_card, c_gpu, step.to(cuda))
        torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-4, atol=1e-4)
    assert FLASH.launches == before


# ---------------------------------------------------------------------------
# the MoE family (llama4-scout, grok-1): flash at a GQA group of 5, and the
# reduced models card against CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,q_offset", [
    (384, 384, None),            # bulk, six q tiles
    (2048, 2048, None),          # bulk at the smoke's timed length
    (128, 1024, 512),            # a chunk of a long scratch (split in bf16)
    (100, 1100, 1000),           # a ragged chunk at the scratch's end
])
def test_gqa_group_of_five_matches_plain(cuda, dtype, sq, skv, q_offset):
    """llama4-scout's 40 q heads over 8 kv heads at D 128: fp32 at 2e-4;
    bf16 at 3e-2 and, to the plain and the split-and-merge plain
    versions, at BF16_SPLIT_REL."""
    q, k, v = _qkv((1, 40, sq, 128), (1, 8, skv, 128), dtype, cuda,
                   seed=sq + skv + 5)
    before = FLASH.launches
    got = flash_attention(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    err = (got.float() - attention_plain(q, k, v, q_offset=q_offset)
           .float()).abs().max().item()
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        errs = _split_rel_err(got, q, k, v, q_offset=q_offset)
        assert max(errs) <= BF16_SPLIT_REL, errs


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "grok-1-314b"])
def test_reduced_moe_on_card_matches_cpu(cuda, name, monkeypatch):
    """Reduced llama4-scout (top-1, a shared expert) and grok-1 (top-2)
    in fp32: bulk prefill of 37 tokens (every MoE layer's routing
    decisions equal on the two: idx and keep), the same rows in chunks
    (flash n_layers times a chunk), and two decode steps (every expert on
    every row, no kernel), on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.decode import decode_step
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import (
        init_prefill_scratch,
        prefill,
        prefill_chunk,
    )

    cfg = get_config(name).reduced()
    params = init_params(cfg, seed=0, device="cpu")
    on_card = params_to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 37))).long()
    route, routes = L.moe_route, []

    def record(cfg_, router, xc):
        out = route(cfg_, router, xc)
        routes.append((out[1].cpu(), out[2].cpu()))
        return out

    monkeypatch.setattr(L, "moe_route", record)
    c_cpu, l_cpu = prefill(cfg, params, toks, cache_len=64)
    cpu_routes, routes[:] = list(routes), []
    before = FLASH.launches
    c_gpu, l_gpu = prefill(cfg, on_card, toks.to(cuda), cache_len=64)
    assert FLASH.launches == before + cfg.n_layers
    assert len(routes) == len(cpu_routes) == cfg.n_layers
    for (idx_c, keep_c), (idx_g, keep_g) in zip(cpu_routes, routes):
        assert torch.equal(idx_c, idx_g) and torch.equal(keep_c, keep_g)
    torch.testing.assert_close(l_gpu.cpu(), l_cpu, rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        torch.testing.assert_close(c_gpu[key].cpu(), c_cpu[key], rtol=1e-4,
                                   atol=1e-4)
    scr_cpu = init_prefill_scratch(cfg, 2, 37, "cpu")
    scr = init_prefill_scratch(cfg, 2, 37, cuda)
    for lo, hi in ((0, 5), (5, 20), (20, 37)):
        scr_cpu, want = prefill_chunk(cfg, params, scr_cpu, toks[:, lo:hi],
                                      lo)
        before = FLASH.launches
        scr, got = prefill_chunk(cfg, on_card, scr, toks[:, lo:hi].to(cuda),
                                 lo)
        assert FLASH.launches == before + cfg.n_layers
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    step = torch.tensor([3, 7])
    before = FLASH.launches
    for _ in range(2):
        c_cpu, d_cpu = decode_step(cfg, params, c_cpu, step)
        c_gpu, d_gpu = decode_step(cfg, on_card, c_gpu, step.to(cuda))
        torch.testing.assert_close(d_gpu.cpu(), d_cpu, rtol=1e-4, atol=1e-4)
    assert FLASH.launches == before
