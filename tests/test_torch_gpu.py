"""The CUDA kernels on the card, held to their plain versions.

Marked ``gpu``: each test skips where there is no CUDA device (decided
inside the fixture, never at import).  On the card run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Flash-attention tolerances are those of the reference's kernel tests: fp32
2e-4 with TF32 off (set here), bf16 3e-2.  SSD tolerances are relative to
the largest output: y 1e-4 in fp32 and 2e-2 in bf16 (y is written in
bf16), the fp32 state 1e-4 in both.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    FLASH,
    attention_plain,
    flash_attention,
)
from repro_torch.kernels.ssd import SSD, ssd, ssd_plain

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


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
@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128])
@pytest.mark.parametrize("sq,skv,q_offset,window", [
    (77, 77, None, None),        # ragged bulk
    (128, 128, None, 40),        # aligned, windowed
    (24, 300, 200, None),        # a mid-sequence chunk
    (40, 300, 150, 33),          # a windowed chunk
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


def _ssd_inputs(bsz, s, h, g, n, p, dtype, device, seed, init):
    """x, B and C as strided views of one conv-output-like buffer, as the
    model passes them; dt, a and d drawn as the model makes them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    width = h * p + 2 * g * n + 8
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
    with pytest.raises(ValueError, match="shared memory"):
        ssd(*big, chunk=256)              # 411 KB > 227 KB
    with pytest.raises(ValueError):                       # state shape
        ssd(x, dt, a, b, c, d, chunk=8,
            init_state=torch.zeros(1, 2, 16, 8, device=cuda))


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
