"""The CUDA kernels on the card, held to their plain versions.

Marked ``gpu``: each test skips where there is no CUDA device (decided
inside the fixture, never at import).  On the card run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.

Tolerances are those of the reference's kernel tests: fp32 2e-4 with TF32
off (set here), bf16 3e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    FLASH,
    attention_plain,
    flash_attention,
)

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
