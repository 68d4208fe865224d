"""Flash-attention wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and nothing in between.

``flash_attention`` checks device, dtype, shapes and strides, allocates the
output with ``torch.empty`` and launches ``csrc/flash_attention.cu`` on the
current stream.  Inputs may be strided views (the model passes q as a
transposed projection and k/v as layer slices of the scratch) as long as
the head dim is contiguous; the output is contiguous (B, Hq, Sq, D).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import CudaKernel
from repro_torch.kernels.flash_attention.ref import attention_plain

HEAD_DIMS = (16, 32, 64, 80, 96, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FLASH = CudaKernel(
    "flash_attention", "repro_flash_attention_fwd",
    [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _L, _L, _L,
     _I, _I, _I, ctypes.c_float, _P])


def flash_attention(
    q: torch.Tensor,               # (B, Hq, Sq, D)
    k: torch.Tensor,               # (B, Hkv, Skv, D)
    v: torch.Tensor,               # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Attention of q rows at absolute positions ``q_offset + i`` (default
    ``Skv - Sq``) over k/v with GQA (``Hq % Hkv == 0``).  See
    :func:`~repro_torch.kernels.flash_attention.ref.attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, hq, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    hkv, skv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv or sq == 0 or skv == 0 or b * hq > 65535:
        raise ValueError(f"flash_attention: batch {b}, heads {hq}/{hkv}, "
                         f"seq {sq}/{skv}")     # grid.y is b * hq
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; supported: float32 or bfloat16, alike")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: head dim must be contiguous")
    offset = skv - sq if q_offset is None else int(q_offset)
    if offset < 0:
        raise ValueError(f"flash_attention: q_offset {offset} < 0")
    scale = float(scale) if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    fn = FLASH.fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, hq, hkv, sq, skv,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                offset, int(causal), int(window or 0), scale, stream)
    FLASH.check(rc)
    FLASH.launches += 1
    return out
