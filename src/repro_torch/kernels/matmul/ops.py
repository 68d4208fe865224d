"""The DLA instruction: ``activation(x @ w + bias)`` in one launch of the
hand-written CUDA kernel ``csrc/matmul.cu`` (the counterpart of
``repro.kernels.matmul.ops.matmul`` over ``matmul_pallas``).

The tensor's device alone decides: a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises.  There is no
interpret flag, no override and no fallback.  ``MATMUL.launches`` grows by
one where the kernel launches and nowhere else.

Differences from the reference's wrapper, all in what it needs to be told:

* no ``block_m``/``block_n``/``block_k``: the kernel picks its output
  tile from the shape (the main loops and the tile choice of
  ``kernels/include/gemm.cuh``, shared with the collective-matmul kernels:
  32 × 32 to 128 × 128), and the ragged edges of M, N and K are masked
  inside the kernel, so nothing is padded (the reference pads to block
  multiples and crops);
* no ``interpret``: the CPU path is the plain version.

Batch dims of ``x`` fold into M (one weight shared across the batch, as
in the reference).  Rows may be strided (``x.stride(-1) == 1`` and
``w.stride(-1) == 1`` with any row pitch, e.g. a column slice of a wider
weight); anything else is made contiguous first.  The kernel takes fp32 ×
fp32 (fp32 FMAs on the CUDA cores, no TF32: the reference's fp32 dot is full
fp32) or bf16 × bf16 (``wgmma`` on the tensor cores, fp32 accumulation), a
bias in either type, and writes fp32 or bf16.  Without bias and activation
and with an fp32 output its product is bitwise that of
``cc_matmul.ops.matmul_tile`` on the same operands.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.common import CudaKernel, refuse_autograd
from repro_torch.kernels.matmul.ref import ACTIVATIONS, matmul_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (dtype_in, dtype_out, dtype_bias (-1: none), activation, x, w, bias, out,
#  M, N, K, sxm, swk, stream)
MATMUL = CudaKernel(
    "matmul", "repro_matmul",
    [_I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _L, _L, _P])

#: the columns of the kernel's widest output tile by operand type (fp32 32
#: or 64, bf16 64 or 128): past 65535 tiles of it the kernel always takes
#: that tile, whose count along N must fit in grid.y
_TILE_COLS = {torch.float32: 64, torch.bfloat16: 128}

#: runs of the plain version (the CPU path); a card run expects none
PLAIN_CALLS = {"matmul": 0}


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a 2-D view with unit column stride (a copy otherwise)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *,
                activation: str = "none",
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel on 2-D CUDA tensors: x (M, K), w (K, N), bias
    (N,) or None; returns a new contiguous (M, N) tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"matmul kernel: needs CUDA tensors, got "
                         f"{x.device}")
    refuse_autograd("matmul", x, w, bias)
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype \
            or out_dtype not in _DTYPES \
            or (bias is not None and bias.dtype not in _DTYPES):
        raise TypeError(f"matmul: dtypes x {x.dtype}, w {w.dtype}, bias "
                        f"{None if bias is None else bias.dtype}, out "
                        f"{out_dtype}; the kernel takes fp32 x fp32 or "
                        f"bf16 x bf16, a bias and an output in either")
    m, k = x.shape
    n = w.shape[1]
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"matmul: bias {tuple(bias.shape)} for N = {n}")
    if any(t.device != x.device for t in (w, bias) if t is not None):
        raise ValueError("matmul: x, w and bias on different devices")
    if -(-n // _TILE_COLS[x.dtype]) > 65535:
        raise ValueError(f"matmul: N = {n} columns exceed the grid")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    x, w = _rows(x), _rows(w)
    if bias is not None:
        bias = bias.contiguous()
    fn = MATMUL.fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(_DTYPES[x.dtype], _DTYPES[out_dtype],
                -1 if bias is None else _DTYPES[bias.dtype],
                ACTIVATIONS.index(activation), x.data_ptr(), w.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                m, n, k, x.stride(0), w.stride(0), stream)
    MATMUL.check(rc)
    MATMUL.launches += 1
    return out


def matmul(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None, *,
           activation: str = "none",
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """DLA-style fused ``activation(x @ w + bias)``: x (M, K) or batched
    (..., M, K), w (K, N) shared across the batch, bias (N,) or None;
    returns (..., M, N) in ``out_dtype`` (default ``x.dtype``)."""
    if x.device.type == "cpu":
        PLAIN_CALLS["matmul"] += 1
        return matmul_plain(x, w, bias, activation=activation,
                            out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {x.device}")
    if x.dim() < 2:
        raise ValueError(f"matmul: x {tuple(x.shape)} needs (..., M, K)")
    batch = x.shape[:-2]
    x2 = x.reshape(-1, x.shape[-1]) if batch else x
    y = matmul_cuda(x2, w, bias, activation=activation, out_dtype=out_dtype)
    return y.reshape(*batch, x.shape[-2], w.shape[-1]) if batch else y


__all__ = ["MATMUL", "PLAIN_CALLS", "matmul", "matmul_cuda"]
