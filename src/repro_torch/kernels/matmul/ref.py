"""Plain PyTorch version of the DLA matmul (``repro.kernels.matmul.ref``).

``activation(x @ w + bias)``: the product in fp32, the bias added in fp32,
the activation applied in fp32, then one cast to ``out_dtype``.  It is the
CPU path of :func:`repro_torch.kernels.matmul.ops.matmul` and what
``chip_smoke.py`` holds the CUDA kernel to; nothing on a card path calls
it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = ("none", "relu", "relu2", "silu", "gelu")


def apply_activation(y: torch.Tensor, activation: str) -> torch.Tensor:
    """The reference's ``_apply_activation`` on an fp32 tensor.  ``gelu``
    is the tanh approximation, ``jax.nn.gelu``'s default (PyTorch's
    default is the erf form, ~1e-3 away)."""
    if activation == "none":
        return y
    if activation == "relu":
        return torch.clamp_min(y, 0.0)
    if activation == "relu2":                 # squared ReLU (Nemotron-4)
        r = torch.clamp_min(y, 0.0)
        return r * r
    if activation == "silu":
        return y * torch.sigmoid(y)
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"unknown activation {activation!r}")


def matmul_plain(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 activation: str = "none",
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``activation(x @ w + bias)`` with an fp32 product: x (..., M, K),
    w (K, N), bias (N,) or None; returns (..., M, N) in ``out_dtype``
    (default ``x.dtype``)."""
    out_dtype = out_dtype or x.dtype
    y = torch.matmul(x.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    return apply_activation(y, activation).to(out_dtype)


__all__ = ["ACTIVATIONS", "apply_activation", "matmul_plain"]
