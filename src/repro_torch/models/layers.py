"""Dense-decoder layers: RMSNorm, RoPE, GQA attention and the gated MLP.

The counterpart of the dense subset of ``repro.models.layers``.  Parameters
are plain dicts of tensors laid out as the reference's (weights
``(d_in, d_out)``), and attention tensors are ``(B, H, S, D)``.  Attention
has one path: :func:`attention_core` calls the flash-attention wrapper,
which launches the CUDA kernel for CUDA tensors and runs its plain version
for CPU tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.kernels.flash_attention import flash_attention

Params = Dict[str, Any]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


def rms_norm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (S,) or broadcastable."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   q_offset: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, Sq, D) against k/v (B, Hkv, Skv, D); q row ``i`` at
    absolute position ``q_offset + i`` (default right-aligned)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def qkv_proj(cfg: ModelConfig, p: Params, x: torch.Tensor,
             positions: torch.Tensor):
    """x (B, S, D) → roped q (B, Hq, S, hd), k and v (B, Hkv, S, hd)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = cdtype(cfg)
    xc = x.to(cd)
    q = (xc @ p["wq"].to(cd)).reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = (xc @ p["wk"].to(cd)).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = (xc @ p["wv"].to(cd)).reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def out_proj(cfg: ModelConfig, p: Params, out: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Attention output (B, Hq, S, hd) → (B, S, D) through ``wo``."""
    b, _, s, _ = out.shape
    cd = cdtype(cfg)
    flat = out.transpose(1, 2).reshape(b, s, -1)
    return (flat @ p["wo"].to(cd)).to(dtype)


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor, *, return_kv: bool = False):
    """Causal GQA self-attention, x (B, S, D) → (B, S, D).  ``return_kv``
    also returns the roped K/V — the bulk prefill's cache source."""
    q, k, v = qkv_proj(cfg, p, x, positions)
    out = attention_core(q, k, v, causal=True, window=cfg.window)
    y = out_proj(cfg, p, out, x.dtype)
    if return_kv:
        return y, (k, v)
    return y


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if name == "relu2":
        r = torch.clamp_min(x, 0.0)
        return r * r
    raise ValueError(name)


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    cd = cdtype(cfg)
    xc = x.to(cd)
    up = xc @ p["w_up"].to(cd)
    if cfg.gated_mlp:
        up = _act(cfg.activation, xc @ p["w_gate"].to(cd)) * up
    else:
        up = _act(cfg.activation, up)
    return (up @ p["w_down"].to(cd)).to(x.dtype)
