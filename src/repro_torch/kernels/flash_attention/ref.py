"""Plain PyTorch version of the flash-attention kernel (materialises scores).

The oracle of ``csrc/flash_attention.cu``: the same function — GQA, an
explicit ``q_offset``, causal and sliding-window masks, fully masked rows
output 0 — written as one dense score matrix in fp32.  The CPU tests run
it; on the card ``chip_smoke.py`` holds the kernel to it.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_plain(
    q: torch.Tensor,               # (B, Hq, Sq, D)
    k: torch.Tensor,               # (B, Hkv, Skv, D)
    v: torch.Tensor,               # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """q row ``i`` sits at absolute position ``q_offset + i`` (default
    ``Skv - Sq``, right-aligned) and sees columns ``c`` with ``c <= row``
    (causal) and ``c > row - window`` (window).  Returns q's dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    offset = skv - sq if q_offset is None else q_offset
    qg = q.reshape(b, hkv, group, sq, d).float() * scale
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float())
    rows = offset + torch.arange(sq, device=q.device)[:, None]
    cols = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(-1e30)   # all-masked rows: finite
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p / denom, v.float())
    return out.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)
