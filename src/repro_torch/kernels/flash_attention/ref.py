"""Plain PyTorch versions of the flash-attention kernel (materialise scores).

The oracle of ``csrc/flash_attention.cu``: the same function — GQA, an
explicit ``q_offset``, causal and sliding-window masks, fully masked rows
output 0, v's head dim its own (MLA's 64 beside q/k's 96) — written as one
dense score matrix in fp32
(:func:`attention_plain`), and the bf16 kernel's split-KV arithmetic
written out in plain PyTorch (:func:`attention_split_plain`: each split's
unnormalised output, row max and row sum, merged in split order).  The CPU
tests run both; on the card ``chip_smoke.py`` holds the kernel to them.
The port's main path never calls either on a card.
"""

from __future__ import annotations

from typing import Optional

import torch


def _mask(rows: torch.Tensor, cols: torch.Tensor, skv: int, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    mask = (cols < skv).expand(rows.shape[0], cols.shape[1])
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def attention_plain(
    q: torch.Tensor,               # (B, Hq, Sq, DK)
    k: torch.Tensor,               # (B, Hkv, Skv, DK)
    v: torch.Tensor,               # (B, Hkv, Skv, DV)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """q row ``i`` sits at absolute position ``q_offset + i`` (default
    ``Skv - Sq``, right-aligned) and sees columns ``c`` with ``c <= row``
    (causal) and ``c > row - window`` (window); ``scale`` defaults to
    ``DK ** -0.5``.  Returns (B, Hq, Sq, DV) in q's dtype."""
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


def attention_split_plain(
    q: torch.Tensor,               # (B, Hq, Sq, DK)
    k: torch.Tensor,               # (B, Hkv, Skv, DK)
    v: torch.Tensor,               # (B, Hkv, Skv, DV)
    plan,                          # ops.KvSplitPlan
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """The bf16 kernel's split-KV schedule in fp32: for each q tile of
    ``ops.BLOCK_Q`` rows and each split of its visible kv tiles
    (``ops.split_ranges``), the split's unnormalised output ``O_s``, row
    max ``m_s`` and row sum ``l_s``; then ``Σ O_s e^(m_s − M) / Σ l_s
    e^(m_s − M)`` with ``M = max m_s``, the splits taken in order.  Rows
    no split sees output 0.  Returns (B, Hq, Sq, DV) in q's dtype."""
    from repro_torch.kernels.flash_attention.ops import (
        BLOCK_KV,
        BLOCK_Q,
        split_ranges,
    )

    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    offset = skv - sq if q_offset is None else q_offset
    qg = q.reshape(b, hkv, group, sq, d).float() * scale
    kf, vf = k.float(), v.float()
    dv = v.shape[-1]
    out = torch.zeros(b, hkv, group, sq, dv, dtype=torch.float32,
                      device=q.device)
    for qt in range(-(-sq // BLOCK_Q)):
        i0, i1 = qt * BLOCK_Q, min((qt + 1) * BLOCK_Q, sq)
        rows = offset + torch.arange(i0, i1, device=q.device)[:, None]
        parts = []
        for lo, hi in split_ranges(plan, qt, sq, skv, offset, causal,
                                   window):
            c0, c1 = lo * BLOCK_KV, min(hi * BLOCK_KV, skv)
            if c1 <= c0:
                continue
            cols = torch.arange(c0, c1, device=q.device)[None, :]
            s = torch.einsum("bkgqd,bkcd->bkgqc", qg[..., i0:i1, :],
                             kf[:, :, c0:c1])
            s = s.masked_fill(~_mask(rows, cols, skv, causal, window),
                              float("-inf"))
            m = s.amax(-1, keepdim=True)
            m_use = torch.where(torch.isinf(m), torch.zeros_like(m), m)
            p = torch.exp(s - m_use)
            parts.append((torch.einsum("bkgqc,bkcd->bkgqd", p,
                                       vf[:, :, c0:c1]),
                          m, p.sum(-1, keepdim=True)))
        if not parts:
            continue
        mx = torch.stack([m for _, m, _ in parts]).amax(0)
        mx = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
        num = torch.zeros_like(parts[0][0])
        den = torch.zeros_like(parts[0][2])
        for o_s, m_s, l_s in parts:
            w = torch.exp(m_s - mx)
            num = num + o_s * w
            den = den + l_s * w
        den = torch.where(den == 0.0, torch.ones_like(den), den)
        out[..., i0:i1, :] = num / den
    return out.reshape(b, hq, sq, dv).to(q.dtype)
