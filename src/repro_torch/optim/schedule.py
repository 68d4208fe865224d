"""LR schedule as a function of the step index (``repro.optim.schedule``),
computed in fp32 like the reference's jnp version."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step: int, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> float:
    """Linear warmup to ``peak_lr`` then cosine decay to ``final_frac·peak``."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    t = (s - warmup_steps) / max(total_steps - warmup_steps, 1)
    t = t.clamp(0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return float(torch.where(s < warmup_steps, warm, peak_lr * cos))


__all__ = ["warmup_cosine"]
