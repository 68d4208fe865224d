"""Global-norm gradient clipping (``repro.optim.clip``), over the TP group.

With a group, the squared norm is the group's all-reduced sum over the
sharded leaves (each rank holds a disjoint part of them) plus the
replicated leaves' sum counted once (they are equal on every rank)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def global_norm(grads: Sequence[torch.Tensor], group=None,
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """fp32 L2 norm of all leaves; see the module docstring for ``group``."""
    sq = [torch.sum(g.float() ** 2) for g in grads]
    if group is None or sharded is None:
        return torch.sqrt(torch.sum(torch.stack(sq)))
    zero = grads[0].new_zeros((), dtype=torch.float32)
    part = sum((s for s, sh in zip(sq, sharded) if sh), zero)
    rep = sum((s for s, sh in zip(sq, sharded) if not sh), zero)
    return torch.sqrt(group.all_reduce(part) + rep)


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        group=None, sharded: Optional[Sequence[bool]] = None
                        ) -> Tuple[List[torch.Tensor], float]:
    """Returns (clipped grads, pre-clip norm); the grads are scaled in
    place."""
    norm = global_norm(grads, group, sharded)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return list(grads), float(norm)


__all__ = ["clip_by_global_norm", "global_norm"]
