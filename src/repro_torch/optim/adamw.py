"""AdamW over a list of parameter tensors (``repro.optim.adamw``).

Numerics are the reference's: fp32 moments by default, an fp32 master
copy of bf16 parameters, bias corrections from the step count, decoupled
weight decay on the master.  Unlike the reference's pure functions, the
update writes the parameters, moments and masters in place: at full
width a second copy of every optimizer leaf would not fit beside the
first.  A leaf larger than :data:`UPDATE_SLICE` elements is updated a
slice at a time (the update is elementwise, so the bits are the same):
its fp32 temporaries are a slice's size, and no whole parameter is ever
cast (a 202 048-row embedding, or a MoE layer's stacked experts, would
otherwise need several fp32 copies of itself at once).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.device import dtype_of

#: elements of a leaf that one pass of the update takes
UPDATE_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak LR; the scheduled value is passed
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"
    master_fp32: bool = True


def adamw_init(params: Sequence[torch.Tensor],
               cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments (and fp32 masters) for a list of parameter tensors."""
    mdt = dtype_of(cfg.moment_dtype)
    state: Dict[str, Any] = {
        "step": 0,
        "mu": [torch.zeros(p.shape, dtype=mdt, device=p.device)
               for p in params],
        "nu": [torch.zeros(p.shape, dtype=mdt, device=p.device)
               for p in params],
    }
    if cfg.master_fp32:
        state["master"] = [p.detach().float().clone() for p in params]
    return state


def _slices(leaf):
    """The leaf's tensors (g, mu, nu, p, master) cut into aligned flat
    slices of :data:`UPDATE_SLICE` elements (one for a small leaf).  Every
    tensor is contiguous, as ``init_params`` and autograd make them:
    ``view`` refuses another."""
    flat = [None if t is None else t.view(-1) for t in leaf]
    return [[None if t is None else t[lo:lo + UPDATE_SLICE] for t in flat]
            for lo in range(0, flat[3].numel(), UPDATE_SLICE)]


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], state: Dict[str, Any],
                 params: Sequence[torch.Tensor], cfg: AdamWConfig,
                 lr: float) -> Dict[str, Any]:
    """One AdamW step at the scheduled ``lr``, in place on ``params`` and
    ``state``; returns ``state``."""
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    c1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** step)
    c2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** step)
    mdt = dtype_of(cfg.moment_dtype)
    masters: List = state.get("master") or [None] * len(params)
    for leaf in zip(grads, state["mu"], state["nu"], params, masters):
        for g, mu, nu, p, master in _slices(leaf):
            gf = g.float()
            mu32 = mu.float() * b1 + gf * (1 - b1)
            nu32 = nu.float() * b2 + gf * gf * (1 - b2)
            base = master if master is not None else p.float()
            upd = (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.eps) \
                + cfg.weight_decay * base
            new_master = base - lr * upd
            p.copy_(new_master.to(p.dtype))
            mu.copy_(mu32.to(mdt))
            nu.copy_(nu32.to(mdt))
            if master is not None:
                master.copy_(new_master)
    state["step"] = step
    return state


__all__ = ["UPDATE_SLICE", "AdamWConfig", "adamw_init", "adamw_update"]
