"""AdamW over a list of parameter tensors (``repro.optim.adamw``).

Numerics are the reference's: fp32 moments by default, an fp32 master
copy of bf16 parameters, bias corrections from the step count, decoupled
weight decay on the master.  Unlike the reference's pure functions, the
update writes the parameters, moments and masters in place: at full
width a second copy of every optimizer leaf would not fit beside the
first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.device import dtype_of


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
    for g, mu, nu, p, master in zip(grads, state["mu"], state["nu"],
                                    params, masters):
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


__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]
