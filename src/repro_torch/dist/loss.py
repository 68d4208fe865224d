"""Sequence-chunked cross-entropy over a grid's parts of the global batch
(``repro.dist.loss.chunked_ce_loss``).

Each rank streams the LM head over its own part (its rows, and on a
model line its sequence shard of them) in chunks of ``seq_chunk`` and
reduces each chunk's (B, C, V) logits to three partial sums: masked NLL,
masked squared-logsumexp (z-loss) and the token count.  The sums' group
(``group``: the whole world of a grid, data and model or expert lines
alike) all-reduces them with no gradient, so the token count is the
global batch's however the masked labels fall between the ranks; each
rank divides its own sums by it.  That rank-local loss is what backward
runs on: the ranks' losses sum to the reference's loss, and the TP
collectives' backward combines the ranks' cotangents on the model line
the sequence is split over (the block runner's group, not this one), so
no all-reduce sits inside autograd (one there would multiply the
gradients by the group size).  The loss reported in the metrics is the
all-reduced value.

A MoE model's load-balancing term follows the same rule: with a group,
each MoE layer returns this rank's share of the loss over the group's
rows (``layers.moe_aux_loss``, its choice counts and row count summed
over the group), so the shares, like the cross-entropy partials, sum to
the reference's term over the logical global batch: the reference's
GSPMD loss takes f and p as means over every row of the mesh, and a
product of per-rank means is not the global one.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import forward_hidden


def chunked_ce_loss(
    cfg: ModelConfig,
    params,
    batch: Dict[str, torch.Tensor],
    *,
    seq_chunk: int,
    z_loss: float = 1e-4,
    moe_aux_weight: float = 1e-2,
    group=None,
    positions: Optional[torch.Tensor] = None,
    runner: Optional[Callable] = None,
    core: Optional[Callable] = None,
    moe_ffn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, float]]:
    """batch: tokens (B, S_loc), labels (B, S_loc) with -1 = masked — this
    rank's rows — and a frontend arch's ``frontend_embeds`` (a VLM's
    patches, whose hidden rows are cropped away before the head; the
    encoder-decoder's frames).  Returns (this rank's loss, metrics), where
    the metrics' ``loss``, ``ce``, ``z_loss``, ``moe_aux`` and ``tokens``
    are the group's totals (the reference's ``total`` and metrics: the
    loss adds ``moe_aux_weight`` × a MoE model's load-balancing loss,
    summed over its layers).  ``group`` is the group the sums span (every
    rank holding a part of the global batch); None means one rank holding
    all of it.  ``positions``, ``runner`` (the TP block runner),
    ``core`` (the attention core) and ``moe_ffn`` (the expert-parallel
    MoE runner) are ``forward_hidden``'s; the load-balancing loss is over
    the group's rows (``aux_group``)."""
    hidden, aux = forward_hidden(cfg, params, batch["tokens"], positions,
                                 runner=runner, core=core,
                                 frontend_embeds=batch.get("frontend_embeds"),
                                 return_aux=True, moe_ffn=moe_ffn,
                                 aux_group=group)
    labels = batch["labels"]
    if hidden.shape[1] != labels.shape[1]:      # a VLM's patch rows
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    cd = L.cdtype(cfg)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cd)

    s = labels.shape[1]
    chunk = max(int(seq_chunk), 1)
    nll_sum = hidden.new_zeros((), dtype=torch.float32)
    z_sum = hidden.new_zeros((), dtype=torch.float32)
    tokens = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, s, chunk):
        h_c = hidden[:, start:start + chunk]
        lab = labels[:, start:start + chunk]
        logits = (h_c.to(cd) @ head).float()
        mask = (lab >= 0).float()
        safe = lab.clamp_min(0)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, safe[..., None])[..., 0]
        nll_sum = nll_sum + ((lse - gold) * mask).sum()
        z_sum = z_sum + ((lse * mask) ** 2).sum()
        tokens = tokens + mask.sum()

    sums = torch.stack([nll_sum, z_sum, tokens, aux]).detach().double().cpu()
    if group is not None:
        sums = group.all_reduce(sums)
    nll_all, z_all, tok_all, aux_all = sums.tolist()
    denom = max(tok_all, 1.0)
    loss = nll_sum / denom + z_loss * z_sum / denom + moe_aux_weight * aux
    ce, zl = nll_all / denom, z_loss * z_all / denom
    metrics = {"loss": ce + zl + moe_aux_weight * aux_all, "ce": ce,
               "z_loss": zl, "moe_aux": aux_all, "tokens": tok_all}
    return loss, metrics


__all__ = ["chunked_ce_loss"]
