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

On a model line whose vocab splits (``vocab``, ``models/vocab_parallel.py``)
the head is the AG ring edge over the rank's vocab columns: chunk c is
``seq_chunk / n`` local rows of every rank, whose gathered ``seq_chunk``
rows' logits a rank forms over its V/n columns in the compute dtype (the
reference's rounding point: the edge's fp32 output rounded to it) and
then in fp32.  Per token each rank has the log-sum-exp of its columns
and, on the rank that holds the label's id, the gold logit; one
all-gather over the line (no gradient) gives every rank every rank's, so
every rank holds the same per-token log-sum-exp (the ranks' combined)
and CE for the line's tokens.  Each token counts once in the sums
``group`` all-reduces: on the rank whose sequence shard holds it, so the
metrics and the token count stay the reference's.  Backward needs more
than that share: each rank's columns need (softmax − one-hot) × the
token's weight for every token of the line, and the AG edge's backward
(the fused RS ring) then sums the ranks' dh.  So a rank runs backward on
``Σ_t w_t (lse_t − gold_t)`` (and the z-term) over the line's tokens,
its log-sum-exp taken with the other ranks' terms held constant and its
gold term its own (zero where it does not hold the label): that
function's gradient on this rank's logits is exactly the loss's; its
value is replaced by the rank's share, which is what the step reports.
Neither an all-reduce inside autograd nor a 1/n share on each rank
gives these gradients.  On the ``xla`` path the chunk's rows are
gathered by gloo's ``all_gather`` and multiplied, in the compute dtype.

A model line's layout is its ``SeqLine`` (``models/tp_block.py``).  Where
its residual is whole on every rank (no sequence parallelism, or a length
the line does not divide), nothing is gathered: with the vocab split each
rank forms every row's logits over its columns and counts the tokens of
its cut of the sequence (``SeqLine.share``); with the head whole each
rank takes its cut's rows alone.  Each token still counts once, and the
hidden's cotangent on each rank is its part of the whole one, which the
line's all-reduce in the blocks' backward sums.

A MoE model's load-balancing term follows the same rule: with a group,
each MoE layer returns this rank's share of the loss over the group's
rows (``layers.moe_aux_loss``, its choice counts and row count summed
over the group), so the shares, like the cross-entropy partials, sum to
the reference's term over the logical global batch: the reference's
GSPMD loss takes f and p as means over every row of the mesh, and a
product of per-rank means is not the global one.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import forward_hidden
from repro_torch.models.tp_block import SeqLine


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
    line: Optional[SeqLine] = None,
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
    the group's rows (``aux_group``).  ``line`` (a model line's layout,
    ``models/tp_block.py`` ``SeqLine``: whether its residual is
    sequence-sharded, its vocab split) embeds through the line and
    takes the head over it: tokens and labels are then the line's whole
    sequence (B, S) of the rank's rows, the hidden this rank's rows of
    it, and a VLM's patch rows get masked labels in place of the crop."""
    fe = batch.get("frontend_embeds")
    hidden, aux = forward_hidden(
        cfg, params, batch["tokens"], positions, runner=runner, core=core,
        frontend_embeds=fe, return_aux=True, moe_ffn=moe_ffn,
        aux_group=group,
        embed=None if line is None else functools.partial(line.embed, cfg))
    labels = batch["labels"]
    if line is not None:
        if cfg.family == "vlm":
            labels = torch.cat([labels.new_full(fe.shape[:2], -1), labels],
                               dim=1)
    elif hidden.shape[1] != labels.shape[1]:
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]  # VLM patches
    return head_loss(cfg, params, hidden, labels, aux, seq_chunk=seq_chunk,
                     z_loss=z_loss, moe_aux_weight=moe_aux_weight,
                     group=group, line=line)


def head_loss(cfg: ModelConfig, params, hidden: torch.Tensor,
              labels: torch.Tensor, aux: torch.Tensor, *, seq_chunk: int,
              z_loss: float = 1e-4, moe_aux_weight: float = 1e-2,
              group=None, line: Optional[SeqLine] = None
              ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """:func:`chunked_ce_loss` from the final-norm hidden on: ``hidden``
    (B, S_loc, D) this rank's rows, ``labels`` theirs (with ``line``:
    the line's whole sequence (B, S) of them), ``aux`` the rank's
    load-balancing share.  On a line without the vocab split a rank
    counts the tokens of :meth:`SeqLine.share` with the whole head."""
    if line is None or line.vocab is None:
        if line is not None:
            own = line.share(labels.shape[1])
            labels = labels[:, own]
            if not line.sp:
                hidden = hidden[:, own]
        nll_sum, z_sum, tokens = _chunk_sums(cfg, params, hidden, labels,
                                             seq_chunk)
        surrogate = None
    else:
        nll_sum, z_sum, tokens, surrogate = _vocab_parallel_sums(
            cfg, params, hidden, labels, seq_chunk, line)
    sums = torch.stack([nll_sum, z_sum, tokens, aux]).detach().double().cpu()
    if group is not None:
        sums = group.all_reduce(sums)
    nll_all, z_all, tok_all, aux_all = sums.tolist()
    denom = max(tok_all, 1.0)
    loss = nll_sum / denom + z_loss * z_sum / denom + moe_aux_weight * aux
    if surrogate is not None:
        # the share's value (no gradient), the line's gradient
        g = surrogate(denom, z_loss)
        loss = loss + (g - g.detach())
    ce, zl = nll_all / denom, z_loss * z_all / denom
    metrics = {"loss": ce + zl + moe_aux_weight * aux_all, "ce": ce,
               "z_loss": zl, "moe_aux": aux_all, "tokens": tok_all}
    return loss, metrics


def _chunk_sums(cfg: ModelConfig, params, hidden: torch.Tensor,
                labels: torch.Tensor, seq_chunk: int):
    """(Masked NLL, masked lse², tokens) over this rank's rows, the head
    whole (the reference's chunk loop)."""
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
    return nll_sum, z_sum, tokens


def _vocab_parallel_sums(cfg: ModelConfig, params, hidden: torch.Tensor,
                         labels: torch.Tensor, seq_chunk: int,
                         line: SeqLine):
    """The vocab-parallel head over the line's chunks: (masked NLL,
    masked lse², tokens) of the tokens this rank counts, and
    ``surrogate(denom, z_loss)``, the function whose gradient backward
    takes (the module docstring).  On a sequence-sharded line a chunk is
    ``seq_chunk / n`` local rows of every rank, gathered; with the
    residual whole on every rank a chunk is ``seq_chunk`` rows of it, no
    gather, and the rank counts the tokens of its :meth:`SeqLine.share`."""
    cd = L.cdtype(cfg)
    vocab = line.vocab
    n, r = vocab.size, vocab.rank
    head = (params["embed"].t() if cfg.tie_embeddings
            else params["lm_head"]).to(cd).contiguous()
    b, s_loc = hidden.shape[:2]
    if labels.shape[1] != (n * s_loc if line.sp else s_loc):
        raise ValueError(f"labels {tuple(labels.shape)}: expected the "
                         f"line's {n} × {s_loc} positions" if line.sp else
                         f"labels {tuple(labels.shape)}: expected {s_loc} "
                         f"positions")
    lses, golds, labs, mine = [], [], [], []

    def add(logits, lab, own_rows):
        idx, own = vocab.local_ids(lab)
        lses.append(torch.logsumexp(logits, dim=-1))
        golds.append(torch.where(
            own, logits.gather(-1, idx[..., None])[..., 0], 0.0))
        labs.append(lab)
        mine.append(own_rows)

    if line.sp:
        blocks = labels.reshape(b, n, s_loc)
        k = max(int(seq_chunk) // n, 1)
        for c0 in range(0, s_loc, k):
            rows = min(k, s_loc - c0)
            logits = vocab.logits(hidden[:, c0:c0 + rows].to(cd),
                                  head).to(cd).float()   # (B, n·rows, V/n)
            add(logits, blocks[:, :, c0:c0 + rows].reshape(b, n * rows),
                torch.arange(n, device=labels.device).repeat_interleave(
                    rows) == r)
    else:
        share = line.share(s_loc)
        k = max(int(seq_chunk), 1)
        for c0 in range(0, s_loc, k):
            pos = torch.arange(c0, min(c0 + k, s_loc), device=labels.device)
            logits = (hidden[:, c0:c0 + k].to(cd) @ head).to(cd).float()
            add(logits, labels[:, c0:c0 + k],
                (pos >= share.start) & (pos < share.stop))
    lse_r, gold_r = torch.cat(lses, 1), torch.cat(golds, 1)
    lab = torch.cat(labs, 1)
    mine = torch.cat(mine).expand_as(lab)
    every = vocab.conduit.axis.all_gather(
        torch.stack([lse_r, gold_r]).detach()[None], 0)   # (n, 2, B, T)
    # this rank's term live, the others' constants: the same bits on
    # every rank, the gradient through this rank's columns alone
    lse = torch.logsumexp(torch.cat([every[:r, 0], lse_r[None],
                                     every[r + 1:, 0]]), dim=0)
    gold = every[:, 1].sum(0)
    mask = (lab >= 0).float()
    lse_d = lse.detach()
    own_mask = mask * mine
    nll_sum = ((lse_d - gold) * own_mask).sum()
    z_sum = ((lse_d * mask) ** 2 * mine).sum()
    tokens = own_mask.sum()

    def surrogate(denom: float, z_loss: float) -> torch.Tensor:
        return (((lse - gold_r) * mask).sum()
                + z_loss * ((lse * mask) ** 2).sum()) / denom

    return nll_sum, z_sum, tokens, surrogate


__all__ = ["chunked_ce_loss", "head_loss"]
