"""ART on tensor parallelism: the dense transformer block with every TP
collective a conduit schedule over the TP group (``repro.models.artblock``,
op for op).

Each rank holds its sequence shard of the residual.  The two manual
regions of the reference become two functions that run on every rank:

  column-parallel Q and up‖gate:  an all_gather-matmul edge (:func:`ag_edge`)
  row-parallel O and down:        a matmul-reduce_scatter edge (:func:`rs_edge`)
  K/V:                            projected on the local rows with the
                                  replicated ``wk``/``wv``, then gathered
                                  whole over the conduit (GQA: n_kv < tp)

RoPE is applied after the K/V gather, on the full sequence; each rank
attends with its ``n_heads / tp`` query heads against the K/V heads they
map to (``kv_idx = (my·hq_loc + arange(hq_loc)) // group``).  Attention
is ``layers.blockwise_attention`` (plain PyTorch; the reference's flash
kernel has no backward).  The RS outputs are cast back to the residual's
dtype.

At each edge the conduit's ``matmul_schedule`` picks the family from
the edge's global bytes and its modeled matmul time (:func:`_edge_cost`):
``fused`` runs the kernels' rings (``kernels/cc_matmul``), ``ring`` or
``bidir`` the overlap schedules of ``core/overlap.py``; ``auto`` prices
the three.  Every family gives the same values to rounding.
:data:`EDGE_CALLS` counts the edges a family took.

Constraints: n_heads % tp == 0, d_ff % tp == 0, d_model % tp == 0,
S % tp == 0 (sequence-sharded residual).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import netmodel as nm
from repro_torch.core import overlap
from repro_torch.core.conduit import Conduit
from repro_torch.kernels.cc_matmul import (
    allgather_matmul_fused,
    matmul_reducescatter_fused,
)
from repro_torch.models import layers as L

Params = Dict[str, Any]

#: the edges this process ran since it was last cleared, by (op, global
#: bytes, modeled seconds, family, bidirectional): what ``auto`` decided
#: at each edge shape, and the schedule's permute count
EDGE_CALLS: Counter = Counter()


def supports_art_tp(cfg: ModelConfig, tp: int) -> bool:
    if cfg.family not in ("dense", "vlm") or cfg.attn_type == "mla":
        return False
    if cfg.n_heads % tp != 0:
        return False
    if cfg.d_ff % tp != 0 or cfg.d_model % tp != 0:
        return False
    return True


def _edge_cost(op: str, x: torch.Tensor, w: torch.Tensor,
               conduit: Conduit) -> Tuple[int, float]:
    """(global payload bytes, modeled matmul seconds) of one TP edge, the
    reference's ``_edge_cost`` with the card's dense bf16 rate
    (``netmodel.DENSE_BF16_FLOPS``): what ``matmul_schedule`` prices."""
    n = conduit.axis.size
    item = x.element_size()
    b, s = x.shape[0], x.shape[-2]
    k, m = w.shape
    if op == "all_gather":
        size = x.numel() * item * n
        flops = 2.0 * b * (s * n) * k * m
    else:
        size = b * s * m * item
        flops = 2.0 * b * s * k * m
    return size, flops / nm.DENSE_BF16_FLOPS


def _edge(op: str, x: torch.Tensor, w: torch.Tensor,
          conduit: Conduit) -> torch.Tensor:
    """One TP edge on the family ``matmul_schedule`` picks, the direction
    ``matmul_bidirectional`` picks on that family's payload."""
    size, tc = _edge_cost(op, x, w, conduit)
    family = conduit.matmul_schedule(op, size, tc)
    fused = family == "fused"
    bidir = conduit.matmul_bidirectional(
        size if fused else overlap.payload_bytes(op, x, w, conduit.axis.size))
    # counted before the call: a remat recompute may stop in the middle of
    # it (at the op's saved tensors), after its wire has run
    EDGE_CALLS[(op, size, tc, family, bidir)] += 1
    gather = op == "all_gather"
    if fused:
        fn = allgather_matmul_fused if gather else matmul_reducescatter_fused
        return fn(x, w, conduit.axis, bidirectional=bidir)
    fn = overlap.allgather_matmul if gather else overlap.matmul_reducescatter
    return fn(x, w, axis=conduit.axis, bidirectional=bidir)


def ag_edge(x: torch.Tensor, w: torch.Tensor,
            conduit: Conduit) -> torch.Tensor:
    """One AG edge, ``all_gather(x) @ w`` over the conduit's group: x (B,
    b, K) local rows, w (K, N_loc) → (B, n·b, N_loc) fp32 (the blocks'
    q and up‖gate edges, and the vocab-parallel LM head's)."""
    return _edge("all_gather", x, w, conduit)


def rs_edge(x: torch.Tensor, w: torch.Tensor,
            conduit: Conduit) -> torch.Tensor:
    """One RS edge, ``reduce_scatter(x @ w)`` over the conduit's group."""
    return _edge("reduce_scatter", x, w, conduit)


def art_attention_part(cfg: ModelConfig, x: torch.Tensor,
                       a_in: torch.Tensor, k_shard: torch.Tensor,
                       v_shard: torch.Tensor, wq: torch.Tensor,
                       wo: torch.Tensor, positions: torch.Tensor, *,
                       conduit: Conduit) -> torch.Tensor:
    """Q via the AG edge, local-head attention, O via the RS edge.

    x, a_in: (B, S/tp, D) local rows; k_shard/v_shard: (B, S/tp, n_kv·hd);
    wq: (D, hq_loc·hd) column shard; wo: (hq_loc·hd, D) row shard;
    positions: (S,) of the full sequence."""
    group = conduit.axis
    tp, my = group.size, group.rank
    cd = L.cdtype(cfg)
    hd = cfg.resolved_head_dim
    hq_loc = cfg.n_heads // tp
    b = x.shape[0]

    q = ag_edge(a_in.to(cd), wq.to(cd), conduit)        # (B, S, nq) fp32
    s_full = q.shape[1]
    q = q.reshape(b, s_full, hq_loc, hd).transpose(1, 2)

    # gasnet-style K/V broadcast: gather the sequence-sharded K/V over the
    # policy's conduit
    k = conduit.all_gather(k_shard.to(cd), dim=1)
    v = conduit.all_gather(v_shard.to(cd), dim=1)
    n_kv = k.shape[-1] // hd
    k = k.reshape(b, s_full, n_kv, hd).transpose(1, 2)
    v = v.reshape(b, s_full, n_kv, hd).transpose(1, 2)

    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)

    group_size = cfg.n_heads // cfg.n_kv_heads
    q_global = my * hq_loc + torch.arange(hq_loc, device=x.device)
    kv_idx = q_global // group_size
    k_sel = k.index_select(1, kv_idx)                    # (B, hq_loc, S, hd)
    v_sel = v.index_select(1, kv_idx)

    out = L.blockwise_attention(
        q, k_sel, v_sel, causal=True, window=cfg.window,
        q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
        causal_skip=cfg.causal_block_skip)
    out = out.transpose(1, 2).reshape(b, s_full, hq_loc * hd)
    return x + rs_edge(out, wo.to(cd), conduit).to(x.dtype)


def art_mlp_part(cfg: ModelConfig, h: torch.Tensor, m_in: torch.Tensor,
                 w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
                 w_down: torch.Tensor, *, conduit: Conduit) -> torch.Tensor:
    """Gated MLP with the AG/RS rings; up‖gate ride one AG edge.
    h, m_in: (B, S/tp, D) local rows."""
    cd = L.cdtype(cfg)
    m_in = m_in.to(cd)
    w_up = w_up.to(cd)
    if w_gate is not None:
        up_cat = ag_edge(m_in, torch.cat([w_up, w_gate.to(cd)], dim=1),
                          conduit)
        f_loc = w_up.shape[1]
        act = L._act(cfg.activation, up_cat[..., f_loc:]) \
            * up_cat[..., :f_loc]
    else:
        act = L._act(cfg.activation, ag_edge(m_in, w_up, conduit))
    return h + rs_edge(act, w_down.to(cd), conduit).to(h.dtype)


__all__ = ["EDGE_CALLS", "ag_edge", "art_attention_part", "art_mlp_part",
           "rs_edge", "supports_art_tp"]
