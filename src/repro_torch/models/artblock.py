"""ART on tensor parallelism: the dense transformer block with every TP
collective a conduit schedule over the TP group (``repro.models.artblock``,
op for op).

Each rank holds its sequence shard of the residual.  The two manual
regions of the reference become two functions that run on every rank:

  column-parallel Q and up‖gate:  a fused all_gather-matmul over the
                                  conduit (``kernels/cc_matmul``)
  row-parallel O and down:        a fused matmul-reduce_scatter
  K/V:                            projected on the local rows with the
                                  replicated ``wk``/``wv``, then
                                  ring-gathered whole (GQA: n_kv < tp)

RoPE is applied after the K/V gather, on the full sequence; each rank
attends with its ``n_heads / tp`` query heads against the K/V heads they
map to (``kv_idx = (my·hq_loc + arange(hq_loc)) // group``).  Attention
is ``layers.blockwise_attention`` (plain PyTorch; the reference's flash
kernel has no backward).  The RS outputs are cast back to the residual's
dtype.

Only the ``fused`` schedule family is ported: a conduit whose
``matmul_schedule`` names ``ring`` or ``bidir`` (the XLA-level overlap
schedules of ``core/overlap.py``) raises ``NotImplementedError``.

Constraints: n_heads % tp == 0, d_ff % tp == 0, d_model % tp == 0,
S % tp == 0 (sequence-sharded residual).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.conduit import ROADMAP_OVERLAP, Conduit
from repro_torch.kernels.cc_matmul import (
    allgather_matmul_fused,
    matmul_reducescatter_fused,
)
from repro_torch.models import layers as L

Params = Dict[str, Any]


def supports_art_tp(cfg: ModelConfig, tp: int) -> bool:
    if cfg.family not in ("dense", "vlm") or cfg.attn_type == "mla":
        return False
    if cfg.n_heads % tp != 0:
        return False
    if cfg.d_ff % tp != 0 or cfg.d_model % tp != 0:
        return False
    return True


def _edge_bytes(op: str, x: torch.Tensor, w: torch.Tensor,
                conduit: Conduit) -> int:
    """The global payload bytes of one TP edge (``_edge_cost``'s first
    half: its modeled matmul time prices only the ``auto`` schedule,
    which is not ported), what ``matmul_bidirectional`` decides on."""
    if op == "all_gather":
        return x.numel() * x.element_size() * conduit.axis.size
    return x.shape[0] * x.shape[-2] * w.shape[1] * x.element_size()


def ag_edge(x: torch.Tensor, w: torch.Tensor,
            conduit: Conduit) -> torch.Tensor:
    """One AG edge, ``all_gather(x) @ w`` over the conduit's group: x (B,
    b, K) local rows, w (K, N_loc) → (B, n·b, N_loc) fp32 (the blocks'
    q and up‖gate edges, and the vocab-parallel LM head's)."""
    size = _edge_bytes("all_gather", x, w, conduit)
    if conduit.matmul_schedule("all_gather") == "fused":
        return allgather_matmul_fused(
            x, w, conduit.axis,
            bidirectional=conduit.matmul_bidirectional(size))
    raise NotImplementedError(
        f"the {conduit.transport!r} all_gather-matmul schedule is not "
        f"ported yet: {ROADMAP_OVERLAP}")


def rs_edge(x: torch.Tensor, w: torch.Tensor,
            conduit: Conduit) -> torch.Tensor:
    """One RS edge, ``reduce_scatter(x @ w)`` over the conduit's group."""
    size = _edge_bytes("reduce_scatter", x, w, conduit)
    if conduit.matmul_schedule("reduce_scatter") == "fused":
        return matmul_reducescatter_fused(
            x, w, conduit.axis,
            bidirectional=conduit.matmul_bidirectional(size))
    raise NotImplementedError(
        f"the {conduit.transport!r} matmul-reduce_scatter schedule is not "
        f"ported yet: {ROADMAP_OVERLAP}")


def art_attention_part(cfg: ModelConfig, x: torch.Tensor,
                       a_in: torch.Tensor, k_shard: torch.Tensor,
                       v_shard: torch.Tensor, wq: torch.Tensor,
                       wo: torch.Tensor, positions: torch.Tensor, *,
                       conduit: Conduit) -> torch.Tensor:
    """Q via the fused AG ring, local-head attention, O via the fused RS
    ring.

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

    # gasnet-style K/V broadcast: ring-gather the sequence-sharded K/V
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


__all__ = ["ag_edge", "art_attention_part", "art_mlp_part", "rs_edge",
           "supports_art_tp"]
