"""Expert-parallel MoE dispatch over the conduit ``all_to_all``
(``repro.models.moe_ep``).

The experts are split over a group (the ``expert`` axis: rank q holds
experts ``[q·E/n, (q+1)·E/n)``), and tokens travel to their experts
through the conduit registry, the FSHMEM claim (one-sided schedules
carrying an application's traffic) applied to MoE routing.  Each rank
holds its own rows of the batch, not a slice of a GSPMD region; per
layer it:

1. top-k routes its rows with the dense path's per-row capacity
   bookkeeping (``layers.moe_route`` / ``layers.moe_dispatch``: shared
   code, so slots and capacity drops are token for token the dense
   layer's);
2. buckets the (b, E, cap, D) dispatch buffer by the rank that holds each
   expert, ``(n, E/n, b, cap, D)``, and exchanges it with
   ``Conduit.all_to_all`` (``xla`` | ``ring`` | ``bidir`` | ``auto``,
   honouring ``chunk_bytes``);
3. applies its E/n experts (``layers._expert_ffn``) to every arriving
   bucket;
4. sends the results home by the same exchange and mixes them by router
   weight (``layers.moe_combine``): a choice past capacity contributes
   zero and falls through on the block's residual, as in the dense layer.

The exchange is differentiable (``core/conduit.py``: its backward is the
same transport's all-to-all of the cotangent), so a rank's expert shard
collects the gradient of every rank's tokens, and the replicated leaves'
gradients are summed over the group by the train step.

Steps 2–4 can run **streamed** (``stream_chunks`` > 1): the dispatch
buffer splits into ART chunks along the source-row dim and rides
``Conduit.streamed``, so the experts' work on chunk k−1, and its exchange
home, run while chunk k is in flight.  Chunks cut disjoint rows through
the same schedule, so the result is bit-identical to the bulk exchange.

The reference falls back to the dense layer for a batch that does not
divide the mesh.  Here a rank holds E/n experts, so there is no dense
layer to fall back to: the callers that split the global batch over the
group (``dist/steps.py``, ``dist/rank_tasks.py``) refuse such a batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import pipeline as pl
from repro_torch.core.conduit import Conduit
from repro_torch.models import layers as L


def supports_moe_ep(cfg: ModelConfig, group) -> bool:
    """Whether ``cfg`` can split its experts over ``group``: a MoE config
    whose expert count a group of more than one rank divides."""
    n = group.size
    return n > 1 and bool(cfg.n_experts) and cfg.n_experts % n == 0


def moe_ep_ffn(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor,
               w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
               w_down: torch.Tensor, *, conduit: Conduit,
               stream_chunks: Optional[int] = None) -> torch.Tensor:
    """The routed MoE FFN of this rank's rows.

    ``x``: the rank's (b, S, D) rows; ``router``: the whole (D, E) router;
    ``w_up``/``w_gate``/``w_down``: this rank's expert shard, leading dim
    E/n.  Returns (b, S, D) in the compute dtype; the shared expert is
    added outside.  ``stream_chunks`` > 1 streams the exchange (clamped
    to b chunks), bit-identical to the bulk one."""
    n = conduit.axis.size
    e = cfg.n_experts
    e_loc = e // n
    xc = x.to(L.cdtype(cfg))
    b, _, d = xc.shape

    weights, _, keep, dst, cap = L.moe_route(cfg, router, xc)
    xe = L.moe_dispatch(xc, dst, keep, e, cap)             # (b, E, cap, D)
    # bucket by the rank that holds each expert: expert q·e_loc + j on q
    send = xe.transpose(0, 1).reshape(n, e_loc, b, cap, d)

    p_loc = {"w_up": w_up, "w_down": w_down}
    if w_gate is not None:
        p_loc["w_gate"] = w_gate

    def ffn_home(recv: torch.Tensor) -> torch.Tensor:
        # (n, e_loc, b_k, cap, D): the leading (source rank, source row)
        # batch the experts' products as the dense layer's (b,) does
        ye = L._expert_ffn(cfg, p_loc, recv.transpose(1, 2))
        return conduit.all_to_all(ye.transpose(1, 2).contiguous())

    c = max(1, min(int(stream_chunks or 1), b))
    if c == 1:
        back = ffn_home(conduit.all_to_all(send))   # slot q: from rank q
    else:
        backs = conduit.streamed(
            "all_to_all", [t.contiguous() for t in pl.split(send, c, axis=2)],
            work=lambda k, recv: ffn_home(recv))
        back = torch.cat(backs, dim=2)

    ye_full = back.reshape(e, b, cap, d).transpose(0, 1)
    return L.moe_combine(ye_full, dst, keep, weights)


def build_moe_ep_runner(cfg: ModelConfig, group, *, transport: str,
                        chunk_bytes: Optional[int] = None,
                        stream_chunks: Optional[int] = None,
                        decode: bool = False) -> Optional[Callable]:
    """The MoE-layer runner that dispatches over the conduit:
    ``runner(cfg, moe_params, x) -> y``, the expert-parallel stand-in for
    ``layers.moe`` on this rank's rows (``moe_params`` holds this rank's
    expert shard), or None when ``cfg`` cannot split its experts over
    ``group``.

    ``decode=True`` is the latency-mode EP decode: ``x`` is the rank's
    (b, 1, D) decode tokens, one a row, so the capacity is one slot a
    routed expert and nothing drops; the layer computes what the
    dense-combine decode computes.  ``stream_chunks`` streams the
    exchange (:func:`moe_ep_ffn`).  The shared expert runs outside the
    exchange, on the rank's rows."""
    if not supports_moe_ep(cfg, group):
        return None
    conduit = Conduit(axis=group, transport=transport,
                      chunk_bytes=chunk_bytes)

    def runner(cfg_: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
        if decode and x.shape[1] != 1:
            raise ValueError(f"the EP decode runner takes one token a row, "
                             f"got {tuple(x.shape)}")
        y = moe_ep_ffn(cfg_, x, p["router"], p["w_up"], p.get("w_gate"),
                       p["w_down"], conduit=conduit,
                       stream_chunks=stream_chunks)
        if cfg_.n_shared_experts:
            y = y + L.mlp(cfg_, p["shared"], x.to(L.cdtype(cfg_)))
        return y.to(x.dtype)

    return runner


__all__ = ["build_moe_ep_runner", "moe_ep_ffn", "supports_moe_ep"]
