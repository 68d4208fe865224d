"""Step builders: the single-device serving steps, and the TP train step
over the fused collective-matmul ring.

Serving: what ``repro.dist.steps``'s serve/slot-write/block-write builders
mean on one GPU with no mesh and no jit.  The reference builds jitted,
sharded steps with donated caches; here each is a plain function that
updates the cache in place where the reference donated it.  The chunk
step (``build_prefill_chunk_step``) is ``models.prefill.prefill_chunk``
itself.

Training: :class:`TransportPolicy`, :class:`StepConfig`,
:func:`build_init` and :func:`build_train_step` for the path the
reference takes with ``TransportPolicy(tp="fused")`` on a ``(1, tp)``
mesh — every dense block's TP edges on the fused ring of
``kernels/cc_matmul``, the group standing in for the ``model`` axis.
Only that path is ported: a single microbatch, no data axis, tp ≥ 2 and
``tp="fused"``; the others raise, each naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.conduit import (
    ROADMAP_AUTO,
    ROADMAP_OVERLAP,
    Conduit,
    transports as conduit_transports,
)
from repro_torch.dist import sharding
from repro_torch.dist.loss import chunked_ce_loss
from repro_torch.models import artblock
from repro_torch.models import layers as L
from repro_torch.models.decode import decode_step
from repro_torch.models.model import init_params
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    warmup_cosine,
)

Params = Dict[str, Any]
Cache = Dict[str, Any]


def serve_step(cfg: ModelConfig, params: Params, cache: Cache,
               tokens: torch.Tensor) -> Tuple[Cache, torch.Tensor]:
    """One batched decode step, greedy-sampled on the device: returns the
    cache and the (B,) int32 next-token ids (``build_serve_step`` with
    ``sample=True``)."""
    cache, logits = decode_step(cfg, params, cache, tokens)
    return cache, torch.argmax(logits, dim=-1).to(torch.int32)


def slot_write(cache: Cache, slot_cache: Cache, i: int) -> Cache:
    """Write every leaf of a batch-1 cache into row ``i`` of the contiguous
    batched cache, in place (``build_slot_write_step``): the per-row
    bookkeeping ``pos``/``slot_pos`` carries the batch on axis 0, the
    (L, B, ...) layer stacks (``k``/``v``, ``ssm_state``/``conv_state``)
    on axis 1."""
    for name, leaf in cache.items():
        axis = 0 if name in ("pos", "slot_pos") else 1
        leaf.select(axis, i).copy_(slot_cache[name].select(axis, 0))
    return cache


def block_write(cache: Cache, bk: torch.Tensor, bv: torch.Tensor,
                dst: torch.Tensor, table_row: torch.Tensor,
                slot_pos_row: torch.Tensor, pos: torch.Tensor,
                i: int) -> Cache:
    """Push finished prefill blocks ``bk``/``bv`` (L, n, Hkv, blk, hd) into
    pool ids ``dst`` (n,) and install row ``i``'s block table and
    bookkeeping (``build_block_write_step``)."""
    dst = dst.long()
    cache["kp"][:, dst] = bk.to(cache["kp"].dtype)
    cache["vp"][:, dst] = bv.to(cache["vp"].dtype)
    cache["block_ids"][i] = table_row
    cache["slot_pos"][i] = slot_pos_row
    cache["pos"][i] = pos
    return cache


def park_row(cache: Cache, i: int) -> Cache:
    """Point row ``i``'s table at its own parking block and clear its
    bookkeeping, so a retired row's dead decode writes touch no live block."""
    cache["block_ids"][i] = i
    cache["slot_pos"][i] = -1
    cache["pos"][i] = 0
    return cache


# ---------------------------------------------------------------------------
# TP training over the fused ring
# ---------------------------------------------------------------------------

ROADMAP_SINGLE = ("ROADMAP queue 1 item 3 (training on one GPU: the dense "
                  "path needs a flash-attention backward kernel)")
ROADMAP_DATA = ("ROADMAP queue 1 item 7 (distributed steps: a data axis "
                "with gradient sync)")
ROADMAP_MICRO = ("ROADMAP queue 1 item 7 (distributed steps: microbatch "
                 "accumulation and gradient bucketing)")


@dataclasses.dataclass(frozen=True)
class TransportPolicy:
    """The TP traffic class of ``repro.dist.steps.TransportPolicy``: its
    ``tp`` transport, validated against the reference's transport names
    as the reference validates it, and the conduit's ``chunk_bytes``.  Of
    the TP values only ``fused`` is ported; the MoE and cross-pod classes
    come with the slices that run them."""

    tp: str = "xla"
    chunk_bytes: Optional[int] = None

    def __post_init__(self):
        valid = ("auto",) + conduit_transports("all_gather")
        if self.tp not in valid:
            raise ValueError(f"TransportPolicy.tp={self.tp!r} not in {valid}")

    def tp_conduit(self, group) -> Conduit:
        """The conduit handle the ART-TP schedules run over."""
        return Conduit(axis=group, transport=self.tp,
                       chunk_bytes=self.chunk_bytes)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The knobs of ``repro.dist.steps.StepConfig`` the train step reads."""

    microbatches: int = 1
    seq_chunk: int = 512             # CE streaming chunk (dist/loss.py)
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    master_fp32: bool = True
    transport: Optional[TransportPolicy] = None
    grad_bucket_bytes: Optional[int] = None
    z_loss: float = 1e-4

    def resolved_transport(self) -> TransportPolicy:
        return self.transport if self.transport is not None \
            else TransportPolicy()


def _adamw_config(scfg: StepConfig) -> AdamWConfig:
    return AdamWConfig(lr=scfg.peak_lr, weight_decay=scfg.weight_decay,
                       moment_dtype=scfg.moment_dtype,
                       master_fp32=scfg.master_fp32)


def _art_runner(cfg: ModelConfig, policy: TransportPolicy,
                group) -> Callable:
    """The dense-block runner with every TP collective a conduit schedule
    (``repro.dist.steps._art_runner``): the norms run on the local rows,
    K/V are projected on them with the replicated ``wk``/``wv`` (the
    reference's GSPMD einsum on the sequence-sharded input), and the two
    ART regions of ``models/artblock.py`` do the rest."""
    conduit = policy.tp_conduit(group)
    cd = L.cdtype(cfg)

    def runner(cfg_, lp, x, positions):
        attn_p, mlp_p = lp["attn"], lp["mlp"]
        a_in = L.rms_norm(lp["ln1"], x, cfg_.norm_eps)
        k_loc = a_in.to(cd) @ attn_p["wk"].to(cd)
        v_loc = a_in.to(cd) @ attn_p["wv"].to(cd)
        h = artblock.art_attention_part(
            cfg_, x, a_in, k_loc, v_loc, attn_p["wq"], attn_p["wo"],
            positions, conduit=conduit)
        m_in = L.rms_norm(lp["ln2"], h, cfg_.norm_eps)
        return artblock.art_mlp_part(
            cfg_, h, m_in, mlp_p["w_up"], mlp_p.get("w_gate"),
            mlp_p["w_down"], conduit=conduit)

    return runner


def _check_tp_path(cfg: ModelConfig, group, scfg: StepConfig,
                   data_axis: int) -> TransportPolicy:
    policy = scfg.resolved_transport()
    if group.size < 2:
        raise NotImplementedError(
            f"training at tp={group.size} is not ported: {ROADMAP_SINGLE}")
    if data_axis != 1:
        raise NotImplementedError(
            f"data axis {data_axis} is not ported: {ROADMAP_DATA}")
    if scfg.microbatches > 1:
        raise NotImplementedError(
            f"microbatches={scfg.microbatches} is not ported: "
            f"{ROADMAP_MICRO}")
    if scfg.grad_bucket_bytes:
        raise NotImplementedError(
            f"grad_bucket_bytes={scfg.grad_bucket_bytes} is not ported: "
            f"{ROADMAP_MICRO}")
    if policy.tp == "auto":
        raise NotImplementedError(
            f"TransportPolicy.tp='auto' is not ported: {ROADMAP_AUTO}")
    if policy.tp != "fused":
        raise NotImplementedError(
            f"TransportPolicy.tp={policy.tp!r} is not ported (only "
            f"'fused' is): {ROADMAP_OVERLAP}")
    if cfg.family != "dense" or not artblock.supports_art_tp(cfg,
                                                             group.size):
        raise ValueError(f"{cfg.name} cannot run the ART-TP block at "
                         f"tp={group.size}")
    return policy


def build_init(cfg: ModelConfig, group, scfg: StepConfig
               ) -> Callable[[int], Tuple[Dict[str, Any], Dict[str, Any]]]:
    """``init_fn(seed) -> (params, opt_state)`` on this rank's device:
    every leaf drawn as ``models.model.init_params(cfg, seed)`` draws it
    (so every rank and every group size sees the same full model), then
    cut to this rank's shard (``dist/sharding.py``) layer by layer."""
    def init_fn(seed: int = 0):
        params = init_params(
            cfg, seed, group.device,
            layer_fn=lambda layer: sharding.shard_tree(layer, group.rank,
                                                       group.size))
        return params, init_opt(params, scfg)

    return init_fn


def init_opt(params: Dict[str, Any], scfg: StepConfig) -> Dict[str, Any]:
    """AdamW state for a parameter shard (moments zero, fp32 masters)."""
    return adamw_init([t for _, t in sharding.leaves(params)],
                      _adamw_config(scfg))


def build_train_step(cfg: ModelConfig, group, scfg: StepConfig, *,
                     data_axis: int = 1) -> Callable:
    """``step_fn(params, opt, batch, step) -> (params, opt, metrics)`` for
    this rank of the TP group.

    ``batch`` is the global batch (tokens and labels (B, S), S a multiple
    of the group size), the same on every rank.  Per rank the step
    (1) embeds its sequence shard, rows ``r·S/tp + arange(S/tp)``;
    (2) runs the blocks through the ART runner; (3) applies the final norm
    and the chunked CE over its rows; (4) runs backward on its own loss;
    (5) sums the replicated leaves' gradients over the group; (6) clips by
    the global norm; (7) takes an AdamW step at ``warmup_cosine(step)``.
    Parameters and optimizer state are updated in place.  ``metrics``:
    the group's loss, ce, z_loss and token count, the pre-clip grad norm
    and the learning rate."""
    policy = _check_tp_path(cfg, group, scfg, data_axis)
    runner = _art_runner(cfg, policy, group)
    acfg = _adamw_config(scfg)
    tp, rank = group.size, group.rank

    def step_fn(params, opt, batch, step: int):
        tokens, labels = batch["tokens"], batch["labels"]
        s = tokens.shape[1]
        if s % tp:
            raise ValueError(f"sequence {s} does not split over {tp} ranks")
        s_loc = s // tp
        rows = slice(rank * s_loc, (rank + 1) * s_loc)
        local = {"tokens": tokens[:, rows].to(group.device),
                 "labels": labels[:, rows].to(group.device)}
        positions = torch.arange(s, device=group.device)
        paths, leaves = zip(*sharding.leaves(params))
        places = [sharding.placement(p) for p in paths]
        for t in leaves:
            t.requires_grad_(True)

        loss, metrics = chunked_ce_loss(
            cfg, params, local, seq_chunk=scfg.seq_chunk,
            z_loss=scfg.z_loss, group=group, positions=positions,
            runner=runner)
        loss.backward()

        grads: List[torch.Tensor] = []
        for t in leaves:
            grads.append(t.grad.float())
            t.grad = None
            t.requires_grad_(False)
        rep = [i for i, pl in enumerate(places) if pl == "rep"]
        flat = group.all_reduce(torch.cat([grads[i].reshape(-1)
                                           for i in rep]))
        off = 0
        for i in rep:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].view(grads[i].shape)
            off += n
        grads, grad_norm = clip_by_global_norm(
            grads, scfg.clip_norm, group=group,
            sharded=[pl != "rep" for pl in places])
        lr = warmup_cosine(step, peak_lr=scfg.peak_lr,
                           warmup_steps=scfg.warmup_steps,
                           total_steps=scfg.total_steps)
        adamw_update(grads, opt, leaves, acfg, lr)
        metrics = dict(metrics, grad_norm=grad_norm, lr=lr)
        return params, opt, metrics

    return step_fn
