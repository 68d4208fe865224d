"""Step builders: the single-device serving steps, and the train step
over a grid of ranks.

Serving: what ``repro.dist.steps``'s serve/slot-write/block-write builders
mean on one GPU with no mesh and no jit.  The reference builds jitted,
sharded steps with donated caches; here each is a plain function that
updates the cache in place where the reference donated it.  The chunk
step (``build_prefill_chunk_step``) is ``models.prefill.prefill_chunk``
itself.

Training: :class:`TransportPolicy`, :class:`StepConfig`,
:func:`build_init` and :func:`build_train_step` over a grid of ranks
(``launch/mesh.py``: ``data × model`` for a dense model, ``data ×
expert`` for a MoE model; a plain group is the ``1 × n`` grid).  On one
rank (``Group(rank=0, size=1, device=…)``, no process pool) it is the
reference's one-device step for every family the port serves: the
model's own blocks, every attention through
``layers.blockwise_attention`` (``layers.blockwise_core``), as the
reference attends off the TPU: the dense and VLM blocks, MLA's, the MoE
blocks (their expert products ``torch.bmm`` over the stacked weights,
the reference's ``TransportPolicy.moe="xla"``), the encoder-decoder's
encoder, self- and cross-attention, and the hybrid's shared
applications; the ssm (Mamba-2) block's SSD scan is the kernel with its
backward (``kernels/ssd``).  On a model line of tp ≥ 2 it is the path
the reference takes with ``TransportPolicy(tp=...)`` one of ``fused``,
``ring``, ``bidir`` or ``auto``: every dense block's TP edges on the
family the policy's conduit picks (``models/artblock.py``: the fused
rings of ``kernels/cc_matmul`` or the overlap schedules of
``core/overlap.py``), its K/V gathered over that conduit, and, where the
line divides the vocab, the vocab-parallel embedding and LM head
(``models/vocab_parallel.py``; the head another AG edge).  A MoE
model on an expert line of n ≥ 2 trains by expert parallelism over it
(the reference's ``models/moe_ep.py`` runner on an ``expert`` mesh
axis): rank r of the line holds experts ``[r·E/n, (r+1)·E/n)``, its
tokens ride the conduit all-to-all of ``TransportPolicy.moe`` to their
experts and back, and the replicated leaves' gradients are summed over
the line.  A data line of D ≥ 2 splits each microbatch's rows and
averages the gradients over the line (``dist/grad_sync.py``).  Every
path sums microbatch gradients in fp32, leaf by leaf, and lays the sums
out in flat buckets with ``grad_bucket_bytes``.  ``tp="xla"`` (and
``use_art=False``), the reference's GSPMD fallback, ``compress_cross_pod``
and the other families at tp ≥ 2 raise, each naming its ROADMAP item;
ART-TP is dense-only.

Serving over an expert group: :func:`serve_step` with the decode runner
of :func:`moe_decode_runner` (each rank decodes its own rows).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.conduit import (
    Conduit,
    transports as conduit_transports,
)
from repro_torch.dist import bucketing, grad_sync, sharding
from repro_torch.dist.group import Grid, as_grid
from repro_torch.dist.loss import chunked_ce_loss
from repro_torch.models import artblock
from repro_torch.models import layers as L
from repro_torch.models import moe_ep
from repro_torch.models.decode import decode_step
from repro_torch.models.model import init_params
from repro_torch.models.vocab_parallel import VocabParallel
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
               tokens: torch.Tensor, *,
               moe_runner: Optional[Any] = None, sample: bool = True
               ) -> Tuple[Cache, torch.Tensor]:
    """One batched decode step (``build_serve_step``): returns the cache
    and, greedy-sampled on the device, the (B,) int32 next-token ids, or
    with ``sample=False`` the (B, V) fp32 logits.  A MoE model decodes
    with every expert on every row, or by expert parallelism with
    ``moe_runner`` (:func:`moe_decode_runner`: the cache, tokens and ids
    are then this rank's rows)."""
    cache, logits = decode_step(cfg, params, cache, tokens,
                                moe_runner=moe_runner)
    if not sample:
        return cache, logits
    return cache, torch.argmax(logits, dim=-1).to(torch.int32)


def slot_write(cache: Cache, slot_cache: Cache, i: int) -> Cache:
    """Write every leaf of a batch-1 cache into row ``i`` of the contiguous
    batched cache, in place (``build_slot_write_step``): the per-row
    bookkeeping ``pos``/``slot_pos`` carries the batch on axis 0, the
    (L, B, ...) layer stacks (``k``/``v``, ``ssm_state``/``conv_state``,
    the hybrid's ``attn_k``/``attn_v`` a shared application) on axis 1."""
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
# training: tp 1, TP over the fused ring, EP, and a data axis
# ---------------------------------------------------------------------------

ROADMAP_COMPRESS = ("ROADMAP queue 1 item 7.8 (int8 compression of the "
                    "data axis inside the train step)")


@dataclasses.dataclass(frozen=True)
class TransportPolicy:
    """The traffic classes of ``repro.dist.steps.TransportPolicy``, each
    validated against the transports registered for the op it rides
    (``tp`` all_gather, ``moe`` all_to_all, ``cross_pod`` all_reduce) as
    the reference validates it, ``compress_cross_pod``, the conduit's
    ``chunk_bytes``, and ``moe_stream_chunks`` (the EP exchange split into
    that many ART chunks, bit-identical to bulk; None/1 bulk).

    ``tp`` is the TP edges' family (``fused``, ``ring``, ``bidir`` or
    ``auto``; ``xla``, the reference's GSPMD fallback, raises).  ``moe``
    names the transport of the expert exchange: ``ring``, ``bidir``,
    ``xla`` (the group's gloo all-to-all) or ``auto`` (priced a call).
    The port has no GSPMD, so where the reference's ``moe="xla"`` keeps
    every expert on every device, a MoE model on an expert line of n ≥ 2
    here always splits its experts, and ``xla`` is its exchange's
    transport (the reference holds ``auto`` ≡ ``xla`` ≡ ``ring`` in
    value).  ``cross_pod`` is the data axis's gradient all-reduce
    (``dist/grad_sync.py``; any transport or ``auto``).  ``compress_cross_pod``
    raises when a step is built: the reference's step does not wire it
    either (``repro/dist/grad_sync.py``'s scope note); the standalone
    ``grad_sync.cross_pod_all_reduce(compressed=True)`` takes it."""

    tp: str = "xla"
    moe: str = "xla"
    cross_pod: str = "ring"
    compress_cross_pod: bool = False
    chunk_bytes: Optional[int] = None
    moe_stream_chunks: Optional[int] = None

    def __post_init__(self):
        for cls, op in (("tp", "all_gather"), ("moe", "all_to_all"),
                        ("cross_pod", "all_reduce")):
            name = getattr(self, cls)
            valid = ("auto",) + conduit_transports(op)
            if name not in valid:
                raise ValueError(
                    f"TransportPolicy.{cls}={name!r} not in {valid}")

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
    moe_aux_weight: float = 1e-2

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


def param_places(cfg: ModelConfig, size: int,
                 axis: str = "model") -> Dict[Tuple, str]:
    """Every parameter leaf's placement on an inner line of ``size``
    ranks on ``axis``, by path: ``dist/sharding.py``'s rule on the
    logical leaves (their shapes from ``init_params`` on the ``meta``
    device: nothing drawn or allocated), which a shard alone does not
    give (whether ``embed``'s vocab was split)."""
    return {path: sharding.placement(path, axis, tuple(t.shape), size)
            for path, t in sharding.leaves(init_params(cfg, 0, "meta"))}


def _moe_runner(cfg: ModelConfig, group, policy: TransportPolicy,
                decode: bool = False) -> Callable:
    """The expert-parallel MoE runner of ``models/moe_ep.py`` over
    ``group`` on ``policy.moe`` (the reference's ``_moe_runner``, and with
    ``decode`` its ``_moe_decode_runner``); raises where the experts do
    not split over the group."""
    runner = moe_ep.build_moe_ep_runner(
        cfg, group, transport=policy.moe, chunk_bytes=policy.chunk_bytes,
        stream_chunks=None if decode else policy.moe_stream_chunks,
        decode=decode)
    if runner is None:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts do not split "
                         f"over {group.size} ranks")
    return runner


def moe_decode_runner(cfg: ModelConfig, group,
                      policy: TransportPolicy) -> Callable:
    """The latency-mode EP decode runner for :func:`serve_step` on this
    rank of ``group`` (``decode_step(moe_runner=)``): the rank's decode
    rows batched with the group's through ``policy.moe``'s all-to-all."""
    if cfg.family != "moe":
        raise ValueError(f"{cfg.name} is not a MoE model")
    return _moe_runner(cfg, group, policy, decode=True)


def split_rows(batch: int, group) -> slice:
    """This rank's rows ``[r·b, (r+1)·b)`` of a batch split over
    ``group`` (the data line, or every rank of an expert grid); a batch
    the group does not divide raises (a rank holds E/n experts, so no
    rank can run a leftover row by the dense layer, the reference's
    fallback)."""
    n = group.size
    if batch % n:
        raise ValueError(f"batch {batch} does not split over the {n} ranks "
                         f"of the group")
    b = batch // n
    return slice(group.rank * b, (group.rank + 1) * b)


def group_axis(cfg: ModelConfig) -> str:
    """The axis a group of ranks stands for: ``expert`` for a MoE model
    (its experts split over the group), ``model`` (TP) otherwise."""
    return "expert" if cfg.family == "moe" else "model"


def step_grid(cfg: ModelConfig, group) -> Grid:
    """``group`` as a grid: a :class:`~repro_torch.dist.group.Grid` as it
    is, a plain group as the ``1 × n`` grid of :func:`group_axis`."""
    return as_grid(group, group_axis(cfg))


def _check_path(cfg: ModelConfig, grid: Grid, scfg: StepConfig
                ) -> Tuple[Optional[Callable], Optional[Callable]]:
    """(The dense-block runner, the MoE runner) of this grid's train step
    — (None, None) when the inner line is one rank: the model's own
    blocks, attending through ``layers.blockwise_core`` — or the raise
    that names the ROADMAP item of a path not ported."""
    if scfg.microbatches < 1:
        raise ValueError(f"microbatches={scfg.microbatches} < 1")
    policy = scfg.resolved_transport()
    if policy.compress_cross_pod:
        raise NotImplementedError(
            "TransportPolicy.compress_cross_pod=True: the reference's train "
            "step does not wire int8 compression on the data axis either "
            "(repro/dist/grad_sync.py's scope note), so the port's does not "
            "take it; compress with dist.grad_sync.cross_pod_all_reduce("
            f"compressed=True): {ROADMAP_COMPRESS}")
    inner = grid.inner
    if inner.size == 1:
        return None, None
    if grid.inner_axis != group_axis(cfg):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on a {grid.inner_axis} axis of "
            f"{inner.size} is not ported (the port splits a MoE model's "
            f"experts, a dense model's blocks): ROADMAP queue 1 item 7.5 "
            f"(sharding rules)")
    if cfg.family == "moe":
        return None, _moe_runner(cfg, inner, policy)
    if cfg.attn_type == "mla":
        raise NotImplementedError(
            f"{cfg.name}: MLA training at tp {inner.size} is not ported "
            f"(the reference's _art_runner skips MLA; its TP split is the "
            f"sharding rules'): ROADMAP queue 1 item 7.5")
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} training at tp {inner.size} is not "
            f"ported (the sharding rules and the frontend's TP split): "
            f"ROADMAP queue 1 item 7.5")
    if cfg.family != "dense":
        raise ValueError(
            f"{cfg.name}: ART-TP is dense-only (the reference's _art_runner "
            f"runs the dense block); train the {cfg.family} family at tp 1")
    if policy.tp == "xla" or not cfg.use_art:
        raise NotImplementedError(
            f"TransportPolicy.tp={policy.tp!r} with use_art={cfg.use_art}: "
            f"the reference leaves TP to GSPMD there, whose sharding rules "
            f"are not ported: ROADMAP queue 1 item 7.5")
    if not artblock.supports_art_tp(cfg, inner.size):
        raise ValueError(f"{cfg.name} cannot run the ART-TP block at "
                         f"tp={inner.size}")
    return _art_runner(cfg, policy, inner), None


def build_init(cfg: ModelConfig, grid, scfg: StepConfig
               ) -> Callable[[int], Tuple[Dict[str, Any], Dict[str, Any]]]:
    """``init_fn(seed) -> (params, opt_state)`` on this rank's device:
    every leaf drawn as ``models.model.init_params(cfg, seed)`` draws it
    (so every rank and every grid sees the same full model), then, on an
    inner line of two or more ranks, cut to this rank's shard
    (``dist/sharding.py``, on the :func:`group_axis` placement) layer by
    layer, the embedding and head as soon as each is drawn.  Every data
    rank holds the same copy of its model line's shard."""
    grid = step_grid(cfg, grid)
    axis, inner = group_axis(cfg), grid.inner

    def init_fn(seed: int = 0):
        layer_fn = None if inner.size == 1 else (
            lambda layer: sharding.shard_tree(layer, inner.rank, inner.size,
                                              axis))
        params = init_params(cfg, seed, grid.device, layer_fn=layer_fn)
        return params, init_opt(params, scfg)

    return init_fn


def init_opt(params: Dict[str, Any], scfg: StepConfig) -> Dict[str, Any]:
    """AdamW state for a parameter shard (moments zero, fp32 masters)."""
    return adamw_init([t for _, t in sharding.leaves(params)],
                      _adamw_config(scfg))


def _microbatches(batch: Dict[str, torch.Tensor],
                  n_micro: int) -> List[Dict[str, torch.Tensor]]:
    """The batch's rows cut into ``n_micro`` consecutive microbatches (the
    reference's reshape to ``(n_micro, B / n_micro, ...)``)."""
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} "
                         f"microbatches")
    return [{k: v[i * (b // n_micro):(i + 1) * (b // n_micro)]
             for k, v in batch.items()} for i in range(n_micro)]


def build_train_step(cfg: ModelConfig, grid, scfg: StepConfig) -> Callable:
    """``step_fn(params, opt, batch, step) -> (params, opt, metrics)`` for
    this rank of ``grid`` (a :class:`~repro_torch.dist.group.Grid` of
    ``data × model`` or ``data × expert`` ranks, ``launch/mesh.py``; a
    plain group is the ``1 × n`` grid of :func:`group_axis`).

    ``batch`` is the global batch (tokens and labels (B, S); on a model
    line of tp ≥ 2 S a multiple of tp; B a multiple of microbatches × the
    ranks its rows split over; a frontend arch's ``frontend_embeds`` (B,
    N, frontend_dim) at tp 1), the same on every rank.  The step cuts it
    into ``scfg.microbatches`` microbatches, m taking rows ``[m·B/M,
    (m+1)·B/M)``, and each microbatch's rows over the data line (data
    rank d rows ``[d·b, (d+1)·b)``, as the reference's ``batch_pspecs``
    shards rows over its data axis), or on an expert grid over every rank
    in world order (the reference's EP region shards rows over every mesh
    axis).  For each microbatch it (1) embeds the rank's part: on a model
    line its rows' sequence shard, positions ``r·S/tp + arange(S/tp)``
    (where the line divides the vocab by the vocab-parallel embedding,
    ``models/vocab_parallel.py``: the rank looks up the line's whole
    sequence in its vocab rows and a reduce-scatter over the sequence
    leaves it its shard; else by the replicated lookup of its shard),
    else its rows whole (a VLM's patch rows before them); (2) runs the
    blocks, the dense ones through the ART-TP runner at tp ≥ 2, the MoE
    layers through the expert-parallel runner on an expert line, every
    attention through blockwise attention but the ART-TP block's;
    (3) applies the final norm and the chunked CE over its part, plus
    ``moe_aux_weight`` × a MoE model's load-balancing loss: the token
    count and the experts' choice counts are summed over the whole world,
    so each rank's loss is its share of the reference's global-batch
    loss, and the shares sum to it whatever the masked labels' spread (a
    vocab-parallel line takes the head as the AG ring edge over its vocab
    columns, each chunk's rows gathered over the line, and combines the
    ranks' log-sum-exps a token, ``dist/loss.py``: each token counts once
    in the sums, and each rank's backward covers the line's tokens on its
    columns);
    (4) runs backward on its share times the data extent D, and sums the
    gradients in fp32, leaf by leaf in place.  Then it divides the sums
    by the microbatch count (in the flat buckets of ``dist/bucketing.py``
    with ``grad_bucket_bytes``: the same bits), (5) on a data line of D ≥
    2 replaces each sum by its mean over the line through
    ``dist/grad_sync.py``'s exact path on ``policy.cross_pod`` (the
    buckets with ``grad_bucket_bytes``, else leaf by leaf): the mean of D
    × the shares is their sum, the gradient of the global loss.  With D
    a power of two (every grid the tests and the smoke run) the scaling
    by D and the division by it are exact, so they add no rounding; any
    other D (``launch/mesh.py`` takes one) rounds the scaled cotangent in
    every bf16 op of backward and the fp32 division, so the gradient is
    the global loss's to that rounding, not bit for bit (ROADMAP §3); (6) sums the replicated
    leaves' gradients over the inner line (``wk``/``wv`` and the norms;
    ``embed`` and ``lm_head`` too where the vocab does not split, else
    their shards' gradients are complete: the embedding's from its
    scatter, the head's from its edge's weight gradient; the all-reduce's
    bytes are ``step_fn.rep_wire``), (7) clips by the global norm
    over the inner line and (8) takes an AdamW step at
    ``warmup_cosine(step)``, the same on every data rank.  Parameters and
    optimizer state are the model line's shards, the same on every data
    rank (DDP over the data axis; the reference
    shards them over its data axis, ZeRO/FSDP: ROADMAP queue 1 item 7.5)
    and updated in place.  ``metrics``: the microbatches' mean loss, ce,
    z_loss and moe_aux and their summed token count (the world's), the
    pre-clip grad norm and the learning rate.

    ``step_fn.local_grads(params, batch)`` runs (1)–(4) alone and returns
    (this rank's fp32 gradients of D × its share, in ``dist.sharding.
    leaves`` order, divided by the microbatch count; the metrics): the
    per-rank gradients a data-axis sync takes."""
    grid = step_grid(cfg, grid)
    runner, moe_runner = _check_path(cfg, grid, scfg)
    core = None if runner is not None else L.blockwise_core(cfg)
    acfg = _adamw_config(scfg)
    policy = scfg.resolved_transport()
    inner, data, world = grid.inner, grid.data, grid.world
    tp, rank = inner.size, inner.rank
    n_data = data.size
    n_micro = int(scfg.microbatches)
    sum_group = world if world.size > 1 else None
    norm_group = inner if tp > 1 else None
    row_group = world if moe_runner is not None else data
    axis = group_axis(cfg)
    # the TP line shards the sequence; the data line and EP the rows
    seq_shards = tp if runner is not None else 1
    places = param_places(cfg, tp, axis) if tp > 1 else {}
    # the TP line's vocab split, where the placement rule makes one (else
    # the lookup and the head stay replicated)
    vocab = (VocabParallel(policy.tp_conduit(inner), cfg.vocab_size)
             if runner is not None and places.get(("embed",), "rep") != "rep"
             else None)
    #: the last step's `rep` all-reduce over the inner line: the payload
    #: bytes it carried and the bytes it staged through the host
    rep_wire = {"bytes": 0, "staged_bytes": 0}

    def micro_grads(params, leaves, micro, acc):
        """Backward of one microbatch, its gradients summed in fp32 into
        ``acc`` in place (leaf order; a ``None`` entry takes the cast of
        the first); returns its metrics.  Each leaf's gradient is freed as
        soon as it is added, so at full width no second list of gradients
        is held beside the sums."""
        tokens, labels = micro["tokens"], micro["labels"]
        s = tokens.shape[1]
        if s % seq_shards:
            raise ValueError(f"sequence {s} does not split over {tp} ranks")
        s_loc = s // seq_shards
        # the vocab-parallel embedding and head take the line's whole
        # sequence of the rank's rows
        cols = (slice(rank * s_loc, (rank + 1) * s_loc)
                if runner is not None and vocab is None else slice(None))
        rows = split_rows(tokens.shape[0], row_group)
        local = {"tokens": tokens[rows, cols].to(grid.device),
                 "labels": labels[rows, cols].to(grid.device)}
        if micro.get("frontend_embeds") is not None:
            local["frontend_embeds"] = micro["frontend_embeds"][rows].to(
                grid.device)
        # whole rows rope at their own index (a VLM's text after its
        # patch rows); the TP runner ropes the gathered sequence
        positions = (torch.arange(s, device=grid.device)
                     if runner is not None else None)
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, metrics = chunked_ce_loss(
                cfg, params, local, seq_chunk=scfg.seq_chunk,
                z_loss=scfg.z_loss, moe_aux_weight=scfg.moe_aux_weight,
                group=sum_group, positions=positions, runner=runner,
                core=core, moe_ffn=moe_runner, vocab=vocab)
            (loss * n_data if n_data > 1 else loss).backward()
            for i, t in enumerate(leaves):
                g, t.grad = t.grad, None
                if g is None:
                    continue
                if acc[i] is None:
                    acc[i] = g.float()
                else:
                    acc[i].add_(g)      # the fp32 sum of the cast
        finally:
            for t in leaves:
                t.grad = None
                t.requires_grad_(False)
        return metrics

    def local_grads(params, batch, bucketed: bool = False):
        paths, leaves = zip(*sharding.leaves(params))
        acc = [None] * len(leaves)
        mets = [micro_grads(params, leaves, mb, acc)
                for mb in _microbatches(batch, n_micro)]
        # a leaf the loss does not reach (a hybrid cut below one shared
        # application) has no gradient: zero, as the reference's
        grads = [torch.zeros_like(t, dtype=torch.float32) if a is None
                 else a for a, t in zip(acc, leaves)]
        del acc
        plan = None
        if bucketed:
            # the sums in flat buckets, the layout the data axis's sync
            # ships; per element the same fp32 sums and division, so the
            # same bits
            plan = bucketing.bucket_plan(
                list(leaves), target_bytes=scfg.grad_bucket_bytes)
            grads = bucketing.pack(grads, plan)
        if n_micro > 1:
            for g in grads:
                g.div_(n_micro)
        metrics = {k: (sum(m[k] for m in mets) if k == "tokens"
                       else sum(m[k] for m in mets) / n_micro)
                   for k in mets[0]}
        return paths, leaves, grads, plan, metrics

    def step_fn(params, opt, batch, step: int):
        bucketed = bool(scfg.grad_bucket_bytes) and (n_micro > 1
                                                     or n_data > 1)
        paths, leaves, grads, plan, metrics = local_grads(
            params, batch, bucketed)
        if n_data > 1:
            sync = grad_sync.mean_buckets if plan else grad_sync.mean_leaves
            grads = sync(grads, data, transport=policy.cross_pod,
                         chunk_bytes=policy.chunk_bytes)
        if plan is not None:
            grads = bucketing.unpack(grads, plan, torch.float32)

        sharded = None
        if tp > 1:
            rep = [i for i, p in enumerate(paths) if places[p] == "rep"]
            flat = torch.cat([grads[i].reshape(-1) for i in rep])
            staged0 = inner.stats["staged_bytes"]
            flat = inner.all_reduce(flat)
            rep_wire.update(bytes=flat.numel() * flat.element_size(),
                            staged_bytes=inner.stats["staged_bytes"]
                            - staged0)
            off = 0
            for i in rep:
                n = grads[i].numel()
                grads[i] = flat[off:off + n].view(grads[i].shape)
                off += n
            sharded = [places[p] != "rep" for p in paths]
        grads, grad_norm = clip_by_global_norm(
            grads, scfg.clip_norm, group=norm_group, sharded=sharded)
        lr = warmup_cosine(step, peak_lr=scfg.peak_lr,
                           warmup_steps=scfg.warmup_steps,
                           total_steps=scfg.total_steps)
        adamw_update(grads, opt, leaves, acfg, lr)
        metrics = dict(metrics, grad_norm=grad_norm, lr=lr)
        return params, opt, metrics

    def public_local_grads(params, batch):
        _, _, grads, _, metrics = local_grads(params, batch)
        return grads, metrics

    step_fn.local_grads = public_local_grads
    step_fn.rep_wire = rep_wire
    return step_fn
