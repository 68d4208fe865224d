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
backward (``kernels/ssd``).  On a model line of tp ≥ 2 a dense, VLM or
MLA model takes the path the reference takes (:func:`tp_scheme`): where
``TransportPolicy.tp`` names a ring family (``fused``, ``ring``,
``bidir`` or ``auto``), the config sets ``use_art`` and the ART block
takes it (``artblock.supports_art_tp``), the ART path: every dense
block's TP edges on the family the policy's conduit picks
(``models/artblock.py``: the fused rings of ``kernels/cc_matmul`` or the
overlap schedules of ``core/overlap.py``), its K/V gathered over that
conduit; otherwise — ``tp="xla"``, the reference's default, or a config
the ART block does not take (``smollm-360m``'s 15 heads at tp 2, MLA) —
the reference's GSPMD layout written out (``models/tp_block.py``: the
normed rows gathered over S, column and row products on the rank's
shards, a reduce-scatter back, every collective gloo's), its residual
sequence-sharded where ``sequence_parallel`` is set and tp divides S,
else whole on every rank.  On either, where the line divides the vocab,
the vocab-parallel embedding and LM head (``models/vocab_parallel.py``;
the head another AG edge, or under ``xla`` the gathered rows times the
rank's columns), and a VLM's patch rows join the sequence before it is
split (``tp_block.SeqLine``).  A MoE
model on an expert line of n ≥ 2 trains by expert parallelism over it
(the reference's ``models/moe_ep.py`` runner on an ``expert`` mesh
axis): rank r of the line holds experts ``[r·E/n, (r+1)·E/n)``, its
tokens ride the conduit all-to-all of ``TransportPolicy.moe`` to their
experts and back, and the replicated leaves' gradients are summed over
the line.  A data line of D ≥ 2 splits each microbatch's rows and
averages the gradients over the line (``dist/grad_sync.py``).  Every
path sums microbatch gradients in fp32, leaf by leaf, and lays the sums
out in flat buckets with ``grad_bucket_bytes``.  ``compress_cross_pod``,
the ssm, hybrid and encoder-decoder families at tp ≥ 2, and a MoE model
on a model axis raise ``NotImplementedError``, each naming its ROADMAP
item.

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
from repro_torch.models.tp_block import SeqLine, TPBlock
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
ROADMAP_TP_FAMILIES = ("ROADMAP queue 1 item 7.5b (the ssm, hybrid and "
                       "encoder-decoder families and a MoE model on a model "
                       "axis, which the reference trains through GSPMD)")


@dataclasses.dataclass(frozen=True)
class TransportPolicy:
    """The traffic classes of ``repro.dist.steps.TransportPolicy``, each
    validated against the transports registered for the op it rides
    (``tp`` all_gather, ``moe`` all_to_all, ``cross_pod`` all_reduce) as
    the reference validates it, ``compress_cross_pod``, the conduit's
    ``chunk_bytes``, and ``moe_stream_chunks`` (the EP exchange split into
    that many ART chunks, bit-identical to bulk; None/1 bulk).

    ``tp`` is the TP edges' family (``fused``, ``ring``, ``bidir`` or
    ``auto``), or ``xla`` (the default, as the reference's): the
    reference's GSPMD layout, ``models/tp_block.py``.  ``moe``
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
    sequence_parallel: bool = True   # shard S of the residual over TP
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


def tp_scheme(cfg: ModelConfig, scfg: StepConfig, size: int) -> str:
    """The TP path a model line of ``size`` ranks takes, the reference's
    choice (``repro/dist/steps.py`` ``_art_runner``, ``_dense_block``):
    ``"art"`` where ``TransportPolicy.tp`` is not ``xla``, ``cfg.use_art``
    is set and the ART block takes the config
    (``artblock.supports_art_tp``), else ``"xla"`` — also the placement
    scheme of ``dist/sharding.py``."""
    policy = scfg.resolved_transport()
    if (policy.tp != "xla" and cfg.use_art
            and artblock.supports_art_tp(cfg, size)):
        return "art"
    return "xla"


def param_places(cfg: ModelConfig, size: int, axis: str,
                 scheme: Optional[str]) -> Dict[Tuple, str]:
    """Every parameter leaf's placement on an inner line of ``size``
    ranks on ``axis`` (on ``model`` under the TP path ``scheme``,
    :func:`tp_scheme`), by path: ``dist/sharding.py``'s rule on the
    logical leaves (their shapes from ``init_params`` on the ``meta``
    device: nothing drawn or allocated), which a shard alone does not
    give (whether a leaf's dim was split)."""
    return {path: sharding.placement(path, axis, tuple(t.shape), size,
                                     scheme=scheme)
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
                ) -> Tuple[Optional[str], Optional[Callable]]:
    """(The TP scheme, the MoE runner) of this grid's train step — (None,
    None) when the inner line is one rank: the model's own blocks,
    attending through ``layers.blockwise_core`` — or the raise that
    names the ROADMAP item of a path not ported."""
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
        item = (ROADMAP_TP_FAMILIES if cfg.family == "moe" else
                "ROADMAP queue 1 item 7.5d (the other grids)")
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on a {grid.inner_axis} axis of "
            f"{inner.size} is not ported (the port splits a MoE model's "
            f"experts, a dense model's blocks): {item}")
    if cfg.family == "moe":
        return None, _moe_runner(cfg, inner, policy)
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} training at tp {inner.size} is not "
            f"ported under tp={policy.tp!r}: {ROADMAP_TP_FAMILIES}")
    return tp_scheme(cfg, scfg, inner.size), None


def build_init(cfg: ModelConfig, grid, scfg: StepConfig
               ) -> Callable[[int], Tuple[Dict[str, Any], Dict[str, Any]]]:
    """``init_fn(seed) -> (params, opt_state)`` on this rank's device:
    every leaf drawn as ``models.model.init_params(cfg, seed)`` draws it
    (so every rank and every grid sees the same full model), then, on an
    inner line of two or more ranks, cut to this rank's shard
    (``dist/sharding.py``, on the :func:`group_axis` placement under the
    :func:`tp_scheme`) layer by
    layer, the embedding and head as soon as each is drawn.  Every data
    rank holds the same copy of its model line's shard."""
    grid = step_grid(cfg, grid)
    axis, inner = group_axis(cfg), grid.inner
    scheme = tp_scheme(cfg, scfg, inner.size)

    def init_fn(seed: int = 0):
        layer_fn = None if inner.size == 1 else (
            lambda layer: sharding.shard_tree(layer, inner.rank, inner.size,
                                              axis, scheme=scheme))
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

    ``batch`` is the global batch (tokens and labels (B, S); on the ART
    path the line's sequence, a VLM's N patch rows counted, a multiple of
    tp; B a multiple of microbatches × the ranks its rows split over; a
    frontend arch's ``frontend_embeds`` (B, N, frontend_dim)), the same
    on every rank.  The step cuts it
    into ``scfg.microbatches`` microbatches, m taking rows ``[m·B/M,
    (m+1)·B/M)``, and each microbatch's rows over the data line (data
    rank d rows ``[d·b, (d+1)·b)``, as the reference's ``batch_pspecs``
    shards rows over its data axis), or on an expert grid over every rank
    in world order (the reference's EP region shards rows over every mesh
    axis).  For each microbatch it (1) embeds the rank's part: on a model
    line (``models/tp_block.py`` ``SeqLine``) the line's sequence of its
    rows, a VLM's projected patch rows first, then its sequence shard,
    rows ``[r·S/tp, (r+1)·S/tp)``, or, where ``sequence_parallel`` is off
    or tp does not divide S on the ``xla`` path, the whole sequence on
    every rank; positions ``arange(S)`` (where the line divides the
    vocab by the vocab-parallel embedding, ``models/vocab_parallel.py``:
    the rank looks up the line's whole sequence in its vocab rows and a
    reduce-scatter over the sequence, or an all-reduce, leaves it its
    rows; else by the replicated lookup), else its rows whole (a VLM's
    patch rows before them); (2) runs the blocks, the dense ones through
    the TP path's block at tp ≥ 2 (:func:`tp_scheme`: the ART block, or
    ``tp_block.TPBlock``), the MoE layers through the expert-parallel
    runner on an expert line, every attention through blockwise
    attention but the ART block's;
    (3) applies the final norm and the chunked CE over its part, plus
    ``moe_aux_weight`` × a MoE model's load-balancing loss: the token
    count and the experts' choice counts are summed over the whole world,
    so each rank's loss is its share of the reference's global-batch
    loss, and the shares sum to it whatever the masked labels' spread (a
    VLM's patch rows carry masked labels; a rank whose line holds the
    residual whole counts its cut of the sequence; a vocab-parallel line
    takes the head over its vocab columns, each chunk's rows gathered
    over the line by the AG ring edge or, under ``xla``, gloo's gather,
    and combines the ranks' log-sum-exps a token, ``dist/loss.py``: each
    token counts once in the sums, and each rank's backward covers the
    line's tokens on its columns);
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
    the global loss's to that rounding, not bit for bit (ROADMAP §3); (6)
    sums the replicated leaves' gradients over the inner line (the
    norms, ``frontend_proj``, ``wk``/``wv`` on the ART path, any leaf
    ``fit_axis`` keeps whole; ``embed`` and ``lm_head`` too where the
    vocab does not split), a sharded leaf's gradient being complete on
    its rank (the embedding's from its scatter, the head's from its
    edge's or product's weight gradient, a gathered weight's from the
    gather's reduce-scatter; the all-reduce's bytes are
    ``step_fn.rep_wire``), (7) clips by the global norm
    over the inner line and (8) takes an AdamW step at
    ``warmup_cosine(step)``, the same on every data rank.  Parameters and
    optimizer state are the model line's shards, the same on every data
    rank (DDP over the data axis; the reference
    shards them over its data axis, ZeRO/FSDP: ROADMAP queue 1 item 7.5c)
    and updated in place.  ``metrics``: the microbatches' mean loss, ce,
    z_loss and moe_aux and their summed token count (the world's), the
    pre-clip grad norm and the learning rate.

    ``step_fn.local_grads(params, batch)`` runs (1)–(4) alone and returns
    (this rank's fp32 gradients of D × its share, in ``dist.sharding.
    leaves`` order, divided by the microbatch count; the metrics): the
    per-rank gradients a data-axis sync takes."""
    grid = step_grid(cfg, grid)
    scheme, moe_runner = _check_path(cfg, grid, scfg)
    core = L.blockwise_core(cfg)
    acfg = _adamw_config(scfg)
    policy = scfg.resolved_transport()
    inner, data, world = grid.inner, grid.data, grid.world
    runner = _art_runner(cfg, policy, inner) if scheme == "art" else None
    tp = inner.size
    n_data = data.size
    n_micro = int(scfg.microbatches)
    sum_group = world if world.size > 1 else None
    norm_group = inner if tp > 1 else None
    row_group = world if moe_runner is not None else data
    axis = group_axis(cfg)
    places = param_places(cfg, tp, axis, scheme) if tp > 1 else {}
    # the model line's conduit: the policy's under ART, gloo's plain
    # collectives under the reference's GSPMD layout
    conduit = (None if scheme is None else policy.tp_conduit(inner)
               if scheme == "art" else Conduit(axis=inner, transport="xla"))
    # the TP line's vocab split, where the placement rule makes one (else
    # the lookup and the head stay replicated)
    vocab = (VocabParallel(conduit, cfg.vocab_size)
             if scheme is not None and places[("embed",)] != "rep"
             else None)
    block = (TPBlock(cfg, inner, {p[2:]: v for p, v in places.items()
                                  if p[:2] == ("layers", 0)})
             if scheme == "xla" else None)
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
        fe = micro.get("frontend_embeds")
        rows = split_rows(tokens.shape[0], row_group)
        local = {"tokens": tokens[rows].to(grid.device),
                 "labels": labels[rows].to(grid.device)}
        if fe is not None:
            local["frontend_embeds"] = fe[rows].to(grid.device)
        # whole rows rope at their own index (a VLM's text after its
        # patch rows); on a model line the line's sequence, its patch
        # rows first, is embedded through the line and the blocks rope
        # the gathered sequence
        line = positions = None
        run = runner
        if scheme is not None:
            s = tokens.shape[1] + (fe.shape[1] if cfg.family == "vlm"
                                   else 0)
            sp = scheme == "art" or (scfg.sequence_parallel and s % tp == 0)
            if s % tp and sp:
                raise ValueError(f"sequence {s} does not split over {tp} "
                                 f"ranks (the ART block shards it)")
            line = SeqLine(conduit, sp, vocab)
            positions = torch.arange(s, device=grid.device)
            if block is not None:
                run = block.runner(line)
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, metrics = chunked_ce_loss(
                cfg, params, local, seq_chunk=scfg.seq_chunk,
                z_loss=scfg.z_loss, moe_aux_weight=scfg.moe_aux_weight,
                group=sum_group, positions=positions, runner=run,
                core=core, moe_ffn=moe_runner, line=line)
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
