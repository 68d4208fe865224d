"""Model assembly: init, embed, blocks, forward and the LM head.

The counterpart of the dense GQA and MLA (minicpm3: multi-head latent
attention), ``moe`` (llama4-scout, grok-1: attention then a MoE layer, a
Switch load-balancing loss a layer), ``vlm`` (internvl2: projected patch
embeddings before the text), ``encdec`` (whisper: a bidirectional encoder
over frame embeddings, a decoder with cross-attention), ``ssm`` (Mamba-2)
and ``hybrid`` (zamba2: a Mamba-2 backbone with shared attention blocks)
families of ``repro.models.model``.  Parameters
are a dict like the reference's pytree, except that ``layers`` (the
hybrid's ``shared_blocks``, the encoder-decoder's ``enc_layers`` and
``dec_layers``) is a list with one dict per layer (block) where the
reference stacks a leading axis for ``lax.scan``
(``repro_torch.bridge`` converts one into the other); the layer stack is a
Python loop.  In training at tp 1 every block is the model's own and
every attention (dense and VLM blocks, MLA's, a MoE block's, the hybrid's
shared applications, the encoder's, the decoder's self- and
cross-attention) goes through the attention core the step passes in
(``layers.blockwise_core``); each ssm block's SSD scan is the kernel with
its backward.  At tp ≥ 2 each dense block runs through the block runner
the step passes in (the ART-TP block, or the reference's GSPMD layout
written out, ``models/tp_block.py``).  Every block goes
through the config's ``remat`` policy: ``"full"`` recomputes the block,
and with it the scan's forward, in backward; ``"dots"`` keeps the
products with no batch dimension and recomputes the rest.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

#: rows of the encoder-decoder's learned decoder positions ``dec_pos``
DEC_POS = 4096


def _init(shape, dtype, gen: torch.Generator, device,
          scale: float = 0.02) -> torch.Tensor:
    """Truncated normal (±2σ) × ``scale``, as the reference's ``_init``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def _init_norm(cfg: ModelConfig, device) -> Params:
    """RMSNorm's unit scale, or (encoder-decoder) LayerNorm's unit scale
    and zero bias, as the reference's ``init_norm``."""
    dt = L.pdtype(cfg)
    p = {"scale": torch.ones(cfg.d_model, dtype=dt, device=device)}
    if cfg.family == "encdec":
        p["bias"] = torch.zeros(cfg.d_model, dtype=dt, device=device)
    return p


def _init_attention(cfg: ModelConfig, gen, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = L.pdtype(cfg)
    depth_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "wq": _init((d, cfg.n_heads * hd), dt, gen, device),
        "wk": _init((d, cfg.n_kv_heads * hd), dt, gen, device),
        "wv": _init((d, cfg.n_kv_heads * hd), dt, gen, device),
        "wo": _init((cfg.n_heads * hd, d), dt, gen, device, depth_scale),
    }


def _init_mla(cfg: ModelConfig, gen, device) -> Params:
    """The reference's ``init_mla``: the low-rank q path (``w_dq``, its
    norm, ``w_uq``), the latent's down projection ``w_dkv`` (latent and
    shared rope key), its norm, the up projections ``w_uk``/``w_uv`` and
    a depth-scaled ``wo``."""
    d, r, rq = cfg.d_model, cfg.kv_lora_rank, cfg.q_lora_rank
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    dt = L.pdtype(cfg)
    depth_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "w_dq": _init((d, rq), dt, gen, device),
        "q_norm": {"scale": torch.ones(rq, dtype=dt, device=device)},
        "w_uq": _init((rq, h * (dn + dr)), dt, gen, device),
        "w_dkv": _init((d, r + dr), dt, gen, device),
        "kv_norm": {"scale": torch.ones(r, dtype=dt, device=device)},
        "w_uk": _init((r, h * dn), dt, gen, device),
        "w_uv": _init((r, h * dv), dt, gen, device),
        "wo": _init((h * dv, d), dt, gen, device, depth_scale),
    }


def _init_mlp(cfg: ModelConfig, gen, device, d_ff: int) -> Params:
    """The MLP's ``w_up`` (and ``w_gate``) (D, d_ff) and depth-scaled
    ``w_down`` (d_ff, D)."""
    d, dt = cfg.d_model, L.pdtype(cfg)
    depth_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    mlp = {"w_up": _init((d, d_ff), dt, gen, device),
           "w_down": _init((d_ff, d), dt, gen, device, depth_scale)}
    if cfg.gated_mlp:
        mlp["w_gate"] = _init((d, d_ff), dt, gen, device)
    return mlp


def _init_moe(cfg: ModelConfig, gen, device) -> Params:
    """The reference's ``init_moe``: an fp32 router (D, E), the stacked
    experts ``w_up``/``w_gate`` (E, D, F) and depth-scaled ``w_down`` (E,
    F, D), and the shared expert, an MLP ``d_ff · n_shared_experts``
    wide."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = L.pdtype(cfg)
    depth_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    p = {"router": _init((d, e), torch.float32, gen, device),
         "w_up": _init((e, d, f), dt, gen, device),
         "w_down": _init((e, f, d), dt, gen, device, depth_scale)}
    if cfg.gated_mlp:
        p["w_gate"] = _init((e, d, f), dt, gen, device)
    if cfg.n_shared_experts:
        p["shared"] = _init_mlp(cfg, gen, device, f * cfg.n_shared_experts)
    return p


def _init_dense_layer(cfg: ModelConfig, gen, device,
                      cross: bool = False) -> Params:
    """A pre-norm block: attention and the MLP (a MoE arch's: the MoE
    layer, ``moe``); ``cross`` adds the encoder-decoder's cross-attention
    ``xattn`` and its norm ``ln_x``."""
    # the feed-forward is drawn first, then attention
    ff = ({"moe": _init_moe(cfg, gen, device)} if cfg.family == "moe"
          else {"mlp": _init_mlp(cfg, gen, device, cfg.d_ff)})
    p = {"ln1": _init_norm(cfg, device),
         "attn": (_init_mla(cfg, gen, device) if cfg.attn_type == "mla"
                  else _init_attention(cfg, gen, device)),
         "ln2": _init_norm(cfg, device), **ff}
    if cross:
        p["ln_x"] = _init_norm(cfg, device)
        p["xattn"] = _init_attention(cfg, gen, device)
    return p


def _init_mamba2(cfg: ModelConfig, gen, device) -> Params:
    """The reference's ``init_mamba2``: ``a_log = log(linspace(1, 16))``,
    zero ``dt_bias``, unit ``d_skip`` (all fp32), conv weights × 0.1 and a
    depth-scaled ``out_proj``."""
    dt = L.pdtype(cfg)
    h, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    d_in = h * cfg.ssm_head_dim
    conv_ch = d_in + 2 * g * n
    proj_out = 2 * d_in + 2 * g * n + h
    depth_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    f32 = torch.float32
    return {
        "in_proj": _init((cfg.d_model, proj_out), dt, gen, device),
        "conv_w": _init((cfg.ssm_conv, conv_ch), dt, gen, device, 0.1),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "dt_bias": torch.zeros(h, dtype=f32, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "d_skip": torch.ones(h, dtype=f32, device=device),
        "gate_norm": {"scale": torch.ones(d_in, dtype=dt, device=device)},
        "out_proj": _init((d_in, cfg.d_model), dt, gen, device, depth_scale),
    }


def _init_ssm_layer(cfg: ModelConfig, gen, device) -> Params:
    return {"ln": {"scale": torch.ones(cfg.d_model, dtype=L.pdtype(cfg),
                                       device=device)},
            "mamba": _init_mamba2(cfg, gen, device)}


def _check_ported(cfg: ModelConfig) -> None:
    if not ((cfg.family in ("dense", "moe", "hybrid", "vlm", "encdec")
             and cfg.attn_type == "gqa")
            or (cfg.family == "dense" and cfg.attn_type == "mla")
            or cfg.family == "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: the port takes the dense GQA and MLA, moe (GQA), "
            f"vlm, encdec, ssm and hybrid families, not {cfg.family} with "
            f"{cfg.attn_type} attention")


def n_applications(cfg: ModelConfig) -> int:
    """Shared-block applications of a hybrid: one after every
    ``hybrid_period`` Mamba-2 layers (the trailing layers take none)."""
    return cfg.n_layers // cfg.hybrid_period


def hybrid_order(cfg: ModelConfig) -> Iterator[Tuple[str, int]]:
    """The hybrid's blocks in order (the reference's ``_forward_hybrid``):
    ``("ssm", i)`` for Mamba-2 layer ``i``, and ``("shared", g)`` for
    shared application ``g``, which runs block :func:`shared_block` and
    owns K/V cache ``g`` after layers ``[g·period, (g+1)·period)``; the
    ``n_layers % period`` trailing layers run last."""
    period = cfg.hybrid_period
    for g in range(n_applications(cfg)):
        for i in range(g * period, (g + 1) * period):
            yield "ssm", i
        yield "shared", g
    for i in range(n_applications(cfg) * period, cfg.n_layers):
        yield "ssm", i


def shared_block(cfg: ModelConfig, params: Params, g: int) -> Params:
    """The parameters application ``g`` runs: block ``g % n_shared``."""
    return params["shared_blocks"][g % max(cfg.n_shared_blocks, 1)]


def init_params(cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                layer_fn: Optional[Callable[[Params], Params]] = None
                ) -> Params:
    """Random parameters from a seeded ``torch.Generator``, drawn from the
    reference's distributions (truncated normal × 0.02, depth-scaled
    output projections, the Mamba-2 block's fixed decay/skip init).  The
    numbers differ from the reference's ``jax.random`` draws; tests that
    compare the two pass the reference's parameters through
    ``repro_torch.bridge`` instead.  ``layer_fn`` transforms each layer's
    dict as soon as it is drawn, and the dicts of the top-level ``embed``
    and ``lm_head`` (the TP init keeps only this rank's shard, so a whole
    model never sits on the device at once).  On the
    ``meta`` device it draws nothing and allocates nothing: the shapes
    alone, for a memory reckoning."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(int(seed)))
    dt = L.pdtype(cfg)
    layer_fn = layer_fn or (lambda layer: layer)
    p: Params = layer_fn(
        {"embed": _init((cfg.vocab_size, cfg.d_model), dt, gen, device)})
    p["final_norm"] = _init_norm(cfg, device)
    if not cfg.tie_embeddings:
        p.update(layer_fn({"lm_head": _init((cfg.d_model, cfg.vocab_size),
                                            dt, gen, device)}))
    if cfg.family == "encdec":
        p["enc_layers"] = [_init_dense_layer(cfg, gen, device)
                           for _ in range(cfg.n_encoder_layers)]
        p["dec_layers"] = [_init_dense_layer(cfg, gen, device, cross=True)
                           for _ in range(cfg.n_layers)]
        p["enc_norm"] = _init_norm(cfg, device)
        p["dec_pos"] = _init((DEC_POS, cfg.d_model), dt, gen, device, 0.01)
    else:
        init_layer = (_init_ssm_layer if cfg.family in ("ssm", "hybrid")
                      else _init_dense_layer)
        p["layers"] = [layer_fn(init_layer(cfg, gen, device))
                       for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        # the attention blocks every application shares; their depth
        # scale is the backbone's (n_layers), as in the reference
        p["shared_blocks"] = [layer_fn(_init_dense_layer(cfg, gen, device))
                              for _ in range(max(cfg.n_shared_blocks, 1))]
    if cfg.frontend:
        p["frontend_proj"] = _init((cfg.frontend_dim, cfg.d_model), dt, gen,
                                   device)
    return p


def project_frontend(cfg: ModelConfig, params: Params,
                     frontend_embeds: torch.Tensor) -> torch.Tensor:
    """Frontend embeddings (B, N, frontend_dim) through ``frontend_proj``
    in the compute dtype: (B, N, D), still in the compute dtype."""
    cd = L.cdtype(cfg)
    return frontend_embeds.to(cd) @ params["frontend_proj"].to(cd)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
           frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, D); a VLM puts its projected patch rows
    (B, N, D) before them (those rows may be a chunk's slice of the
    patches, or none)."""
    x = params["embed"][tokens]
    if cfg.family == "vlm" and frontend_embeds is not None \
            and frontend_embeds.shape[1]:
        vis = project_frontend(cfg, params, frontend_embeds).to(x.dtype)
        x = torch.cat([vis, x], dim=1)
    return x


def check_remat(cfg: ModelConfig) -> None:
    """Raise unless ``cfg.remat`` is a policy the port trains with:
    ``"full"``, ``"dots"`` or ``"none"``."""
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _is_saved_product(op, args) -> bool:
    """A product with no batch dimension: ``aten.mm``, ``aten.addmm``
    (``x @ w`` folds a 3-D ``x`` into one), or an ``aten.bmm`` of batch
    1 (an einsum without a batch dimension).  Attention's per-head
    einsums and the experts' (E, C, D) @ (E, D, F) products are batched
    ``bmm``s; the SSD scan launches its kernel through ``ctypes``, out of
    the dispatcher's sight."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return True
    return op is aten.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the outputs of :func:`_is_saved_product`, recompute every other op."""
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if _is_saved_product(op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def _maybe_remat(cfg: ModelConfig, fn):
    """Per-block activation checkpointing while gradients are recorded
    (``torch.utils.checkpoint``, non-reentrant): ``remat="full"`` keeps
    only each block's input and recomputes the block in backward,
    ``"dots"`` keeps the outputs of its products with no batch dimension
    as well (selective checkpointing, :func:`_dots_policy`) and
    recomputes everything else, the SSD scan's forward among it (its
    kernel gives the same bits again), and ``"none"`` keeps everything."""
    check_remat(cfg)
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False, **kw)

    return remat


def dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, *,
                core: Optional[Callable] = None,
                causal: bool = True) -> torch.Tensor:
    """One pre-norm dense block: attention (MLA's where the config says
    so, as the reference picks), then the MLP, each added to the
    residual.  ``core`` is the attention core (``layers.attention``'s: by
    default the flash kernel, which has no backward); ``causal=False`` is
    the whisper encoder's bidirectional block."""
    normed = L.apply_norm(cfg, p["ln1"], x)
    if cfg.attn_type == "mla":
        h = x + L.mla_attention(cfg, p["attn"], normed, positions, core=core)
    else:
        h = x + L.attention(cfg, p["attn"], normed, positions, core=core,
                            causal=causal)
    return h + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], h))


def ffn(cfg: ModelConfig, p: Params, x: torch.Tensor,
        dense_combine: bool = False,
        moe_ffn: Optional[Callable] = None) -> torch.Tensor:
    """A block's feed-forward on its normed rows: the MoE layer for the
    ``moe`` family (``dense_combine`` in decode; ``moe_ffn(cfg,
    moe_params, x)`` in its place when given, the expert-parallel runner
    of ``models/moe_ep.py``), else the MLP."""
    if cfg.family == "moe":
        if moe_ffn is not None:
            return moe_ffn(cfg, p["moe"], x)
        return L.moe(cfg, p["moe"], x, dense_combine=dense_combine)
    return L.mlp(cfg, p["mlp"], x)


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor, *, core: Optional[Callable] = None,
              moe_ffn: Optional[Callable] = None, aux_group=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MoE block (the reference's ``_moe_block``): attention (through
    ``core``, :func:`dense_block`'s), then the MoE layer (``moe_ffn``, the
    expert-parallel runner, in place of ``layers.moe`` when given), each
    added to the residual.  Returns (h, the layer's load-balancing loss
    over the MoE layer's input: with ``aux_group``, this rank's share of
    the loss over the group's rows, ``layers.moe_aux_loss``)."""
    h = x + L.attention(cfg, p["attn"], L.apply_norm(cfg, p["ln1"], x),
                        positions, core=core)
    normed = L.apply_norm(cfg, p["ln2"], h)
    return (h + ffn(cfg, p, normed, moe_ffn=moe_ffn),
            L.moe_aux_loss(cfg, normed, p["moe"], group=aux_group))


def cross_block_tail(cfg: ModelConfig, p: Params, h: torch.Tensor,
                     kv: Tuple[torch.Tensor, torch.Tensor], *,
                     core: Optional[Callable] = None) -> torch.Tensor:
    """What follows a decoder layer's self-attention: cross-attention over
    the encoder's K/V ``kv`` (:func:`layers.cross_kv`) through ``core``,
    then the MLP."""
    h = h + L.attention(cfg, p["xattn"], L.apply_norm(cfg, p["ln_x"], h),
                        None, causal=False, kv_override=kv, core=core)
    return h + L.mlp(cfg, p["mlp"], L.apply_norm(cfg, p["ln2"], h))


def _dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor,
                 runner: Optional[Callable] = None,
                 core: Optional[Callable] = None) -> torch.Tensor:
    if runner is not None:
        # the TP train step's block: the ART-TP block (models/artblock.py)
        return runner(cfg, p, x, positions)
    return dense_block(cfg, p, x, positions, core=core)


def _ssm_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return x + L.mamba2_block(cfg, p["mamba"],
                              L.rms_norm(p["ln"], x, cfg.norm_eps))


def encode(cfg: ModelConfig, params: Params,
           frontend_embeds: torch.Tensor, *,
           core: Optional[Callable] = None) -> torch.Tensor:
    """The whisper encoder: frame embeddings (B, S_enc, frontend_dim)
    through ``frontend_proj``, plus sinusoidal positions, then the
    bidirectional blocks (attention through ``core``, each block through
    the ``remat`` policy) and ``enc_norm``: (B, S_enc, D)."""
    enc = project_frontend(cfg, params, frontend_embeds)
    enc = enc + L.sinusoidal_positions(enc.shape[1], cfg.d_model,
                                       enc.device).to(enc.dtype)
    enc = enc.to(L.pdtype(cfg))
    positions = torch.arange(enc.shape[1], device=enc.device)
    block = _maybe_remat(cfg, lambda h, lp: dense_block(
        cfg, lp, h, positions, core=core, causal=False))
    for lp in params["enc_layers"]:
        enc = block(enc, lp)
    return L.apply_norm(cfg, params["enc_norm"], enc)


def decoder_embed(params: Params, tokens: torch.Tensor,
                  lo: int = 0) -> torch.Tensor:
    """Decoder rows ``[lo, lo+S)``: token embeddings plus the learned
    positions ``dec_pos[lo:lo+S]``."""
    x = params["embed"][tokens]
    return x + params["dec_pos"][lo:lo + x.shape[1]].to(x.dtype)


def _forward_encdec_hidden(cfg: ModelConfig, params: Params,
                           tokens: torch.Tensor,
                           frontend_embeds: Optional[torch.Tensor],
                           core: Optional[Callable] = None) -> torch.Tensor:
    """Encoder once, then the decoder: causal self-attention (no rope),
    cross-attention over each layer's K/V of the encoder output, MLP;
    every attention through ``core``, each layer through the ``remat``
    policy (the reference's scan bodies)."""
    if frontend_embeds is None:
        raise ValueError(f"{cfg.name} needs frame embeddings")
    enc = encode(cfg, params, frontend_embeds, core=core)
    x = decoder_embed(params, tokens)
    dpos = torch.arange(x.shape[1], device=x.device)

    def dec_block(h, lp, enc_out):
        a = h + L.attention(cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], h),
                            dpos, core=core)
        return cross_block_tail(cfg, lp, a, L.cross_kv(cfg, lp["xattn"],
                                                       enc_out), core=core)

    block = _maybe_remat(cfg, dec_block)
    for lp in params["dec_layers"]:
        x = block(x, lp, enc)
    return L.apply_norm(cfg, params["final_norm"], x)


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, *,
                   runner: Optional[Callable] = None,
                   core: Optional[Callable] = None,
                   frontend_embeds: Optional[torch.Tensor] = None,
                   return_aux: bool = False,
                   moe_ffn: Optional[Callable] = None, aux_group=None,
                   embed: Optional[Callable] = None):
    """tokens (B, S) → final-norm hidden (B, S, D); a VLM's hidden holds
    its ``frontend_tokens`` patch rows first (B, N + S, D), and the
    encoder-decoder's is the decoder's, the encoder run over
    ``frontend_embeds`` (its frames).

    ``positions`` (default ``arange`` over the rows) is what the blocks
    rope with.  ``core`` is the attention core of every block
    (``layers.attention``'s default, the flash kernel, when None; the
    tp-1 train step passes ``layers.blockwise_core``, since flash has no
    backward).  A block runner (``runner(cfg, layer_params, x,
    positions)``, the TP train step) runs each dense block in place of
    :func:`dense_block`: the residual is then this rank's rows of the
    sequence (or all of them) and ``positions`` the whole sequence's:
    rank r holds rows ``r·S_loc + arange(S_loc)``, and the runner ropes
    after gathering.  ``embed``
    (``embed(params, tokens, frontend_embeds)``) embeds in place of the
    lookup: the TP step's line (``models/tp_block.py`` ``SeqLine``), to
    which ``tokens`` is the line's whole sequence and which returns this
    rank's rows (a VLM's patch rows first in the sequence).
    Each block goes through :func:`_maybe_remat` (the per-layer
    ``remat`` policy of the reference's scan bodies).  A hybrid runs its
    Mamba-2 layers and shared applications in :func:`hybrid_order`, each
    application a dense block over its shared parameters (autograd sums a
    shared block's gradient over its applications).  The reference
    checkpoints a hybrid's group of ``hybrid_period`` Mamba-2 layers and
    its shared application as one body, and each Mamba-2 layer inside it
    again; checkpointing each block alone recomputes the same ops from the
    same saved values, so the values and gradients are the same.  A MoE
    model runs :func:`moe_block`s (a block runner is the dense block's; a
    MoE group trains by expert parallelism): ``moe_ffn`` is the
    expert-parallel MoE runner (``models/moe_ep.py``, the reference's
    ``shardctx.moe_ffn_runner()``), and ``aux_group`` the group whose
    rows the load-balancing loss is over.  ``return_aux`` returns
    (hidden, the sum of its layers' load-balancing losses, fp32; this
    rank's share with ``aux_group``; 0 for every other family)."""
    _check_ported(cfg)
    if cfg.family == "encdec":
        x = _forward_encdec_hidden(cfg, params, tokens, frontend_embeds,
                                   core)
        return (x, x.new_zeros((), dtype=torch.float32)) if return_aux \
            else x
    if cfg.family == "vlm" and frontend_embeds is None:
        raise ValueError(f"{cfg.name} needs patch embeddings")
    x = (embed(params, tokens, frontend_embeds) if embed is not None
         else _embed(cfg, params, tokens, frontend_embeds))
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    aux = x.new_zeros((), dtype=torch.float32)
    ssm = _maybe_remat(cfg, lambda h, lp: _ssm_block(cfg, lp, h))
    dense = _maybe_remat(
        cfg, lambda h, lp: _dense_block(cfg, lp, h, positions, runner, core))
    if cfg.family == "moe":
        if runner is not None:
            raise NotImplementedError(
                f"{cfg.name}: a MoE block takes no TP block runner: MoE "
                f"across ranks trains by expert parallelism (moe_ffn=, "
                f"models/moe_ep.py)")
        block = _maybe_remat(cfg, lambda h, lp: moe_block(
            cfg, lp, h, positions, core=core, moe_ffn=moe_ffn,
            aux_group=aux_group))
        for lp in params["layers"]:
            x, a = block(x, lp)
            aux = aux + a
    elif cfg.family == "hybrid":
        for kind, i in hybrid_order(cfg):
            x = (ssm(x, params["layers"][i]) if kind == "ssm"
                 else dense(x, shared_block(cfg, params, i)))
    else:
        block = ssm if cfg.family == "ssm" else dense
        for lp in params["layers"]:
            x = block(x, lp)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return (x, aux) if return_aux else x


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None, *,
            runner: Optional[Callable] = None,
            core: Optional[Callable] = None, return_aux: bool = False,
            moe_ffn: Optional[Callable] = None):
    """tokens (B, S) → fp32 logits (B, S, V) (a VLM's: (B, N + S, V), its
    patch rows first); ``return_aux``: (logits, the MoE load-balancing
    loss summed over layers).  ``moe_ffn`` is :func:`forward_hidden`'s."""
    out = forward_hidden(cfg, params, tokens, runner=runner, core=core,
                         frontend_embeds=frontend_embeds,
                         return_aux=return_aux, moe_ffn=moe_ffn)
    if return_aux:
        return _lm_logits(cfg, params, out[0]), out[1]
    return _lm_logits(cfg, params, out)


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, z_loss: float = 1e-4, moe_aux_weight: float = 1e-2,
            runner: Optional[Callable] = None,
            core: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn`` over full logits: batch tokens (B, S),
    labels (B, S) with -1 = masked, and a frontend arch's
    ``frontend_embeds`` (a VLM's logits over its patch rows are dropped).
    Returns (total, metrics) with the
    masked mean cross-entropy ``ce``, ``z_loss`` (``z_loss`` × the masked
    mean of logsumexp²), ``moe_aux`` (a MoE model's load-balancing loss
    summed over its layers, weighted by ``moe_aux_weight`` in the total;
    0 for every other family) and the ``tokens`` counted.  ``runner`` and
    ``core`` are :func:`forward_hidden`'s: on the card a gradient through
    attention needs ``core=layers.blockwise_core(cfg)``, since the default
    attention is the forward-only flash kernel; an ssm model needs none.
    The training step streams the head instead (``dist/loss.py``)."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("frontend_embeds"), runner=runner,
                          core=core, return_aux=True)
    labels = batch["labels"]
    logits = logits[:, logits.shape[1] - labels.shape[1]:]
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    ce = ((lse - gold) * mask).sum() / denom
    zl = z_loss * ((lse * mask) ** 2).sum() / denom
    total = ce + zl + moe_aux_weight * aux
    return total, {"ce": ce, "z_loss": zl, "moe_aux": aux,
                   "tokens": mask.sum()}


def _lm_logits(cfg: ModelConfig, params: Params,
               x: torch.Tensor) -> torch.Tensor:
    cd = L.cdtype(cfg)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x.to(cd) @ head.to(cd)).float()


def params_to(params: Any, device) -> Any:
    """A copy of a parameter tree on ``device``."""
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return [params_to(v, device) for v in params]


def count_params(params: Any) -> int:
    """Number of scalars in a parameter tree."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return sum(count_params(v) for v in params)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Scalars in ``init_params(cfg)`` from the config alone, as
    ``repro.models.model.count_params_analytic``; ``active_only`` counts a
    MoE layer's ``experts_per_token`` experts (the router and the shared
    expert always), and changes no other family's count."""
    _check_ported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    norm = 2 * d if cfg.family == "encdec" else d     # LayerNorm's bias
    total = v * d + norm + (0 if cfg.tie_embeddings else d * v)
    if cfg.frontend:
        total += cfg.frontend_dim * d
    d_in = cfg.ssm_heads * cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    proj_out = 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    ssm = (d * proj_out + cfg.ssm_conv * conv_ch + conv_ch
           + 3 * cfg.ssm_heads + d_in + d_in * d + d)
    if cfg.family == "ssm":
        return total + cfg.n_layers * ssm
    hd, h = cfg.resolved_head_dim, cfg.n_heads
    r, rq = cfg.kv_lora_rank, cfg.q_lora_rank
    if cfg.attn_type == "mla":
        attn = (d * rq + rq + rq * h * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                + d * (r + cfg.qk_rope_dim) + r + r * h * cfg.qk_nope_dim
                + r * h * cfg.v_head_dim + h * cfg.v_head_dim * d)
    else:
        attn = (d * h * hd + 2 * d * cfg.n_kv_heads * hd + h * hd * d)
    mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
    if cfg.family == "encdec":
        enc = attn + mlp + 2 * norm
        dec = 2 * attn + mlp + 3 * norm
        return (total + cfg.n_encoder_layers * enc + cfg.n_layers * dec
                + norm + DEC_POS * d)
    if cfg.family == "moe":
        n_e = cfg.experts_per_token if active_only else cfg.n_experts
        moe = (d * cfg.n_experts + n_e * mlp
               + cfg.n_shared_experts * mlp)
        return total + cfg.n_layers * (attn + moe + 2 * d)
    dense = attn + mlp + 2 * d
    if cfg.family == "hybrid":
        return (total + cfg.n_layers * ssm
                + max(cfg.n_shared_blocks, 1) * dense)
    return total + cfg.n_layers * dense
