"""Model assembly: init, embed, blocks, forward and the tied LM head.

The counterpart of the dense GQA, ``ssm`` (Mamba-2) and ``hybrid``
(zamba2: a Mamba-2 backbone with shared attention blocks) families of
``repro.models.model``.  Parameters
are a dict like the reference's pytree, except that ``layers`` (and the
hybrid's ``shared_blocks``) is a list with one dict per layer (block)
where the reference stacks a leading axis for ``lax.scan``
(``repro_torch.bridge`` converts one into the other); the layer stack is a
Python loop.  In training each dense block, the hybrid's shared
applications too, runs through the block runner the step passes in (the
ART-TP block, or at tp 1 the dense block with blockwise attention), each
ssm block is the model's own (its SSD scan the kernel with its backward),
and every block goes through the config's ``remat`` policy (remat full
recomputes the block, and with it the scan's forward, in backward).
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


def _init(shape, dtype, gen: torch.Generator, device,
          scale: float = 0.02) -> torch.Tensor:
    """Truncated normal (±2σ) × ``scale``, as the reference's ``_init``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def _init_dense_layer(cfg: ModelConfig, gen, device) -> Params:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    dt = L.pdtype(cfg)
    depth_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    mlp = {"w_up": _init((d, f), dt, gen, device),
           "w_down": _init((f, d), dt, gen, device, depth_scale)}
    if cfg.gated_mlp:
        mlp["w_gate"] = _init((d, f), dt, gen, device)
    return {
        "ln1": {"scale": torch.ones(d, dtype=dt, device=device)},
        "attn": {
            "wq": _init((d, cfg.n_heads * hd), dt, gen, device),
            "wk": _init((d, cfg.n_kv_heads * hd), dt, gen, device),
            "wv": _init((d, cfg.n_kv_heads * hd), dt, gen, device),
            "wo": _init((cfg.n_heads * hd, d), dt, gen, device, depth_scale),
        },
        "ln2": {"scale": torch.ones(d, dtype=dt, device=device)},
        "mlp": mlp,
    }


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
    if not ((cfg.family in ("dense", "hybrid") and cfg.attn_type == "gqa")
            or cfg.family == "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA, ssm and hybrid families are "
            f"ported (the others: ROADMAP queue 1 item 5)")


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
    dict as soon as it is drawn (the TP init keeps only this rank's
    shard, so a whole model never sits on the device at once)."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = L.pdtype(cfg)
    p: Params = {
        "embed": _init((cfg.vocab_size, cfg.d_model), dt, gen, device),
        "final_norm": {"scale": torch.ones(cfg.d_model, dtype=dt,
                                           device=device)},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _init((cfg.d_model, cfg.vocab_size), dt, gen, device)
    init_layer = (_init_dense_layer if cfg.family == "dense"
                  else _init_ssm_layer)
    layer_fn = layer_fn or (lambda layer: layer)
    p["layers"] = [layer_fn(init_layer(cfg, gen, device))
                   for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        # the attention blocks every application shares; their depth
        # scale is the backbone's (n_layers), as in the reference
        p["shared_blocks"] = [layer_fn(_init_dense_layer(cfg, gen, device))
                              for _ in range(max(cfg.n_shared_blocks, 1))]
    return p


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def check_remat(cfg: ModelConfig) -> None:
    """Raise unless the port trains with ``cfg.remat``: ``"full"`` and
    ``"none"``.  The reference's ``"dots"`` policy (keep the matmul
    outputs) has no counterpart here."""
    if cfg.remat == "dots":
        raise NotImplementedError(
            f"{cfg.name}: remat='dots' (save the matmul outputs, recompute "
            f"the rest) is not ported; use 'full' or 'none' (ROADMAP queue "
            f"1 item 7)")
    if cfg.remat not in ("full", "none"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")


def _maybe_remat(cfg: ModelConfig, fn):
    """Per-block activation checkpointing while gradients are recorded:
    ``remat="full"`` keeps only each block's input and recomputes the
    block in backward (``torch.utils.checkpoint``, non-reentrant), and
    ``"none"`` keeps everything; any other policy raises
    (:func:`check_remat`)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    check_remat(cfg)

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)

    return remat


def dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, *,
                core: Optional[Callable] = None) -> torch.Tensor:
    """One pre-norm dense block: attention, then the MLP, each added to
    the residual.  ``core`` is the attention core (``layers.attention``'s:
    by default the flash kernel, which has no backward)."""
    h = x + L.attention(cfg, p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps),
                        positions, core=core)
    return h + L.mlp(cfg, p["mlp"], L.rms_norm(p["ln2"], h, cfg.norm_eps))


def _dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor,
                 runner: Optional[Callable] = None) -> torch.Tensor:
    if runner is not None:
        # the train step's block: the ART-TP block (models/artblock.py) or,
        # at tp 1, dense_block over blockwise attention (dist/steps.py)
        return runner(cfg, p, x, positions)
    return dense_block(cfg, p, x, positions)


def _ssm_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    return x + L.mamba2_block(cfg, p["mamba"],
                              L.rms_norm(p["ln"], x, cfg.norm_eps))


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, *,
                   runner: Optional[Callable] = None) -> torch.Tensor:
    """tokens (B, S) → final-norm hidden (B, S, D).

    ``positions`` (default ``arange(S)``) is what the blocks rope with.
    A block runner (``runner(cfg, layer_params, x, positions)``, training)
    runs each dense block in place of :func:`dense_block`.  With the TP
    runner ``tokens`` is this rank's sequence shard and ``positions``
    the whole sequence's: rank r holds rows ``r·S_loc + arange(S_loc)``,
    and the runner ropes after gathering.
    Each block goes through :func:`_maybe_remat` (the per-layer
    ``remat`` policy of the reference's scan body).  A hybrid runs its
    Mamba-2 layers and shared applications in :func:`hybrid_order`, each
    application a dense block over its shared parameters (autograd sums a
    shared block's gradient over its applications)."""
    _check_ported(cfg)
    x = _embed(params, tokens)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    ssm = _maybe_remat(cfg, lambda h, lp: _ssm_block(cfg, lp, h))
    dense = _maybe_remat(
        cfg, lambda h, lp: _dense_block(cfg, lp, h, positions, runner))
    if cfg.family == "hybrid":
        for kind, i in hybrid_order(cfg):
            x = (ssm(x, params["layers"][i]) if kind == "ssm"
                 else dense(x, shared_block(cfg, params, i)))
    else:
        block = ssm if cfg.family == "ssm" else dense
        for lp in params["layers"]:
            x = block(x, lp)
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            runner: Optional[Callable] = None) -> torch.Tensor:
    """tokens (B, S) → fp32 logits (B, S, V)."""
    return _lm_logits(cfg, params,
                      forward_hidden(cfg, params, tokens, runner=runner))


def loss_fn(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            *, z_loss: float = 1e-4, moe_aux_weight: float = 1e-2,
            runner: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss_fn`` over full logits: batch tokens (B, S),
    labels (B, S) with -1 = masked.  Returns (total, metrics) with the
    masked mean cross-entropy ``ce``, ``z_loss`` (``z_loss`` × the masked
    mean of logsumexp²), ``moe_aux`` (0: no ported family routes experts)
    and the ``tokens`` counted.  ``runner`` is :func:`forward_hidden`'s:
    on the card a dense or hybrid model's gradient needs one
    (``dist.steps`` builds it), since the default attention is the
    forward-only flash kernel; an ssm model needs none.  The training
    step streams the head instead (``dist/loss.py``)."""
    logits = forward(cfg, params, batch["tokens"], runner=runner)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    denom = mask.sum().clamp_min(1.0)
    ce = ((lse - gold) * mask).sum() / denom
    zl = z_loss * ((lse * mask) ** 2).sum() / denom
    aux = logits.new_zeros(())
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


def count_params_analytic(cfg: ModelConfig) -> int:
    """Scalars in ``init_params(cfg)`` from the config alone: the dense
    GQA, ``ssm`` and ``hybrid`` terms of
    ``repro.models.model.count_params_analytic``."""
    _check_ported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    total = v * d + d + (0 if cfg.tie_embeddings else d * v)
    d_in = cfg.ssm_heads * cfg.ssm_head_dim
    conv_ch = d_in + 2 * cfg.ssm_groups * cfg.ssm_state
    proj_out = 2 * d_in + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    ssm = (d * proj_out + cfg.ssm_conv * conv_ch + conv_ch
           + 3 * cfg.ssm_heads + d_in + d_in * d + d)
    if cfg.family == "ssm":
        return total + cfg.n_layers * ssm
    hd = cfg.resolved_head_dim
    attn = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d)
    dense = attn + (3 if cfg.gated_mlp else 2) * d * cfg.d_ff + 2 * d
    if cfg.family == "hybrid":
        return (total + cfg.n_layers * ssm
                + max(cfg.n_shared_blocks, 1) * dense)
    return total + cfg.n_layers * dense
