"""Dense-decoder assembly: init, embed, blocks, forward and the tied LM head.

The counterpart of the dense family of ``repro.models.model``.  Parameters
are a dict like the reference's pytree, except that ``layers`` is a list
with one dict per layer where the reference stacks a leading layer axis
for ``lax.scan`` (``repro_torch.bridge`` converts one into the other); the
layer stack is a Python loop.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

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


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random dense-decoder parameters from a seeded ``torch.Generator``,
    drawn from the reference's distributions (truncated normal × 0.02,
    depth-scaled ``wo``/``w_down``).  The numbers differ from the
    reference's ``jax.random`` draws; tests that compare the two pass the
    reference's parameters through ``repro_torch.bridge`` instead."""
    if cfg.family != "dense" or cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported")
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
    p["layers"] = [_init_dense_layer(cfg, gen, device)
                   for _ in range(cfg.n_layers)]
    return p


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _dense_block(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = x + L.attention(cfg, p["attn"], L.rms_norm(p["ln1"], x, cfg.norm_eps),
                        positions)
    return h + L.mlp(cfg, p["mlp"], L.rms_norm(p["ln2"], h, cfg.norm_eps))


def forward_hidden(cfg: ModelConfig, params: Params,
                   tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) → final-norm hidden (B, S, D)."""
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in params["layers"]:
        x = _dense_block(cfg, lp, x, positions)
    return L.rms_norm(params["final_norm"], x, cfg.norm_eps)


def forward(cfg: ModelConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) → fp32 logits (B, S, V)."""
    return _lm_logits(cfg, params, forward_hidden(cfg, params, tokens))


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
