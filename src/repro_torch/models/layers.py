"""Layers: norms, positions, GQA and MLA attention, the MLP, the MoE layer
and the Mamba-2 block.

The counterpart of ``repro.models.layers``: RMSNorm and (whisper)
LayerNorm, RoPE and the sinusoidal encoder positions, self- and
cross-attention, minicpm3's multi-head latent attention
(:func:`mla_attention`: K/V expanded from a 256-wide latent and a shared
rope key, attended at q/k head dim 96 and v head dim 64), and the MoE
layer (:func:`moe`: top-k routing, per-row capacity, scatter dispatch to
the experts' batched products and the weighted gather back; every expert
on every row in decode).  As in the reference, MoE has no kernel: its
expert products are ``torch.bmm`` over the stacked weights.
Parameters are plain dicts of tensors laid out as the reference's (weights
``(d_in, d_out)``), and attention tensors are ``(B, H, S, D)``.  Serving
attention has one path: :func:`attention_core` calls the flash-attention
wrapper, and the Mamba-2 block's scan calls the SSD wrapper; each launches
its CUDA kernel for CUDA tensors and runs its plain version for CPU
tensors.  Training attention is :func:`blockwise_attention`, plain
differentiable PyTorch, as the reference trains off the TPU: the TP block
of ``models/artblock.py`` calls it, and the tp-1 step passes
:func:`blockwise_core` to :func:`attention` (the flash kernel has no
backward, and its wrapper refuses inputs that require grad).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dtype_of
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd import ssd, ssd_chunk_fed

Params = Dict[str, Any]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


def rms_norm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)


def layer_norm(params: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def apply_norm(cfg: ModelConfig, params: Params,
               x: torch.Tensor) -> torch.Tensor:
    """LayerNorm when the dict has a ``bias`` (the encoder-decoder's),
    else RMSNorm, as the reference picks."""
    if "bias" in params:
        return layer_norm(params, x, cfg.norm_eps)
    return rms_norm(params, x, cfg.norm_eps)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (S,) or broadcastable."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) fp32: sin of position × inverse frequency, then cos."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                           device=device) / dim))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   scale: Optional[float] = None,
                   q_offset: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, Sq, DK) against k (B, Hkv, Skv, DK) and v (B, Hkv, Skv,
    DV), scaled by ``scale`` (default ``DK ** -0.5``); q row ``i`` at
    absolute position ``q_offset + i`` (default right-aligned)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, q_offset=q_offset)


def blockwise_core(cfg: ModelConfig):
    """An attention core with :func:`attention_core`'s signature over
    :func:`blockwise_attention` at the config's chunks and causal skip:
    the training route (the reference's ``attention_core`` off the TPU)."""
    def core(q, k, v, *, causal: bool = True, window: Optional[int] = None,
             scale: Optional[float] = None,
             q_offset: Optional[int] = None) -> torch.Tensor:
        return blockwise_attention(
            q, k, v, causal=causal, window=window, scale=scale,
            q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
            causal_skip=cfg.causal_block_skip, q_offset=q_offset)

    return core


def _block_ranges(sq: int, skv: int, q_chunk: int, kv_chunk: int,
                  causal: bool, window: Optional[int], skip: bool,
                  offset: int) -> List[Tuple[int, int, int]]:
    """Static kv-block range ``[lo, hi)`` visible to each q block ``i``."""
    n_q = -(-sq // q_chunk)
    n_kv = -(-skv // kv_chunk)
    out = []
    for i in range(n_q):
        lo, hi = 0, n_kv
        if skip:
            row_hi = offset + min((i + 1) * q_chunk, sq) - 1
            row_lo = offset + i * q_chunk
            if causal:
                hi = min(hi, row_hi // kv_chunk + 1)
            if window is not None:
                lo = max(lo, (row_lo - window + 1) // kv_chunk)
        out.append((i, lo, max(lo + 1, hi)))
    return out


def blockwise_attention(
    q: torch.Tensor,       # (B, Hq, Sq, Dk)
    k: torch.Tensor,       # (B, Hkv, Skv, Dk)
    v: torch.Tensor,       # (B, Hkv, Skv, Dv)
    *,
    causal: bool,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_chunk: int = 2048,
    kv_chunk: int = 2048,
    causal_skip: bool = True,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax attention in plain, differentiable PyTorch (the
    reference's ``layers.blockwise_attention``, which is jnp, not a Pallas
    kernel): a Python loop over q chunks, each walking only its visible kv
    chunks (``causal_skip``) with a running (max, normalizer, accumulator)
    in fp32.  GQA by a (B, Hkv, group, ...) view; ``q_offset`` pins q row
    0 at an absolute position (default right-aligned, ``skv - sq``).
    Returns (B, Hq, Sq, Dv) in q's dtype.  The training path's attention
    (``models/artblock.py``); the flash kernel's plain version is that
    kernel's oracle and is not used here."""
    b, hq, sq, dk = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scale = scale if scale is not None else dk ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    offset = skv - sq if q_offset is None else q_offset

    qg = q.reshape(b, hkv, group, sq, dk).float() * scale
    kf, vf = k.float(), v.float()
    pad_q = (-sq) % q_chunk
    if pad_q:
        qg = F.pad(qg, (0, 0, 0, pad_q))
    pad_kv = (-skv) % kv_chunk
    if pad_kv:
        kf = F.pad(kf, (0, 0, 0, pad_kv))
        vf = F.pad(vf, (0, 0, 0, pad_kv))
    n_kv = kf.shape[2] // kv_chunk
    kb = kf.reshape(b, hkv, n_kv, kv_chunk, dk)
    vb = vf.reshape(b, hkv, n_kv, kv_chunk, dv)
    dev = q.device

    outs = []
    for i, lo, hi in _block_ranges(sq, skv, q_chunk, kv_chunk, causal,
                                   window, causal_skip, offset):
        qi = qg[:, :, :, i * q_chunk:(i + 1) * q_chunk]
        rows = offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full(qi.shape[:-1] + (1,), -1e30, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(qi.shape[:-1] + (dv,), device=dev)
        for j in range(lo, hi):
            cols = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bkgqd,bkcd->bkgqc", qi, kb[:, :, j])
            mask = (cols < skv)[None, :].expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (cols[None, :] <= rows[:, None])
            if window is not None:
                mask = mask & (cols[None, :] > rows[:, None] - window)
            s = torch.where(mask, s, torch.full_like(s, -1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(s <= -1e29, torch.zeros_like(s),
                            torch.exp(s - m_new))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bkgqc,bkcd->bkgqd", p,
                                             vb[:, :, j])
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append(acc / l)
    out = torch.cat(outs, dim=3)[:, :, :, :sq]
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def _heads(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor,
           n: int) -> torch.Tensor:
    """x (B, S, D) @ w → (B, n, S, hd) in the compute dtype."""
    b, s, _ = x.shape
    cd = cdtype(cfg)
    return (x.to(cd) @ w.to(cd)).reshape(
        b, s, n, cfg.resolved_head_dim).transpose(1, 2)


def qkv_proj(cfg: ModelConfig, p: Params, x: torch.Tensor,
             positions: torch.Tensor):
    """x (B, S, D) → q (B, Hq, S, hd), k and v (B, Hkv, S, hd); q and k
    roped at ``positions``, except in the encoder-decoder (whisper takes
    its positions as embeddings, not as rope)."""
    q = _heads(cfg, x, p["wq"], cfg.n_heads)
    k = _heads(cfg, x, p["wk"], cfg.n_kv_heads)
    v = _heads(cfg, x, p["wv"], cfg.n_kv_heads)
    if cfg.family == "encdec":
        return q, k, v
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def cross_kv(cfg: ModelConfig, p: Params, enc_out: torch.Tensor):
    """The encoder output's K/V for the decoder's cross-attention:
    (k, v) (B, Hkv, S_enc, hd), no rope."""
    return (_heads(cfg, enc_out, p["wk"], cfg.n_kv_heads),
            _heads(cfg, enc_out, p["wv"], cfg.n_kv_heads))


def out_proj(cfg: ModelConfig, p: Params, out: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Attention output (B, Hq, S, hd) (MLA's: v_head_dim) → (B, S, D)
    through ``wo``."""
    b, _, s, _ = out.shape
    cd = cdtype(cfg)
    flat = out.transpose(1, 2).reshape(b, s, -1)
    return (flat @ p["wo"].to(cd)).to(dtype)


def attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor, *, causal: bool = True,
              kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              return_kv: bool = False, core=None):
    """GQA attention, x (B, S, D) → (B, S, D): causal self-attention by
    default, bidirectional with ``causal=False`` (the whisper encoder), and
    cross-attention over precomputed ``kv_override`` = (k, v) from
    :func:`cross_kv` (q rows and encoder rows are not aligned; the call
    has no mask).  ``return_kv`` also returns the (roped) K/V — the bulk
    prefill's cache source.  ``core`` (default :func:`attention_core`)
    computes the attention of q/k/v: training passes
    :func:`blockwise_core`."""
    if kv_override is None:
        q, k, v = qkv_proj(cfg, p, x, positions)
    else:
        q = _heads(cfg, x, p["wq"], cfg.n_heads)
        k, v = kv_override
    out = (core or attention_core)(q, k, v, causal=causal, window=cfg.window)
    y = out_proj(cfg, p, out, x.dtype)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (minicpm3)
# ---------------------------------------------------------------------------


def mla_scale(cfg: ModelConfig) -> float:
    """MLA's softmax scale, ``(qk_nope + qk_rope) ** -0.5``."""
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def mla_q(cfg: ModelConfig, p: Params, x: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → q (B, H, S, qk_nope + qk_rope) in the compute dtype:
    the low-rank ``w_dq``, its RMSNorm, ``w_uq``, and rope on the last
    ``qk_rope`` columns of each head."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cd = cdtype(cfg)
    q_lat = rms_norm(p["q_norm"], x.to(cd) @ p["w_dq"].to(cd), cfg.norm_eps)
    q = (q_lat @ p["w_uq"].to(cd)).reshape(b, s, h, dn + dr).transpose(1, 2)
    return torch.cat([q[..., :dn],
                      apply_rope(q[..., dn:], positions, cfg.rope_theta)],
                     dim=-1)


def mla_latent(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor):
    """x (B, S, D) → what MLA caches: the normed latent ``c_kv`` (B, S,
    kv_lora_rank) and the shared rope key (B, S, qk_rope), roped at
    ``positions``, both in the compute dtype."""
    r = cfg.kv_lora_rank
    cd = cdtype(cfg)
    dkv = x.to(cd) @ p["w_dkv"].to(cd)
    return (rms_norm(p["kv_norm"], dkv[..., :r], cfg.norm_eps),
            apply_rope(dkv[..., r:], positions, cfg.rope_theta))


def mla_expand(cfg: ModelConfig, p: Params, c_kv: torch.Tensor,
               k_rope: torch.Tensor):
    """The latent rows (B, S, r) and rope keys (B, S, qk_rope) → per-head
    k (B, H, S, qk_nope + qk_rope), contiguous, each head's rope columns
    the shared key, and v (B, H, S, v_head_dim), a transposed view of the
    ``w_uv`` product."""
    b, s, _ = c_kv.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    cd = cdtype(cfg)
    k_nope = (c_kv @ p["w_uk"].to(cd)).reshape(b, s, h, dn).transpose(1, 2)
    k = torch.cat([k_nope, k_rope[:, None].expand(b, h, s, dr)], dim=-1)
    v = (c_kv @ p["w_uv"].to(cd)).reshape(b, s, h, dv).transpose(1, 2)
    return k, v


def mla_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  positions: torch.Tensor, *, return_cache: bool = False,
                  core=None):
    """Multi-head latent attention, x (B, S, D) → (B, S, D), causal: q
    through its low-rank path, K/V expanded from the latent to every
    head (:func:`mla_expand`), attended at q/k head dim ``qk_nope +
    qk_rope`` and v head dim ``v_head_dim`` with :func:`mla_scale`, then
    ``wo``.  ``return_cache`` also returns the cache contents (``c_kv``
    (B, S, r), ``k_rope`` (B, S, qk_rope)); ``core`` is
    :func:`attention`'s."""
    q = mla_q(cfg, p, x, positions)
    c_kv, k_rope = mla_latent(cfg, p, x, positions)
    k, v = mla_expand(cfg, p, c_kv, k_rope)
    out = (core or attention_core)(q, k, v, causal=True,
                                   scale=mla_scale(cfg))
    y = out_proj(cfg, p, out, x.dtype)
    if return_cache:
        return y, (c_kv, k_rope)
    return y


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default
    if name == "relu2":
        r = torch.clamp_min(x, 0.0)
        return r * r
    raise ValueError(name)


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    cd = cdtype(cfg)
    xc = x.to(cd)
    up = xc @ p["w_up"].to(cd)
    if cfg.gated_mlp:
        up = _act(cfg.activation, xc @ p["w_gate"].to(cd)) * up
    else:
        up = _act(cfg.activation, up)
    return (up @ p["w_down"].to(cd)).to(x.dtype)


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity-based scatter dispatch per batch row
# ---------------------------------------------------------------------------


def top_k(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, largest first, a tie going to the lower index (a
    stable descending sort; ``torch.topk`` promises no order among
    ties on either device)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(cfg: ModelConfig, p: Params, xe: torch.Tensor) -> torch.Tensor:
    """xe (..., E, C, D) → (..., E, C, D): each expert's MLP on its rows.
    The rows are regrouped expert-major, (E, N·C, D), and multiplied by
    the (E, D, F) and (E, F, D) weights as they lie (``torch.bmm``): no
    expert weight is copied or cast when its type is the compute type."""
    *lead, e, c, d = xe.shape
    cd = cdtype(cfg)
    rows = xe.reshape(-1, e, c, d).transpose(0, 1).reshape(e, -1, d)
    up = torch.bmm(rows, p["w_up"].to(cd))
    if cfg.gated_mlp:
        up = _act(cfg.activation, torch.bmm(rows, p["w_gate"].to(cd))) * up
    else:
        up = _act(cfg.activation, up)
    out = torch.bmm(up, p["w_down"].to(cd))
    return out.reshape(e, -1, c, d).transpose(0, 1).reshape(*lead, e, c, d)


def moe_route(cfg: ModelConfig, router: torch.Tensor, xc: torch.Tensor):
    """Top-k routing and per-row capacity bookkeeping (the reference's
    ``moe_route``).  Logits are the fp32 product of the upcast rows with
    the fp32 router; the softmax runs in fp32; the top-k weights are
    renormalised over the k chosen (floor 1e-9: at k = 1 a weight is
    exactly 1).  Capacity is ``max(1, int(S·k/E·capacity_factor))`` a
    row; a choice's slot is the exclusive count of earlier choices of its
    expert over the token-major (S·k) choices, and a choice at or past
    capacity goes to the overflow bin ``E·cap``.

    Returns ``(weights (B, S, K) fp32, idx (B, S, K), keep (B, S, K)
    bool, dst (B, S, K), cap)``."""
    b, s, _ = xc.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    probs = torch.softmax(xc.float() @ router.float(), dim=-1)
    weights, idx = top_k(probs, k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(1, int(s * k / e * cfg.capacity_factor))
    flat = F.one_hot(idx, e).reshape(b, s * k, e)
    pos_in_e = torch.cumsum(flat, dim=1) - flat
    slot = pos_in_e.reshape(b, s, k, e).gather(-1, idx[..., None])[..., 0]
    keep = slot < cap
    dst = torch.where(keep, idx * cap + slot, e * cap)
    return weights, idx, keep, dst, cap


def moe_dispatch(xc: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
                 e: int, cap: int) -> torch.Tensor:
    """Scatter rows (B, S, D) into the per-expert capacity buffer (B, E,
    cap, D).  A kept choice owns its slot alone; a dropped one is written
    to a row of its own past the buffer (the reference adds it, times
    zero, into its overflow bin) and sliced away, so no index repeats and
    the result does not depend on the order of writes."""
    b, s, d = xc.shape
    k = dst.shape[-1]
    n = s * k
    spill = e * cap + torch.arange(n, device=xc.device)
    rows_dst = torch.where(keep.reshape(b, n), dst.reshape(b, n), spill)
    xin = xc.new_zeros(b, e * cap + n, d)
    src = xc[:, :, None, :].expand(b, s, k, d).reshape(b, n, d)
    xin[torch.arange(b, device=xc.device)[:, None], rows_dst] = src
    return xin[:, :e * cap].reshape(b, e, cap, d)


def moe_combine(ye: torch.Tensor, dst: torch.Tensor, keep: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Expert outputs (B, E, cap, D) back to token order, mixed by the
    router weights: ``weights · keep`` cast to the expert dtype, the k
    choices summed in it; a dropped choice reads the zero overflow row.
    Returns (B, S, D)."""
    b, e, cap, d = ye.shape
    s, k = dst.shape[1], dst.shape[2]
    flat = torch.cat([ye.reshape(b, e * cap, d), ye.new_zeros(b, 1, d)], 1)
    gathered = flat.gather(1, dst.reshape(b, s * k, 1).expand(b, s * k, d))
    mix = (weights * keep).to(ye.dtype)[..., None]
    return (gathered.reshape(b, s, k, d) * mix).sum(dim=2)


def moe(cfg: ModelConfig, p: Params, x: torch.Tensor,
        dense_combine: bool = False) -> torch.Tensor:
    """The MoE layer, x (B, S, D) → (B, S, D), routing and capacity per
    batch row (the reference's ``moe``): dropped choices fall through on
    the residual.  ``dense_combine=True`` (decode) runs every expert on
    every row and mixes by the fp32 (B, S, E) combine matrix cast to the
    compute dtype: a decode step reads every expert's weights either way.
    The shared expert (``mlp`` over ``p["shared"]``, ``d_ff ·
    n_shared_experts`` wide) adds after the routed sum."""
    b, s, d = x.shape
    e = cfg.n_experts
    cd = cdtype(cfg)
    xc = x.to(cd)
    if dense_combine:
        weights, idx, _, _, _ = moe_route(cfg, p["router"], xc)
        combine = torch.zeros(b, s, e, dtype=torch.float32,
                              device=x.device).scatter_(2, idx, weights)
        dense = _expert_ffn(cfg, p, xc[:, None].expand(b, e, s, d))
        y = torch.einsum("besd,bse->bsd", dense, combine.to(cd))
    else:
        weights, _, keep, dst, cap = moe_route(cfg, p["router"], xc)
        ye = _expert_ffn(cfg, p, moe_dispatch(xc, dst, keep, e, cap))
        y = moe_combine(ye, dst, keep, weights)
    if cfg.n_shared_experts:
        y = y + mlp(cfg, p["shared"], xc)
    return y.to(x.dtype)


def moe_aux_loss(cfg: ModelConfig, x: torch.Tensor, p: Params,
                 group=None) -> torch.Tensor:
    """Switch-style load-balancing loss over the whole batch: ``E · Σ_e
    f_e · p_e``, f the share of top-k choices and p the mean router
    probability of expert e.

    With a ``group`` whose ranks hold disjoint rows of the batch, the
    batch is the group's (the reference's GSPMD loss sees the logical
    global batch), and a product of local means is not the global one:
    the choice counts and the row count are summed over the group (they
    carry no gradient), and this rank returns its share ``E · Σ_e f_g[e]
    · Σ_local p[e] / N_g``.  The shares sum to the loss over the group's
    rows, and each rank's gradient through its own probabilities is
    exact."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    _, idx = top_k(probs, cfg.experts_per_token)
    hard = F.one_hot(idx, cfg.n_experts).sum(2).float()
    if group is None:
        return cfg.n_experts * (hard.mean((0, 1)) * probs.mean((0, 1))).sum()
    counts = torch.cat([hard.sum((0, 1)),
                        hard.new_full((1,), float(hard.shape[0]
                                                  * hard.shape[1]))])
    counts = group.all_reduce(counts)
    rows = counts[-1]
    return cfg.n_experts * ((counts[:-1] / rows)
                            * probs.sum((0, 1))).sum() / rows


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------


def chunk_slices(total: int, n: int) -> List[Tuple[int, int]]:
    """``n`` nearly equal, order-preserving ``(lo, hi)`` cuts of ``total``
    (copy of ``repro.core.pipeline.chunk_slices``)."""
    cuts = [round(i * total / n) for i in range(n + 1)]
    return [(lo, hi) for lo, hi in zip(cuts, cuts[1:]) if hi > lo]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  pad: bool = True) -> torch.Tensor:
    """Depthwise causal conv over the sequence.  x (B, S, C); w (K, C).

    The K shifted products are summed in fp32 and rounded once to x's
    dtype.  ``pad=False`` skips the leading (K−1) zero rows: the caller has
    prepended the raw rows that precede this slice (the chunked-prefill
    resume, and decode's (K)-row window, which gives one output row)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0)) if pad else x
    s_out = xp.shape[1] - k + 1
    wf = w.float()
    out = xp[:, 0:s_out].float() * wf[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s_out].float() * wf[i]
    return out.to(x.dtype) + b


def mamba2_block(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 return_state: bool = False,
                 init_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[torch.Tensor] = None):
    """x (B, S, D) → (B, S, D): in_proj → causal conv → SSD scan → gated
    RMSNorm → out_proj.  ``return_state`` also returns the decode cache
    contents: (final SSD state (B, H, N, P) fp32, conv tail (B, conv−1, C)
    of raw pre-conv rows).

    ``init_state``/``conv_state`` resume a mid-sequence forward (the
    chunked-prefill carry): the state seeds the scan, and the (conv−1) raw
    rows preceding this slice are prepended so the conv runs over the rows
    the bulk conv would see.  With ``cfg.ssm_stream_segments > 1`` the scan
    is fed in segments cut on ``ssm_chunk`` boundaries
    (:func:`~repro_torch.kernels.ssd.ssd_chunk_fed`)."""
    b, s, _ = x.shape
    h, p, g, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    d_in = h * p
    cd = cdtype(cfg)
    zxbcdt = x.to(cd) @ params["in_proj"].to(cd)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * g * n]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * g * n:]
    conv_w, conv_b = params["conv_w"].to(cd), params["conv_b"].to(cd)

    tail_len = cfg.ssm_conv - 1
    if conv_state is not None:
        if conv_state.shape[1] != tail_len:
            raise ValueError(f"conv_state rows {conv_state.shape[1]} != "
                             f"conv - 1 = {tail_len}")
        ext = torch.cat([conv_state.to(cd), xbc], dim=1)
        conv_tail = ext[:, ext.shape[1] - tail_len:]
        xbc = causal_conv1d(ext, conv_w, conv_b, pad=False)
    else:
        short = max(0, tail_len - s)
        tail_src = F.pad(xbc, (0, 0, short, 0)) if short else xbc
        conv_tail = tail_src[:, tail_src.shape[1] - tail_len:]
        xbc = causal_conv1d(xbc, conv_w, conv_b)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_in].reshape(b, s, h, p)
    bmat = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    cmat = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    dtv = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    d_skip = params["d_skip"].float()

    chunk = cfg.ssm_chunk
    n_seg = int(cfg.ssm_stream_segments or 0)
    if n_seg > 1 and s > chunk:
        full = s // chunk
        cuts = [(lo * chunk, hi * chunk)
                for lo, hi in chunk_slices(full, min(n_seg, full))]
        cuts[-1] = (cuts[-1][0], s)          # the ragged tail rides last

        def fetch(k):
            lo, hi = cuts[k]
            return xs[:, lo:hi], dtv[:, lo:hi], bmat[:, lo:hi], cmat[:, lo:hi]

        y, state = ssd_chunk_fed(fetch, len(cuts), a, d_skip, chunk=chunk,
                                 init_state=init_state)
    else:
        y, state = ssd(xs, dtv, a, bmat, cmat, d_skip, chunk=chunk,
                       init_state=init_state)

    y = y.reshape(b, s, d_in).to(cd)
    y = rms_norm(params["gate_norm"], y * F.silu(z), cfg.norm_eps)
    out = (y @ params["out_proj"].to(cd)).to(x.dtype)
    if return_state:
        return out, (state, conv_tail)
    return out
