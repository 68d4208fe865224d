"""Serving decode: the K/V ring cache, the paged block pool, the SSM state
cache, the hybrid's pair of them and one decode step.

The counterpart of the dense and MoE GQA, MLA, ``ssm``, ``hybrid`` and
``encdec`` paths of ``repro.models.decode``; a MoE layer decodes its one
token a row with ``layers.moe(dense_combine=True)``, every expert on
every row, or by expert parallelism (``decode_step(moe_runner=)``: the
rank's rows sent to the ranks that hold their experts).  The layouts are
the reference's:

* contiguous cache ``k``/``v`` (L, B, Hkv, S_buf, hd) in the param dtype,
  with per-row ``pos`` (B,) and ``slot_pos`` (B, S_buf) (−1 = empty); ring
  slot ``p % S_buf`` holds position ``p``;
* paged cache ``kp``/``vp`` (L, N_blocks, Hkv, blk, hd) plus the per-slot
  table ``block_ids`` (B, S_buf/blk); blocks ``[0, B)`` are the rows'
  parking blocks;
* MLA cache (minicpm3): the latent ``ckv`` (L, B, S_buf, kv_lora_rank)
  and the shared rope key ``krope`` (L, B, S_buf, qk_rope) a layer, with
  ``pos`` and ``slot_pos`` (contiguous only, as in the reference): 288
  values a token and layer at full width, where per-head K/V would take
  40 × (96 + 64);
* SSM cache ``ssm_state`` (L, B, H, N, P) fp32 and ``conv_state``
  (L, B, conv−1, C) of raw pre-conv rows in the param dtype, with ``pos``:
  constant size, whatever the sequence length (no paged layout);
* hybrid cache (zamba2): the SSM cache of every Mamba-2 layer plus one
  K/V ring ``attn_k``/``attn_v`` (n_apps, B, Hkv, S_buf, hd) a shared
  *application* (the parameters are shared, the caches are not), with
  ``pos`` and ``slot_pos`` (contiguous only, as in the reference);
* encdec cache (whisper): the decoder's self-attention ring ``k``/``v``
  (capped at :data:`ENCDEC_DECODER_CAP` slots) and the encoder's cross
  K/V ``cross_k``/``cross_v`` (L, B, Hkv, encoder_seq, hd), written once
  at prefill (contiguous only, as in the reference).

Where the reference returns a new cache from a donated one, the port
updates the cache tensors in place and returns the same dict.  Decode
attention (MLA's absorbed form over the latent too) and the one-token SSD
recurrence are plain tensor code (jnp in the reference too).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, serving_features
from repro_torch.kernels.ssd import ssd_decode_step
from repro_torch.models import layers as L
from repro_torch.models.model import (
    _lm_logits,
    ffn,
    hybrid_order,
    n_applications,
    shared_block,
)

#: decoder self-attention ring cap of the encoder-decoder (whisper)
ENCDEC_DECODER_CAP = 4096

Params = Dict[str, Any]
Cache = Dict[str, Any]


def kv_buf_len(cfg: ModelConfig, max_seq: int) -> int:
    """Ring extent of the K/V cache: the SWA window caps it, and the
    encoder-decoder's decoder caps at :data:`ENCDEC_DECODER_CAP`."""
    if cfg.family == "encdec":
        return min(max_seq, ENCDEC_DECODER_CAP)
    return min(max_seq, cfg.window) if cfg.window else max_seq


def ssm_cache(cfg: ModelConfig, batch: int, device) -> Cache:
    """Zero SSD state (fp32, as the scan accumulates) and conv tail."""
    conv_ch = (cfg.ssm_heads * cfg.ssm_head_dim
               + 2 * cfg.ssm_groups * cfg.ssm_state)
    return {
        "ssm_state": torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
             cfg.ssm_head_dim), dtype=torch.float32, device=device),
        "conv_state": torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_conv - 1, conv_ch),
            dtype=L.pdtype(cfg), device=device),
    }


def kv_stacks(cfg: ModelConfig) -> Tuple[Tuple[str, str], int]:
    """Names and depth of the attention K/V stacks of the cache and the
    prefill scratch: ``k``/``v`` a layer (dense), ``attn_k``/``attn_v`` a
    shared application (hybrid)."""
    if cfg.family == "hybrid":
        return ("attn_k", "attn_v"), n_applications(cfg)
    return ("k", "v"), cfg.n_layers


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> Cache:
    cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=device)}
    if cfg.family in ("ssm", "hybrid"):
        cache.update(ssm_cache(cfg, batch, device))
        if cfg.family == "ssm":
            return cache
    sb = kv_buf_len(cfg, max_seq)
    if cfg.attn_type == "mla":
        for name, width in (("ckv", cfg.kv_lora_rank),
                            ("krope", cfg.qk_rope_dim)):
            cache[name] = torch.zeros((cfg.n_layers, batch, sb, width),
                                      dtype=L.pdtype(cfg), device=device)
    else:
        names, depth = kv_stacks(cfg)
        shape = (depth, batch, cfg.n_kv_heads, sb, cfg.resolved_head_dim)
        for name in names:
            cache[name] = torch.zeros(shape, dtype=L.pdtype(cfg),
                                      device=device)
    if cfg.family == "encdec":
        xshape = shape[:3] + (cfg.encoder_seq, shape[4])
        for name in ("cross_k", "cross_v"):
            cache[name] = torch.zeros(xshape, dtype=L.pdtype(cfg),
                                      device=device)
    cache["slot_pos"] = torch.full((batch, sb), -1, dtype=torch.int32,
                                   device=device)
    return cache


def supports_paged(cfg: ModelConfig) -> bool:
    return serving_features(cfg)["paged"]


def paged_slot_blocks(cfg: ModelConfig, max_seq: int, block_size: int) -> int:
    """Blocks per slot; ``block_size`` must divide the ring extent."""
    sb = kv_buf_len(cfg, max_seq)
    if sb % block_size:
        raise ValueError(
            f"block_size {block_size} must divide kv_buf_len {sb}")
    return sb // block_size


def init_paged_cache(cfg: ModelConfig, batch: int, max_seq: int,
                     block_size: int, n_blocks: int, device) -> Cache:
    """Shared block pool + per-slot block tables, every row parked on its
    own block ``b``."""
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name} has no paged-cache layout")
    sb = kv_buf_len(cfg, max_seq)
    npb = paged_slot_blocks(cfg, max_seq, block_size)
    if n_blocks < batch:
        raise ValueError(f"n_blocks {n_blocks} < batch {batch}: every row "
                         f"needs a parking block")
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size,
             cfg.resolved_head_dim)
    rows = torch.arange(batch, dtype=torch.int32, device=device)
    return {
        "pos": torch.zeros(batch, dtype=torch.int32, device=device),
        "slot_pos": torch.full((batch, sb), -1, dtype=torch.int32,
                               device=device),
        "kp": torch.zeros(shape, dtype=L.pdtype(cfg), device=device),
        "vp": torch.zeros(shape, dtype=L.pdtype(cfg), device=device),
        "block_ids": rows[:, None].expand(batch, npb).contiguous(),
    }


def gather_blocks(pool: torch.Tensor, block_ids: torch.Tensor) -> torch.Tensor:
    """pool (N, Hkv, blk, hd) + table (B, npb) → the contiguous-layout copy
    (B, Hkv, npb·blk, hd) — exactly the contiguous ring's values."""
    g = pool[block_ids.long()]                      # (B, npb, Hkv, blk, hd)
    b, npb, hkv, blk, hd = g.shape
    return g.transpose(1, 2).reshape(b, hkv, npb * blk, hd)


def scatter_block_rows(pool: torch.Tensor, block_ids: torch.Tensor,
                       new: torch.Tensor, slot: torch.Tensor) -> None:
    """Write each row's new K/V (B, Hkv, hd) at ring slot ``slot`` (B,) into
    its pool block, in place (the reference returns an updated pool)."""
    blk = pool.shape[2]
    slot = slot.long()
    bid = block_ids.long().gather(1, (slot // blk)[:, None])[:, 0]
    pool[bid, :, slot % blk, :] = new.to(pool.dtype)


def _valid_slots(slot_pos: torch.Tensor, pos: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """Per-row key validity: ``slot_pos`` (B, S_buf) against ``pos`` (B,)."""
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window is not None:
        valid &= slot_pos > (pos - window)[:, None]
    return valid


def _row_update(buf: torch.Tensor, new: torch.Tensor,
                slot: torch.Tensor) -> None:
    """Write ``new`` (B, Hkv, hd) into ``buf`` (B, Hkv, S_buf, hd) at the
    per-row ring slot ``slot`` (B,), in place."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, :, slot.long(), :] = new.to(buf.dtype)


def _masked_softmax_attend(scores: torch.Tensor, vcache: torch.Tensor,
                           slot_pos: torch.Tensor, pos: torch.Tensor,
                           window: Optional[int]) -> torch.Tensor:
    """scores (B, Hkv, G, S_buf) fp32; vcache (B, Hkv, S_buf, hd)."""
    valid = _valid_slots(slot_pos, pos, window)
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    m = scores.amax(-1, keepdim=True)
    p = torch.where(scores <= -1e29, torch.zeros_like(scores),
                    torch.exp(scores - m))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bkgs,bksd->bkgd", p, vcache.float())


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     kc: torch.Tensor, vc: torch.Tensor,
                     slot_pos: torch.Tensor, pos: torch.Tensor,
                     window: Optional[int] = None,
                     rope: bool = True) -> torch.Tensor:
    """x (B, D) one token per row at ``pos`` (B,).  Writes the row's K/V
    into ``kc``/``vc`` (B, Hkv, S_buf, hd) in place; returns (B, D).
    ``rope=False``: the encoder-decoder's decoder (no rope)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hkv, hq = cfg.n_kv_heads, cfg.n_heads
    cd = L.cdtype(cfg)
    xc = x.to(cd)
    q = (xc @ p["wq"].to(cd)).reshape(b, hq, hd)
    k = (xc @ p["wk"].to(cd)).reshape(b, hkv, hd)
    v = (xc @ p["wv"].to(cd)).reshape(b, hkv, hd)
    if rope:
        posv = pos[:, None, None]
        q = L.apply_rope(q[:, :, None, :], posv, cfg.rope_theta)[:, :, 0]
        k = L.apply_rope(k[:, :, None, :], posv, cfg.rope_theta)[:, :, 0]

    slot = pos % kc.shape[2]
    _row_update(kc, k, slot)
    _row_update(vc, v, slot)
    qg = q.reshape(b, hkv, hq // hkv, hd).float() * hd ** -0.5
    scores = torch.einsum("bkgd,bksd->bkgs", qg, kc.float())
    out = _masked_softmax_attend(scores, vc, slot_pos, pos, window)
    out = out.reshape(b, hq * hd).to(cd)
    return (out @ p["wo"].to(cd)).to(x.dtype)


def cross_attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                           kc: torch.Tensor, vc: torch.Tensor) -> torch.Tensor:
    """x (B, D) one token per row against the static cross K/V ``kc``/
    ``vc`` (B, Hkv, S_enc, hd): every encoder row is visible."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    hkv, hq = cfg.n_kv_heads, cfg.n_heads
    cd = L.cdtype(cfg)
    q = (x.to(cd) @ p["wq"].to(cd)).reshape(b, hkv, hq // hkv, hd)
    scores = torch.einsum("bkgd,bksd->bkgs", q.float() * hd ** -0.5,
                          kc.float())
    pr = torch.exp(scores - scores.amax(-1, keepdim=True))
    pr = pr / pr.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgs,bksd->bkgd", pr, vc.float())
    out = out.reshape(b, hq * hd).to(cd)
    return (out @ p["wo"].to(cd)).to(x.dtype)


def mla_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               ckv: torch.Tensor, krope: torch.Tensor,
               slot_pos: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MLA's absorbed decode: x (B, D) one token per row at ``pos`` (B,).
    Writes the row's latent and rope key into ``ckv`` (B, S_buf, r) and
    ``krope`` (B, S_buf, qk_rope) in place, then attends over the latent
    itself: ``q_nope · W_uk`` per head against ``ckv``, plus the roped q
    against ``krope``, in fp32 over every whole ring (as the reference),
    and the latent output through ``W_uv``.  Returns (B, D)."""
    b = x.shape[0]
    h, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    cd = L.cdtype(cfg)
    posv = pos[:, None, None]
    q = L.mla_q(cfg, p, x[:, None, :], posv)[:, :, 0]     # (B, H, dn + dr)
    q_eff = torch.einsum("bhd,rhd->bhr", q[..., :dn],
                         p["w_uk"].to(cd).reshape(r, h, dn))   # absorb W_uk
    c_new, kr_new = L.mla_latent(cfg, p, x[:, None, :], posv[:, 0])
    rows = torch.arange(b, device=x.device)
    slot = (pos % ckv.shape[1]).long()
    ckv[rows, slot] = c_new[:, 0].to(ckv.dtype)
    krope[rows, slot] = kr_new[:, 0].to(krope.dtype)
    cf = ckv.float()
    scores = (torch.einsum("bhr,bsr->bhs", q_eff.float(), cf)
              + torch.einsum("bhd,bsd->bhs", q[..., dn:].float(),
                             krope.float())) * L.mla_scale(cfg)
    valid = _valid_slots(slot_pos, pos, None)
    scores = scores.masked_fill(~valid[:, None, :], -1e30)
    m = scores.amax(-1, keepdim=True)
    pr = torch.where(scores <= -1e29, torch.zeros_like(scores),
                     torch.exp(scores - m))
    pr = pr / pr.sum(-1, keepdim=True).clamp_min(1e-30)
    out_lat = torch.einsum("bhs,bsr->bhr", pr, cf)
    out = torch.einsum("bhr,rhd->bhd", out_lat.to(cd),
                       p["w_uv"].to(cd).reshape(r, h, dv))    # absorb W_uv
    return (out.reshape(b, h * dv) @ p["wo"].to(cd)).to(x.dtype)


def mamba2_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """One Mamba-2 token.  x (B, D); ssm_state (B, H, N, P) fp32;
    conv_state (B, conv−1, C).  Returns (out (B, D), ssm_state,
    conv_state), the states new tensors."""
    b = x.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    d_in = h * pd
    cd = L.cdtype(cfg)
    zxbcdt = x.to(cd) @ p["in_proj"].to(cd)
    z = zxbcdt[:, :d_in]
    xbc_new = zxbcdt[:, d_in:2 * d_in + 2 * g * n]
    dt_raw = zxbcdt[:, 2 * d_in + 2 * g * n:]

    # the conv window is [conv_state ; xbc_new]: one VALID output row
    win = torch.cat([conv_state.to(cd), xbc_new[:, None, :]], dim=1)
    conv_out = F.silu(L.causal_conv1d(win, p["conv_w"].to(cd),
                                      p["conv_b"].to(cd), pad=False)[:, 0])
    xs = conv_out[:, :d_in].reshape(b, h, pd)
    bmat = conv_out[:, d_in:d_in + g * n].reshape(b, g, n)
    cmat = conv_out[:, d_in + g * n:].reshape(b, g, n)
    dtv = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())

    ssm_state, y = ssd_decode_step(ssm_state, xs, dtv, a, bmat, cmat,
                                   p["d_skip"].float())
    y = y.reshape(b, d_in).to(cd)
    y = L.rms_norm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return (y @ p["out_proj"].to(cd)).to(x.dtype), ssm_state, win[:, 1:]


def _ssm_one(cfg: ModelConfig, params: Params, cache: Cache,
             x: torch.Tensor, li: int) -> torch.Tensor:
    """Mamba-2 layer ``li`` on one token a row, its state updated in place."""
    lp = params["layers"][li]
    normed = L.rms_norm(lp["ln"], x, cfg.norm_eps)
    o, st, cv = mamba2_decode(cfg, lp["mamba"], normed,
                              cache["ssm_state"][li], cache["conv_state"][li])
    cache["ssm_state"][li] = st
    cache["conv_state"][li] = cv
    return x + o


def _decode_ssm(cfg: ModelConfig, params: Params, cache: Cache,
                x: torch.Tensor) -> torch.Tensor:
    for li in range(cfg.n_layers):
        x = _ssm_one(cfg, params, cache, x, li)
    return x


def _stamp_slot(cache: Cache, pos: torch.Tensor) -> torch.Tensor:
    """Mark each row's ring slot ``pos % S_buf`` as holding ``pos`` (once a
    step, before any layer attends); returns the slots (B,)."""
    rows = torch.arange(pos.shape[0], device=pos.device)
    slot = (pos % cache["slot_pos"].shape[1]).long()
    cache["slot_pos"][rows, slot] = pos
    return slot


def _decode_hybrid(cfg: ModelConfig, params: Params, cache: Cache,
                   x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 layers and, after each group, the shared application
    ``g`` attending over its own cache ``attn_k[g]``/``attn_v[g]`` with
    block ``g % n_shared``'s parameters (no window, as the reference)."""
    _stamp_slot(cache, pos)
    for kind, i in hybrid_order(cfg):
        if kind == "ssm":
            x = _ssm_one(cfg, params, cache, x, i)
            continue
        sp = shared_block(cfg, params, i)
        x = x + attention_decode(
            cfg, sp["attn"], L.rms_norm(sp["ln1"], x, cfg.norm_eps),
            cache["attn_k"][i], cache["attn_v"][i], cache["slot_pos"], pos)
        x = x + L.mlp(cfg, sp["mlp"], L.rms_norm(sp["ln2"], x, cfg.norm_eps))
    return x


def _decode_mla(cfg: ModelConfig, params: Params, cache: Cache,
                x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Every MLA layer on one token a row, each over its own latent ring
    ``ckv[li]``/``krope[li]`` (no window, as the reference)."""
    _stamp_slot(cache, pos)
    for li, lp in enumerate(params["layers"]):
        x = x + mla_decode(cfg, lp["attn"],
                           L.rms_norm(lp["ln1"], x, cfg.norm_eps),
                           cache["ckv"][li], cache["krope"][li],
                           cache["slot_pos"], pos)
        x = x + L.mlp(cfg, lp["mlp"], L.rms_norm(lp["ln2"], x, cfg.norm_eps))
    return x


def _decode_gqa(cfg: ModelConfig, params: Params, cache: Cache,
                x: torch.Tensor, pos: torch.Tensor,
                moe_runner: Optional[Any] = None) -> torch.Tensor:
    rows = torch.arange(x.shape[0], device=x.device)
    slot = _stamp_slot(cache, pos)
    slot_pos = cache["slot_pos"]
    paged = "kp" in cache

    for li, lp in enumerate(params["layers"]):
        if paged:
            # gather the block-table view, run the identical contiguous
            # attention on it, scatter only the new row back into the pool
            bids = cache["block_ids"]
            kc = gather_blocks(cache["kp"][li], bids)
            vc = gather_blocks(cache["vp"][li], bids)
        else:
            kc, vc = cache["k"][li], cache["v"][li]
        normed = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
        x = x + attention_decode(cfg, lp["attn"], normed, kc, vc, slot_pos,
                                 pos, window=cfg.window)
        if paged:
            scatter_block_rows(cache["kp"][li], bids, kc[rows, :, slot, :],
                               slot)
            scatter_block_rows(cache["vp"][li], bids, vc[rows, :, slot, :],
                               slot)
        normed = L.rms_norm(lp["ln2"], x, cfg.norm_eps)[:, None]
        x = x + ffn(cfg, lp, normed, dense_combine=True,
                    moe_ffn=moe_runner)[:, 0]
    return x


def _decode_encdec(cfg: ModelConfig, params: Params, cache: Cache,
                   x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The decoder at ``pos``: the learned position ``dec_pos[min(pos,
    4095)]`` added, then each layer's self-attention over its ring (no
    rope), cross-attention over its cross K/V and the MLP."""
    dec_pos = params["dec_pos"]
    x = x + dec_pos[pos.long().clamp_max(dec_pos.shape[0] - 1)].to(x.dtype)
    _stamp_slot(cache, pos)
    for li, lp in enumerate(params["dec_layers"]):
        x = x + attention_decode(
            cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], x), cache["k"][li],
            cache["v"][li], cache["slot_pos"], pos, rope=False)
        x = x + cross_attention_decode(
            cfg, lp["xattn"], L.apply_norm(cfg, lp["ln_x"], x),
            cache["cross_k"][li], cache["cross_v"][li])
        x = x + L.mlp(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], x))
    return x


def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, *,
                moe_runner: Optional[Any] = None
                ) -> Tuple[Cache, torch.Tensor]:
    """tokens (B,) → (cache, logits (B, V) fp32).  Every row advances at
    its own ``pos``; the cache is updated in place.  A VLM decodes as the
    dense family (its patches are rows of the cache), a MoE model with
    every expert on every row (``dense_combine``), or, with
    ``moe_runner`` (``models/moe_ep.build_moe_ep_runner(decode=True)``),
    by expert parallelism: this rank's B rows batched with the group's
    through the conduit all-to-all, one slot a routed expert, the
    dense-combine decode's values."""
    if moe_runner is not None and cfg.family != "moe":
        raise ValueError(f"{cfg.name}: moe_runner= is for the moe family")
    pos = cache["pos"]
    x = params["embed"][tokens]                              # (B, D)
    if cfg.family == "ssm":
        x = _decode_ssm(cfg, params, cache, x)
    elif cfg.family == "hybrid":
        x = _decode_hybrid(cfg, params, cache, x, pos)
    elif cfg.family == "encdec":
        x = _decode_encdec(cfg, params, cache, x, pos)
    elif cfg.attn_type == "mla":
        x = _decode_mla(cfg, params, cache, x, pos)
    else:
        x = _decode_gqa(cfg, params, cache, x, pos, moe_runner)
    cache["pos"] = pos + 1
    x = L.apply_norm(cfg, params["final_norm"], x)
    return cache, _lm_logits(cfg, params, x[:, None, :])[:, 0]
