"""Prefill into the decode cache: bulk, chunked, and to paged blocks.

The counterpart of the GQA ``ring`` (dense, vlm and moe), MLA ``latent``,
SSM ``state``, ``hybrid`` and ``encdec`` carries of
``repro.models.prefill``.
Ring fill: the cache keeps the last ``sb`` positions, position ``p`` at
slot ``p % sb``; for a prompt shorter than ``sb`` the tail slots stay empty
(``slot_pos = −1``).

Chunked prefill writes each chunk's K/V into a full-length scratch and
attends the chunk's rows against it at ``q_offset = lo`` — the flash
kernel takes that offset, so on the card bulk and chunked prefill both run
through it (the reference gates chunks to its blockwise jnp path, whose
result, ``blockwise_attention(q_offset=lo)``, is what is computed here).
Scratch updates are in place.

MoE rides the ``ring`` carry with **chunk-local capacity**, as the
reference: ``layers.moe_route`` bookkeeps capacity over the rows it sees,
the whole prompt in bulk and the chunk's rows alone in a chunk, so the two
drop different (token, expert) choices wherever an expert overflows
(``chunk_carry_spec`` declares the carry inexact).
:func:`moe_chunk_agree_mask` names the rows whose keep decisions differ;
where they agree everywhere (a ``capacity_factor`` of at least
``n_experts``) chunked prefill computes bulk's function.

The ``latent`` carry of MLA (minicpm3) is a full-length scratch of the
latent rows ``ckv`` and shared rope keys ``krope`` a layer: each chunk
writes its rows at ``lo``, expands rows ``[0, hi)`` to per-head K/V
(``layers.mla_expand``) and attends at ``q_offset = lo`` through the flash
kernel at q/k head dim 96 and v head dim 64.  The reference expands the
whole scratch and masks the zero rows past the chunk; expanding only the
rows a chunk can see is the same function (tests hold the two at 1e-5).
The finished scratch ring-fills into ``ckv``/``krope``.

The ``state`` carry of the SSM family is constant-size: per layer the SSD
state and the (conv−1) raw pre-conv rows.  Each chunk resumes every layer
from its pair (the SSD kernel's ``init_state`` and a conv over [tail ‖
chunk rows]), and the finished carry is the decode cache itself.  Chunk
cuts land on ``ssm_chunk`` multiples, so the scan walks the chunks a bulk
prefill walks.

The ``hybrid`` carry (zamba2) is the two together: the ``state`` pair of
every Mamba-2 layer, and a full-length K/V scratch a shared application
(each application attends against its own rows, through the flash kernel
at ``q_offset = lo`` as the dense family does), ring-filled into the
application's cache at the end.

A VLM's prompt is its ``frontend_tokens`` projected patch rows, then its
text: the patches take positions ``0 … N−1`` of the same ring (rope, the
scratch rows and ``slot_pos`` count them), and a chunk's rows ``[lo, hi)``
of that sequence carry the patches and tokens that fall in them.

The ``encdec`` carry (whisper): bulk prefill and chunk 0 run the encoder
once over the request's frames and keep each decoder layer's cross K/V
(``cross_k``/``cross_v``, ``encoder_seq`` rows, never a ring); later
chunks attend against them.  The decoder's self-attention K/V stream like
the ``ring`` kind, without rope (positions are the learned ``dec_pos``
rows added to the embeddings).  Both the encoder's bidirectional
attention and the cross-attention run through the flash kernel
unmasked.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, chunk_carry_spec
from repro_torch.models import layers as L
from repro_torch.models.decode import kv_buf_len, kv_stacks, ssm_cache
from repro_torch.models.model import (
    _embed,
    _lm_logits,
    cross_block_tail,
    decoder_embed,
    encode,
    ffn,
    hybrid_order,
    shared_block,
)

Params = Dict[str, Any]
Cache = Dict[str, Any]


def _slot_map(s: int, sb: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (pos_for_slot (sb,) int32 with −1 empty, gather_idx (sb,))."""
    j = torch.arange(sb, device=device)
    if s >= sb:
        pos = s - sb + torch.remainder(j - s, sb)
        return pos.to(torch.int32), pos
    pos = torch.where(j < s, j, -1)
    return pos.to(torch.int32), pos.clamp_min(0)


def _ring_fill(seq_t: torch.Tensor, sb: int, seq_axis: int) -> torch.Tensor:
    """Scatter a (..., S, ...) sequence tensor into its ring-buffer layout."""
    s = seq_t.shape[seq_axis]
    slot_pos, idx = _slot_map(s, sb, seq_t.device)
    filled = seq_t.index_select(seq_axis, idx)
    if s < sb:
        # zero the empty tail so the cache holds no garbage (masked anyway)
        shape = [1] * seq_t.ndim
        shape[seq_axis] = sb
        filled = torch.where((slot_pos >= 0).reshape(shape), filled,
                             torch.zeros((), dtype=filled.dtype,
                                         device=filled.device))
    return filled


def _dense_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                 positions: torch.Tensor, sb: int,
                 moe_ffn: Optional[Callable] = None):
    """One dense (or MoE) block over the prompt: (x, its K/V ring-filled
    to ``sb`` slots in the param dtype).  A MoE layer's capacity is
    bookkept over the whole prompt, a row at a time; ``moe_ffn`` is the
    expert-parallel runner in its place."""
    dt = L.pdtype(cfg)
    normed = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
    a, (k, v) = L.attention(cfg, lp["attn"], normed, positions,
                            return_kv=True)
    x = x + a
    x = x + ffn(cfg, lp, L.rms_norm(lp["ln2"], x, cfg.norm_eps),
                moe_ffn=moe_ffn)
    return (x, _ring_fill(k, sb, seq_axis=2).to(dt),
            _ring_fill(v, sb, seq_axis=2).to(dt))


def _prefill_gqa(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 positions: torch.Tensor, sb: int,
                 moe_ffn: Optional[Callable] = None):
    ks, vs = [], []
    for lp in params["layers"]:
        x, k, v = _dense_layer(cfg, lp, x, positions, sb, moe_ffn)
        ks.append(k)
        vs.append(v)
    slot_pos, _ = _slot_map(x.shape[1], sb, x.device)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs),
               "slot_pos": slot_pos}


def _prefill_mla(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 positions: torch.Tensor, sb: int):
    """Every MLA block over the prompt, each keeping its latent rows and
    rope keys ring-filled to ``sb`` slots in the param dtype."""
    dt = L.pdtype(cfg)
    cks, krs = [], []
    for lp in params["layers"]:
        normed = L.rms_norm(lp["ln1"], x, cfg.norm_eps)
        a, (ckv, krope) = L.mla_attention(cfg, lp["attn"], normed, positions,
                                          return_cache=True)
        x = x + a
        x = x + L.mlp(cfg, lp["mlp"], L.rms_norm(lp["ln2"], x, cfg.norm_eps))
        cks.append(_ring_fill(ckv, sb, seq_axis=1).to(dt))
        krs.append(_ring_fill(krope, sb, seq_axis=1).to(dt))
    slot_pos, _ = _slot_map(x.shape[1], sb, x.device)
    return x, {"ckv": torch.stack(cks), "krope": torch.stack(krs),
               "slot_pos": slot_pos}


def _ssm_layer(cfg: ModelConfig, params: Params, x: torch.Tensor, li: int,
               states: Optional[torch.Tensor] = None,
               tails: Optional[torch.Tensor] = None):
    """x through Mamba-2 layer ``li``, resuming from its carried (SSD
    state, conv tail) pair when ``states``/``tails`` (L, B, ...) are given
    — updated in place — or from zeros.  Returns (x, state, tail)."""
    lp = params["layers"][li]
    normed = L.rms_norm(lp["ln"], x, cfg.norm_eps)
    o, (st, cv) = L.mamba2_block(
        cfg, lp["mamba"], normed, return_state=True,
        init_state=None if states is None else states[li],
        conv_state=None if tails is None else tails[li])
    if states is not None:
        states[li] = st
        tails[li] = cv
    return x + o, st, cv


def _ssm_stack(cfg: ModelConfig, params: Params, x: torch.Tensor,
               states: Optional[torch.Tensor] = None,
               tails: Optional[torch.Tensor] = None):
    """x through every Mamba-2 layer (:func:`_ssm_layer`).  Returns
    (x, [(state, tail)])."""
    out = []
    for li in range(len(params["layers"])):
        x, st, cv = _ssm_layer(cfg, params, x, li, states, tails)
        out.append((st, cv))
    return x, out


def _prefill_hybrid(cfg: ModelConfig, params: Params, x: torch.Tensor,
                    positions: torch.Tensor, sb: int):
    """The hybrid's blocks in order: each Mamba-2 layer keeps its state
    pair, each shared application its own ring-filled K/V."""
    dt = L.pdtype(cfg)
    pairs = [None] * cfg.n_layers
    ks, vs = [], []
    for kind, i in hybrid_order(cfg):
        if kind == "ssm":
            x, st, cv = _ssm_layer(cfg, params, x, i)
            pairs[i] = (st, cv.to(dt))
        else:
            x, k, v = _dense_layer(cfg, shared_block(cfg, params, i), x,
                                   positions, sb)
            ks.append(k)
            vs.append(v)
    slot_pos, _ = _slot_map(x.shape[1], sb, x.device)
    return x, {"ssm_state": torch.stack([st for st, _ in pairs]),
               "conv_state": torch.stack([cv for _, cv in pairs]),
               "attn_k": torch.stack(ks), "attn_v": torch.stack(vs),
               "slot_pos": slot_pos}


def _prefill_encdec(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                    frontend_embeds: torch.Tensor, sb: int):
    """The encoder once, then every decoder layer keeping its self K/V
    (ring-filled) and its cross K/V of the encoder output."""
    dt = L.pdtype(cfg)
    enc = encode(cfg, params, frontend_embeds)
    x = decoder_embed(params, tokens)
    dpos = torch.arange(x.shape[1], device=x.device)
    ks, vs, xks, xvs = [], [], [], []
    for lp in params["dec_layers"]:
        a, (k, v) = L.attention(cfg, lp["attn"],
                                L.apply_norm(cfg, lp["ln1"], x), dpos,
                                return_kv=True)
        kv = L.cross_kv(cfg, lp["xattn"], enc)
        x = cross_block_tail(cfg, lp, x + a, kv)
        ks.append(_ring_fill(k, sb, seq_axis=2).to(dt))
        vs.append(_ring_fill(v, sb, seq_axis=2).to(dt))
        xks.append(kv[0].to(dt))
        xvs.append(kv[1].to(dt))
    slot_pos, _ = _slot_map(x.shape[1], sb, x.device)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs),
               "cross_k": torch.stack(xks), "cross_v": torch.stack(xvs),
               "slot_pos": slot_pos}


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None, *,
            cache_len: Optional[int] = None,
            moe_ffn: Optional[Callable] = None
            ) -> Tuple[Cache, torch.Tensor]:
    """Run the prompt (B, S), build the decode cache, return next-token
    logits (B, V).  ``frontend_embeds``: a VLM's patches (B, N,
    frontend_dim), which take the first N rows, or the encoder-decoder's
    frames (B, S_enc, frontend_dim).  ``cache_len``: ring capacity
    (default: the rows prefilled; the SSM cache has none).

    ``moe_ffn`` runs a MoE model's layers by expert parallelism
    (``models/moe_ep.py``) on a rank that holds E/n experts and its own
    rows of the batch: routing and capacity are per row, so the result
    is ``layers.moe``'s on the same rows."""
    if moe_ffn is not None and cfg.family != "moe":
        raise ValueError(f"{cfg.name}: moe_ffn= is for the moe family")
    if cfg.family == "encdec":
        sb = kv_buf_len(cfg, cache_len or tokens.shape[1])
        x, cache = _prefill_encdec(cfg, params, tokens, frontend_embeds, sb)
        return (_finish_cache(cache, tokens.shape[0], tokens.shape[1],
                              x.device), _chunk_logits(cfg, params, x))
    if cfg.family == "vlm" and frontend_embeds is None:
        raise ValueError(f"{cfg.name} needs patch embeddings")
    x = _embed(cfg, params, tokens, frontend_embeds)
    s_total = x.shape[1]
    if cfg.family == "ssm":
        x, pairs = _ssm_stack(cfg, params, x)
        dt = L.pdtype(cfg)
        cache = {"ssm_state": torch.stack([st for st, _ in pairs]),
                 "conv_state": torch.stack([cv.to(dt) for _, cv in pairs])}
    else:
        sb = kv_buf_len(cfg, cache_len or s_total)
        positions = torch.arange(s_total, device=x.device)
        if cfg.family == "hybrid":
            x, cache = _prefill_hybrid(cfg, params, x, positions, sb)
        elif cfg.attn_type == "mla":
            x, cache = _prefill_mla(cfg, params, x, positions, sb)
        else:
            x, cache = _prefill_gqa(cfg, params, x, positions, sb, moe_ffn)
    return (_finish_cache(cache, tokens.shape[0], s_total, x.device),
            _chunk_logits(cfg, params, x))


def _finish_cache(cache: Cache, batch: int, s_total: int, device) -> Cache:
    """Stamp the per-slot position bookkeeping (every row at ``s_total``)."""
    cache["pos"] = torch.full((batch,), s_total, dtype=torch.int32,
                              device=device)
    if "slot_pos" in cache:
        cache["slot_pos"] = cache["slot_pos"].expand(
            batch, cache["slot_pos"].shape[-1]).contiguous()
    return cache


# ---------------------------------------------------------------------------
# chunked streamed prefill
# ---------------------------------------------------------------------------


def chunk_support(cfg: ModelConfig) -> Tuple[bool, str]:
    """Whether streamed prefill can run, with the reason if not.  The
    flash kernel takes ``q_offset``, so the ``ring`` carry of the dense,
    vlm and moe families (MoE's with chunk-local capacity: inexact, as
    ``chunk_carry_spec`` declares), MLA's ``latent`` carry, the
    ``hybrid`` carry and the ``encdec`` carry always chunk, and the SSM
    ``state`` carry has no attention."""
    kind = chunk_carry_spec(cfg).kind
    if (kind, cfg.family) not in (("ring", "dense"), ("ring", "vlm"),
                                  ("ring", "moe"),
                                  ("latent", "dense"), ("state", "ssm"),
                                  ("hybrid", "hybrid"),
                                  ("encdec", "encdec")):
        return False, f"the {kind!r} chunk carry of {cfg.family} is not ported"
    return True, ""


def prefill_rows(cfg: ModelConfig, n_tokens: int) -> int:
    """Prefill rows of an ``n_tokens``-token prompt: a VLM's patch rows
    come before its text in the same sequence; the encoder-decoder's
    frames feed the encoder, not the decoder's rows."""
    if cfg.frontend and cfg.family != "encdec":
        return n_tokens + cfg.frontend_tokens
    return n_tokens


def chunk_rows(cfg: ModelConfig, lo: int, hi: int
               ) -> Tuple[slice, Optional[slice]]:
    """Which token rows and which frontend rows prefill rows ``[lo, hi)``
    take: a VLM's patches are rows ``[0, N)`` and its text the rest; the
    encoder-decoder's rows are its tokens, and its frames go whole with
    chunk 0.  Returns (token slice, frontend slice or None)."""
    if cfg.family == "encdec":
        return slice(lo, hi), (slice(None) if lo == 0 else None)
    if cfg.frontend:
        n = cfg.frontend_tokens
        return (slice(max(0, lo - n), max(0, hi - n)),
                slice(lo, min(hi, n)) if lo < n else None)
    return slice(lo, hi), None


def prefill_chunk_cuts(s_total: int, chunk_len: Optional[int] = None,
                       n_chunks: Optional[int] = None, *,
                       multiple: int = 1) -> List[Tuple[int, int]]:
    """``(lo, hi)`` chunk boundaries over a prompt of ``s_total``:
    fixed-size chunks (``chunk_len``, ragged tail) or near-equal cuts
    (``n_chunks``); interior cuts land on multiples of ``multiple``."""
    m = max(1, int(multiple))
    if chunk_len:
        c = -(-max(1, int(chunk_len)) // m) * m
        return [(lo, min(lo + c, s_total)) for lo in range(0, s_total, c)]
    cuts = L.chunk_slices(s_total, max(1, int(n_chunks or 1)))
    if m > 1 and len(cuts) > 1:
        snapped = sorted({(hi // m) * m for _, hi in cuts[:-1]})
        edges = [0] + [b for b in snapped if 0 < b < s_total] + [s_total]
        cuts = list(zip(edges[:-1], edges[1:]))
    return cuts


def init_prefill_scratch(cfg: ModelConfig, batch: int, prompt_len: int,
                         device) -> Cache:
    """The carry one incremental prefill writes into: for the ``ring``
    kind a full-length K/V scratch (L, B, Hkv, S, hd) in the compute dtype
    (the cast to the cache's param dtype happens at the ring fill, as in
    bulk); for the ``state`` kind the constant-size SSD state (fp32) and
    conv tail (compute dtype), ``prompt_len`` unused; for the ``hybrid``
    kind both: the state pair of every layer and a K/V scratch
    (n_apps, B, Hkv, S, hd) a shared application, named ``attn_k`` and
    ``attn_v``; for the ``encdec`` kind the decoder's K/V scratch and the
    cross K/V (L, B, Hkv, encoder_seq, hd) chunk 0 fills; for the
    ``latent`` kind (MLA) the latent rows ``ckv`` (L, B, S, kv_lora_rank)
    and rope keys ``krope`` (L, B, S, qk_rope) in the compute dtype.  A
    VLM's ``prompt_len`` counts its patch rows."""
    ok, why = chunk_support(cfg)
    if not ok:
        raise ValueError(f"{cfg.name}: {why}")
    cd = L.cdtype(cfg)
    pos = {"pos": torch.zeros(batch, dtype=torch.int32, device=device)}
    if cfg.attn_type == "mla":
        return {**{name: torch.zeros((cfg.n_layers, batch, prompt_len, width),
                                     dtype=cd, device=device)
                   for name, width in (("ckv", cfg.kv_lora_rank),
                                       ("krope", cfg.qk_rope_dim))}, **pos}
    carry = {}
    if cfg.family in ("ssm", "hybrid"):
        carry = ssm_cache(cfg, batch, device)
        carry["conv_state"] = carry["conv_state"].to(cd)
        if cfg.family == "ssm":
            return {**carry, **pos}
    names, depth = kv_stacks(cfg)
    shape = (depth, batch, cfg.n_kv_heads, prompt_len, cfg.resolved_head_dim)
    if cfg.family == "encdec":
        xshape = shape[:3] + (cfg.encoder_seq, shape[4])
        carry = {n: torch.zeros(xshape, dtype=cd, device=device)
                 for n in ("cross_k", "cross_v")}
    return {**carry, **{n: torch.zeros(shape, dtype=cd, device=device)
                        for n in names}, **pos}


def _chunk_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     kbuf: torch.Tensor, vbuf: torch.Tensor,
                     lo: int) -> torch.Tensor:
    """``layers.attention`` for chunk rows at ``[lo, lo+C)``: the chunk's
    K/V are written into the scratch in place, and q attends against the
    whole scratch at ``q_offset = lo``."""
    c = x.shape[1]
    positions = lo + torch.arange(c, device=x.device)
    q, k, v = L.qkv_proj(cfg, p, x, positions)
    kbuf[:, :, lo:lo + c] = k
    vbuf[:, :, lo:lo + c] = v
    out = L.attention_core(q, kbuf, vbuf, causal=True, window=cfg.window,
                           q_offset=lo)
    return L.out_proj(cfg, p, out, x.dtype)


def _chunk_dense_layer(cfg: ModelConfig, lp: Params, h: torch.Tensor,
                       kbuf: torch.Tensor, vbuf: torch.Tensor,
                       lo: int) -> torch.Tensor:
    """One dense (or MoE) block over chunk rows, its K/V scratch written
    in place.  A MoE layer's capacity is bookkept over the chunk's rows
    alone (chunk-local, as the reference)."""
    normed = L.apply_norm(cfg, lp["ln1"], h)
    h = h + _chunk_attention(cfg, lp["attn"], normed, kbuf, vbuf, lo)
    return h + ffn(cfg, lp, L.apply_norm(cfg, lp["ln2"], h))


def _chunk_mla_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                         cbuf: torch.Tensor, kbuf: torch.Tensor,
                         lo: int) -> torch.Tensor:
    """``layers.mla_attention`` for chunk rows at ``[lo, hi)``: the
    chunk's latent rows and rope keys are written into the scratch in
    place, rows ``[0, hi)`` expanded to per-head K/V, and q attends
    against them at ``q_offset = lo``."""
    hi = lo + x.shape[1]
    positions = torch.arange(lo, hi, device=x.device)
    q = L.mla_q(cfg, p, x, positions)
    cbuf[:, lo:hi], kbuf[:, lo:hi] = L.mla_latent(cfg, p, x, positions)
    k, v = L.mla_expand(cfg, p, cbuf[:, :hi], kbuf[:, :hi])
    out = L.attention_core(q, k, v, causal=True, scale=L.mla_scale(cfg),
                           q_offset=lo)
    return L.out_proj(cfg, p, out, x.dtype)


def _chunk_encdec(cfg: ModelConfig, params: Params, scratch: Cache,
                  tokens: torch.Tensor, lo: int,
                  frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Decoder rows ``[lo, lo+C)`` of an encoder-decoder.  Chunk 0 runs
    the encoder over the frames and writes every layer's cross K/V into
    the scratch; later chunks attend against those rows."""
    enc = None
    if lo == 0:
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: chunk 0 needs the frames")
        enc = encode(cfg, params, frontend_embeds)
    h = decoder_embed(params, tokens, lo)
    for li, lp in enumerate(params["dec_layers"]):
        normed = L.apply_norm(cfg, lp["ln1"], h)
        h = h + _chunk_attention(cfg, lp["attn"], normed, scratch["k"][li],
                                 scratch["v"][li], lo)
        if enc is not None:
            k1, v1 = L.cross_kv(cfg, lp["xattn"], enc)
            scratch["cross_k"][li] = k1
            scratch["cross_v"][li] = v1
        h = cross_block_tail(cfg, lp, h, (scratch["cross_k"][li],
                                          scratch["cross_v"][li]))
    return h


def _chunk_logits(cfg: ModelConfig, params: Params,
                  h: torch.Tensor) -> torch.Tensor:
    x = L.apply_norm(cfg, params["final_norm"], h[:, -1:, :])
    return _lm_logits(cfg, params, x)[:, 0]


def prefill_chunk(cfg: ModelConfig, params: Params, scratch: Cache,
                  tokens: torch.Tensor, lo: int,
                  frontend_embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[Cache, torch.Tensor]:
    """One incremental prefill chunk over rows ``[lo, hi)`` of the prompt:
    ``tokens`` (B, C) are its token rows and ``frontend_embeds`` a VLM's
    patch rows that fall in it (they come first; either may be empty), or
    the encoder-decoder's whole frames on chunk 0 (its rows are its
    ``tokens``).  Updates ``scratch`` in place; returns it and the chunk's
    next-token logits (meaningful after the final chunk)."""
    if cfg.family == "encdec":
        h = _chunk_encdec(cfg, params, scratch, tokens, lo, frontend_embeds)
        scratch["pos"] = torch.full_like(scratch["pos"], lo + h.shape[1])
        return scratch, _chunk_logits(cfg, params, h)
    h = _embed(cfg, params, tokens, frontend_embeds)
    if cfg.family == "ssm":
        h, _ = _ssm_stack(cfg, params, h, scratch["ssm_state"],
                          scratch["conv_state"])
    elif cfg.attn_type == "mla":
        for li, lp in enumerate(params["layers"]):
            h = h + _chunk_mla_attention(
                cfg, lp["attn"], L.rms_norm(lp["ln1"], h, cfg.norm_eps),
                scratch["ckv"][li], scratch["krope"][li], lo)
            h = h + L.mlp(cfg, lp["mlp"],
                          L.rms_norm(lp["ln2"], h, cfg.norm_eps))
    elif cfg.family == "hybrid":
        for kind, i in hybrid_order(cfg):
            if kind == "ssm":
                h, _, _ = _ssm_layer(cfg, params, h, i, scratch["ssm_state"],
                                     scratch["conv_state"])
            else:
                h = _chunk_dense_layer(cfg, shared_block(cfg, params, i), h,
                                       scratch["attn_k"][i],
                                       scratch["attn_v"][i], lo)
    else:
        for li, lp in enumerate(params["layers"]):
            h = _chunk_dense_layer(cfg, lp, h, scratch["k"][li],
                                   scratch["v"][li], lo)
    scratch["pos"] = torch.full_like(scratch["pos"], lo + h.shape[1])
    return scratch, _chunk_logits(cfg, params, h)


def scratch_to_cache(cfg: ModelConfig, scratch: Cache,
                     cache_len: Optional[int] = None) -> Cache:
    """A completed prefill scratch → the decode-cache layout of
    :func:`prefill` (ring fill, cast to the param dtype).  The ``state``
    carry already is the cache; the ``hybrid`` carry keeps its state pairs
    and ring-fills its applications' K/V; the ``encdec`` carry keeps its
    cross K/V as they are; the ``latent`` carry ring-fills its latent rows
    and rope keys."""
    dt = L.pdtype(cfg)
    if cfg.attn_type == "mla":
        ckv = scratch["ckv"]
        batch, s = ckv.shape[1], ckv.shape[2]
        sb = kv_buf_len(cfg, cache_len or s)
        cache = {n: _ring_fill(scratch[n], sb, seq_axis=2).to(dt)
                 for n in ("ckv", "krope")}
        cache["slot_pos"] = _slot_map(s, sb, ckv.device)[0]
        return _finish_cache(cache, batch, s, ckv.device)
    cache = {}
    if cfg.family == "encdec":
        cache = {n: scratch[n].to(dt) for n in ("cross_k", "cross_v")}
    if cfg.family in ("ssm", "hybrid"):
        cache = {"ssm_state": scratch["ssm_state"],
                 "conv_state": scratch["conv_state"].to(dt)}
        if cfg.family == "ssm":
            return {**cache, "pos": scratch["pos"]}
    names, _ = kv_stacks(cfg)
    kbuf = scratch[names[0]]
    batch, s = kbuf.shape[1], kbuf.shape[3]
    sb = kv_buf_len(cfg, cache_len or s)
    for n in names:
        cache[n] = _ring_fill(scratch[n], sb, seq_axis=3).to(dt)
    cache["slot_pos"] = _slot_map(s, sb, kbuf.device)[0]
    return _finish_cache(cache, batch, s, kbuf.device)


def moe_chunk_agree_mask(cfg: ModelConfig, moe_params: Params,
                         x: torch.Tensor, cuts: List[Tuple[int, int]]):
    """The MoE chunk-local capacity bound, stated operationally (the
    reference's ``moe_chunk_agree_mask``).  ``x`` (B, S, D): one MoE
    layer's input rows; ``cuts``: the chunk boundaries.  Returns
    ``(agree (B, S), keep_bulk (B, S, K), keep_chunk (B, S, K))``: the
    keep decisions with capacity bookkept over S and per chunk, and
    where they agree for every choice of a token.  Routing and the
    renormalised weights are per row, so this layer's output is equal at
    every token where ``agree`` holds; the whole forward is exact when it
    holds everywhere at every layer (e.g. ``capacity_factor ≥
    n_experts``)."""
    xc = x.to(L.cdtype(cfg))
    keep_bulk = L.moe_route(cfg, moe_params["router"], xc)[2]
    keep_chunk = torch.cat(
        [L.moe_route(cfg, moe_params["router"], xc[:, lo:hi])[2]
         for lo, hi in cuts], dim=1)
    return (keep_bulk == keep_chunk).all(-1), keep_bulk, keep_chunk


# ---------------------------------------------------------------------------
# paged KV block pool: slot cache <-> pool blocks
# ---------------------------------------------------------------------------


def cache_to_blocks(cfg: ModelConfig, slot_cache: Cache, block_size: int):
    """A batch-1 ring cache → ``(blocks_k, blocks_v, slot_pos_row,
    pos_row)`` with blocks (L, sb/blk, Hkv, blk, hd): a reshape of the ring
    layout, so the block-table gather gives the contiguous cache back."""
    k = slot_cache["k"]
    nl, b1, hkv, sb, hd = k.shape
    if b1 != 1:
        raise ValueError(f"cache_to_blocks takes a batch-1 cache, got {b1}")
    if sb % block_size:
        raise ValueError(
            f"block_size {block_size} must divide the ring extent {sb}")
    npb = sb // block_size

    def split(a):
        return a[:, 0].reshape(nl, hkv, npb, block_size, hd).transpose(1, 2)

    return (split(k), split(slot_cache["v"]),
            slot_cache["slot_pos"][0], slot_cache["pos"][0])


def scratch_to_blocks(cfg: ModelConfig, scratch: Cache, block_size: int,
                      cache_len: Optional[int] = None):
    """:func:`scratch_to_cache` composed with :func:`cache_to_blocks`."""
    return cache_to_blocks(cfg, scratch_to_cache(cfg, scratch, cache_len),
                           block_size)


def seed_scratch_from_blocks(cfg: ModelConfig, scratch: Cache,
                             blocks_k: torch.Tensor,
                             blocks_v: torch.Tensor) -> Cache:
    """Restore positions ``[0, m·blk)`` of a fresh scratch from ``m`` cached
    prefix blocks (L, m, Hkv, blk, hd), in place — the prefix-cache hit."""
    nl, m, hkv, blk, hd = blocks_k.shape
    for name, blocks in (("k", blocks_k), ("v", blocks_v)):
        flat = blocks.transpose(1, 2).reshape(nl, hkv, m * blk, hd)
        scratch[name][:, :, :, :m * blk] = flat[:, None]
    return scratch
