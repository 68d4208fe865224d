"""Plain PyTorch versions of the SSD scan (Mamba-2's state-space duality).

* :func:`ssd_plain` — the chunked math of the reference's ``ssd_jnp``
  (``repro.models.layers``), the oracle of ``csrc/ssd.cu``: the CPU tests
  run it, and on the card ``chip_smoke.py`` holds the kernel to it.
* :func:`ssd_split` — the same scan split as ``csrc/ssd.cu`` splits it:
  every chunk's local state from a zero state, one ordered pass over the
  chunks, then each chunk's y from the state that entered it.
* :func:`ssd_bwd_plain` — the scan's gradient split as
  ``csrc/ssd_bwd.cu`` splits it (every chunk's dlocal, one reverse pass
  over the chunks, then each chunk's gradients): the oracle of the
  backward kernels, as ``ssd_split`` is of the forward.
* :func:`ssd_bwd_bf16_emulated` — ``ssd_bwd_plain`` with the roundings of
  the bf16 backward kernels (bf16 operands, fp32 operands split into bf16
  high and low parts, dB and dC summed over head tiles in order): the
  precision plan of the tensor-core path, held on the CPU.
* :func:`ssd_decode_step` — the single-token recurrence of serving decode
  (plain tensor code in the reference too).
* :func:`ssd_sequential` — the step-by-step recurrence, the definition both
  chunked forms must match; for tests only.

Shapes: x (B, S, H, P); dt (B, S, H) positive; a (H,) negative; b/c
(B, S, G, N) with head ``h`` in group ``h // (H // G)``; d (H,); state
(B, H, N, P) fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan from ``init_state`` (zeros when ``None``).  S is
    padded to a chunk multiple with dt = 0 and x = 0 rows, which is exact
    (decay 1, no injection).  Returns (y in x's dtype, final fp32 state)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hpg = h // g
    pad = (-s) % chunk
    if pad:
        x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    af = a.float()
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    ys = []
    for lo in range(0, x.shape[1], chunk):
        xf = x[:, lo:lo + chunk].float()
        dtf = dt[:, lo:lo + chunk].float()
        cum = torch.cumsum(dtf * af, dim=1)                     # (B, L, H)
        total = cum[:, -1]                                      # (B, H)
        bh = b[:, lo:lo + chunk].repeat_interleave(hpg, dim=2).float()
        ch = c[:, lo:lo + chunk].repeat_interleave(hpg, dim=2).float()
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # (B, L, L, H)
        seg = torch.where(causal, seg, torch.full_like(seg, -1e30))
        scores = torch.einsum("blhn,bmhn->blmh", ch, bh)
        w = scores * torch.exp(seg) * dtf[:, None, :, :]
        y = torch.einsum("blmh,bmhp->blhp", w, xf)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "blhn,bhnp->blhp", ch, state)
        decay_end = torch.exp(total[:, None] - cum) * dtf       # (B, L, H)
        state = torch.exp(total)[..., None, None] * state + torch.einsum(
            "blhn,blhp->bhnp", bh * decay_end[..., None], xf)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + d.float()[None, None, :, None] * x[:, :s].float()
    return y.to(x.dtype), state


def ssd_split(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan in the kernel's decomposition.  Every chunk k, at
    once: cum, total_k, u = exp(total_k - cum) dt and the local state
    local_k = (B u)^T X.  Then in chunk order: s_in[k] = state, state =
    exp(total_k) state + local_k.  Then every chunk at once: y = W X +
    exp(cum) (C s_in[k]) + d X.  ``local``, ``s_in`` and ``total`` are
    what the kernel keeps in its scratch (it stores ``s_in`` in x's dtype).
    Returns (y in x's dtype, final fp32 state)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hpg = h // g
    pad = (-s) % chunk
    if pad:
        x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bh = b.repeat_interleave(hpg, dim=2).float().reshape(bsz, nc, chunk, h, n)
    ch = c.repeat_interleave(hpg, dim=2).float().reshape(bsz, nc, chunk, h, n)
    cum = torch.cumsum(dtf * a.float(), dim=2)                 # (B, nc, L, H)
    total = cum[:, :, -1]                                       # (B, nc, H)
    u = torch.exp(total[:, :, None] - cum) * dtf
    local = torch.einsum("bklhn,bklhp->bkhnp", bh * u[..., None], xf)
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    s_in = []
    for k in range(nc):                                         # the pass
        s_in.append(state)
        state = torch.exp(total[:, k])[..., None, None] * state + local[:, k]
    s_in = torch.stack(s_in, dim=1)                             # (B, nc, H, N, P)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B, nc, L, L, H)
    seg = torch.where(causal, seg, torch.full_like(seg, -1e30))
    w = (torch.einsum("bklhn,bkmhn->bklmh", ch, bh) * torch.exp(seg)
         * dtf[:, :, None, :, :])
    y = torch.einsum("bklmh,bkmhp->bklhp", w, xf) + torch.exp(cum)[
        ..., None] * torch.einsum("bklhn,bkhnp->bklhp", ch, s_in)
    y = y.reshape(bsz, nc * chunk, h, p)[:, :s]
    y = y + d.float()[None, None, :, None] * x[:, :s].float()
    return y.to(x.dtype), state


def ssd_bwd_plain(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,
    s_in: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Gradient of :func:`ssd_plain` for the cotangents ``dy`` (of y) and
    ``dstate`` (of the final state; zeros when ``None``), in the kernel's
    decomposition.  Per chunk k, with cum, total, u = exp(total - cum) dt,
    F_lm = exp(cum_l - cum_m) [l >= m], S = C B^T and W = S F dt_m:

    (i) every chunk at once: dlocal_k = sum_l exp(cum_l) C_l^T dy_l (N, P);
    (ii) in reverse chunk order from ``dstate``: g_k, the gradient of chunk
    k's outgoing state, then ds_in[k] = exp(total_k) g_k + dlocal_k and
    g_{k-1} = ds_in[k]; the gradient of ``init_state`` is ds_in[0];
    (iii) every chunk at once: dx = W^T dy + u (B g_k) + d dy, dB = (dy
    x^T F dt)^T C + u (x g_k^T), dC = (dy x^T F dt) B + exp(cum) (dy
    s_in^T), and the gradient of cum from the decay factors, the state
    injection u and exp(total_k) <g_k, s_in[k]>;
    then ddt = the direct terms + a * (reverse cumsum of dcum), da =
    sum dt * (reverse cumsum of dcum), dd = sum dy x, and dB, dC summed
    over the heads of a group.  ``s_in`` (B, nc, H, N, P), the states
    entering each chunk, is recomputed in fp32 when ``None``.  (Mamba-2's
    public Triton backward, ``mamba_ssm/ops/triton/ssd_combined.py``,
    splits the gradient the same way.)

    Returns (dx in x's dtype, ddt fp32, da fp32, db and dc in b's dtype,
    dd fp32, d init_state fp32)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hpg = h // g
    pad = (-s) % chunk
    if pad:
        x, b, c, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    shape = (bsz, nc, chunk, h)
    xf = x.float().reshape(*shape, p)
    dyf = dy.float().reshape(*shape, p)
    dtf = dt.float().reshape(shape)
    bh = b.repeat_interleave(hpg, dim=2).float().reshape(*shape, n)
    ch = c.repeat_interleave(hpg, dim=2).float().reshape(*shape, n)
    af = a.float()
    cum = torch.cumsum(dtf * af, dim=2)                        # (B, nc, L, H)
    total = cum[:, :, -1]                                       # (B, nc, H)
    u = torch.exp(total[:, :, None] - cum) * dtf
    ec = torch.exp(cum)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(
        cum[:, :, :, None, :] - cum[:, :, None, :, :]),
        torch.zeros((), device=x.device))                       # F (B,nc,L,L,H)
    if s_in is None:
        local = torch.einsum("bklhn,bklhp->bkhnp", bh * u[..., None], xf)
        state = (torch.zeros((bsz, h, n, p), device=x.device)
                 if init_state is None else init_state.float())
        entering = []
        for k in range(nc):
            entering.append(state)
            state = torch.exp(total[:, k])[..., None, None] * state \
                + local[:, k]
        s_in = torch.stack(entering, dim=1)
    s_in = s_in.float()
    # (i) each chunk's output gradient carried to its entering state
    dlocal = torch.einsum("bklhn,bklhp->bkhnp", ch * ec[..., None], dyf)
    # (ii) the reverse pass
    gk = (torch.zeros((bsz, h, n, p), device=x.device) if dstate is None
          else dstate.float())
    outgoing = [None] * nc
    for k in reversed(range(nc)):
        outgoing[k] = gk
        gk = torch.exp(total[:, k])[..., None, None] * gk + dlocal[:, k]
    d_init = gk
    gs = torch.stack(outgoing, dim=1)                           # (B,nc,H,N,P)
    # (iii) every chunk's gradients
    scores = torch.einsum("bklhn,bkmhn->bklmh", ch, bh)         # S
    dw = torch.einsum("bklhp,bkmhp->bklmh", dyf, xf)            # dL/dW
    dtm = dtf[:, :, None, :, :]                                  # dt_m
    w = scores * decay * dtm
    ds = dw * decay * dtm                                       # dL/dS
    r = dw * scores * decay
    ddt = r.sum(dim=2)                                          # W's dt_m
    q = r * dtm
    dcum = q.sum(dim=3) - q.sum(dim=2)                          # exp(cum_l - cum_m)
    bg = torch.einsum("bkmhn,bkhnp->bkmhp", bh, gs)
    dx = (torch.einsum("bklmh,bklhp->bkmhp", w, dyf) + u[..., None] * bg
          + d.float()[:, None] * dyf)
    du = (xf * bg).sum(dim=-1)                                  # dL/du
    ddt = ddt + torch.exp(total[:, :, None] - cum) * du
    dcum = dcum - u * du
    dtotal = (u * du).sum(dim=2) + torch.exp(total) * (gs * s_in).sum(
        dim=(-1, -2))
    xg = torch.einsum("bkmhp,bkhnp->bkmhn", xf, gs)
    dbh = torch.einsum("bklmh,bklhn->bkmhn", ds, ch) + u[..., None] * xg
    inter = torch.einsum("bklhp,bkhnp->bklhn", dyf, s_in) * ec[..., None]
    dch = torch.einsum("bklmh,bkmhn->bklhn", ds, bh) + inter
    dcum = dcum + (ch * inter).sum(dim=-1)
    dcum[:, :, -1] += dtotal
    rc = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = ddt + af * rc
    da = (dtf * rc).sum(dim=(0, 1, 2))
    dd = (dyf * xf).sum(dim=(0, 1, 2, 4))

    def rows(t):
        return t.reshape(bsz, nc * chunk, *t.shape[3:])[:, :s]

    db = rows(dbh).reshape(bsz, s, g, hpg, n).sum(dim=3)
    dc = rows(dch).reshape(bsz, s, g, hpg, n).sum(dim=3)
    return (rows(dx).to(x.dtype), rows(ddt), da, db.to(b.dtype),
            dc.to(c.dtype), dd, d_init)


def _hi_lo(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``t`` as a bf16 high part and the bf16 rounding of what it leaves
    (the kernels' split of an fp32 operand), both as fp32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def ssd_bwd_bf16_emulated(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,
    s_in: Optional[torch.Tensor] = None,
    ht: int = 1,
) -> Tuple[torch.Tensor, ...]:
    """:func:`ssd_bwd_plain` rounded where the bf16 kernels of
    ``csrc/ssd_bwd.cu`` round, in fp32 otherwise.  x, b, c and dy are bf16
    (their values are the products' operands as they are).  Each fp32
    operand of a tensor-core product is its bf16 high part plus the bf16
    rounding of what that leaves: exp(cum) dy (dlocal, dC), g_k (the
    pass's output; B g_k, and u x g_kᵀ, whose u x is split too and whose
    low × low product is dropped), W and dS (dx, dB, dC) and chunk 0's
    entering state ``init_state``.  The states entering chunks 1.. are the
    forward's, kept in bf16 (``s_in``, recomputed and rounded when None);
    <g_k, s> takes g_k as high + low and chunk 0's state in fp32.  Each
    head's dB and dC are summed over a tile of ``ht`` heads of a group in
    head order, the tiles in order, and written in bf16 with dx.  Returns
    what :func:`ssd_bwd_plain` returns."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hpg = h // g
    pad = (-s) % chunk
    if pad:
        x, b, c, dy = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c, dy))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    shape = (bsz, nc, chunk, h)
    xf = x.float().reshape(*shape, p)
    dyf = dy.float().reshape(*shape, p)
    dtf = dt.float().reshape(shape)
    bh = b.repeat_interleave(hpg, dim=2).float().reshape(*shape, n)
    ch = c.repeat_interleave(hpg, dim=2).float().reshape(*shape, n)
    af = a.float()
    cum = torch.cumsum(dtf * af, dim=2)
    total = cum[:, :, -1]
    u = torch.exp(total[:, :, None] - cum) * dtf
    ec = torch.exp(cum)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(
        cum[:, :, :, None, :] - cum[:, :, None, :, :]),
        torch.zeros((), device=x.device))
    init = (torch.zeros((bsz, h, n, p), device=x.device) if init_state is None
            else init_state.float())
    if s_in is None:      # the forward's pass, its states kept in bf16
        local = torch.einsum("bklhn,bklhp->bkhnp", bh * u[..., None], xf)
        state, entering = init, []
        for k in range(nc):
            entering.append(state)
            state = torch.exp(total[:, k])[..., None, None] * state \
                + local[:, k]
        s_in = torch.stack(entering, dim=1).to(torch.bfloat16)
    s_exact = s_in.float().clone()
    s_exact[:, 0] = init                      # <g_k, s>: chunk 0 in fp32
    s_prod = s_exact.clone()
    s_prod[:, 0] = sum(_hi_lo(init))          # products: its two parts
    ey_hi, ey_lo = _hi_lo(dyf * ec[..., None])
    ey = ey_hi + ey_lo
    # (i) dlocal, (ii) the reverse pass in fp32, g_k kept as two parts
    dlocal = torch.einsum("bklhn,bklhp->bkhnp", ch, ey)
    gk = (torch.zeros((bsz, h, n, p), device=x.device) if dstate is None
          else dstate.float())
    outgoing = [None] * nc
    for k in reversed(range(nc)):
        outgoing[k] = gk
        gk = torch.exp(total[:, k])[..., None, None] * gk + dlocal[:, k]
    d_init = gk
    g_hi, g_lo = _hi_lo(torch.stack(outgoing, dim=1))
    g_kept = g_hi + g_lo
    # (iii) every chunk's gradients
    scores = torch.einsum("bklhn,bkmhn->bklmh", ch, bh)
    dw = torch.einsum("bklhp,bkmhp->bklmh", dyf, xf)
    dtm = dtf[:, :, None, :, :]
    w = sum(_hi_lo(scores * decay * dtm))
    ds = sum(_hi_lo(dw * decay * dtm))
    r = dw * scores * decay
    ddt = r.sum(dim=2)
    q = r * dtm
    dcum = q.sum(dim=3) - q.sum(dim=2)
    bg = torch.einsum("bkmhn,bkhnp->bkmhp", bh, g_kept)
    dx = (torch.einsum("bklmh,bklhp->bkmhp", w, dyf) + u[..., None] * bg
          + d.float()[:, None] * dyf)
    du = (xf * bg).sum(dim=-1)
    ddt = ddt + torch.exp(total[:, :, None] - cum) * du
    dcum = dcum - u * du
    dtotal = (u * du).sum(dim=2) + torch.exp(total) * (g_kept * s_exact).sum(
        dim=(-1, -2))
    ux_hi, ux_lo = _hi_lo(u[..., None] * xf)
    xg = (torch.einsum("bkmhp,bkhnp->bkmhn", ux_hi, g_kept)
          + torch.einsum("bkmhp,bkhnp->bkmhn", ux_lo, g_hi))
    dbh = torch.einsum("bklmh,bklhn->bkmhn", ds, ch) + xg
    dch = (torch.einsum("bklmh,bkmhn->bklhn", ds, bh)
           + torch.einsum("bklhp,bkhnp->bklhn", ey, s_prod))
    dcum = dcum + ec * (dyf * torch.einsum("bklhn,bkhnp->bklhp", ch,
                                           s_prod)).sum(dim=-1)
    dcum[:, :, -1] += dtotal
    rc = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = ddt + af * rc
    da = (dtf * rc).sum(dim=(0, 1, 2))
    dd = (dyf * xf).sum(dim=(0, 1, 2, 4))

    def rows(t):
        return t.reshape(bsz, nc * chunk, *t.shape[3:])[:, :s]

    def over_heads(t):        # (B, S, H, N): head tiles in order, then tiles
        t = rows(t).reshape(bsz, s, g, hpg, n)
        out = []
        for gi in range(g):
            tiles = []
            for lo in range(0, hpg, ht):
                acc = t[:, :, gi, lo]
                for j in range(lo + 1, min(lo + ht, hpg)):
                    acc = acc + t[:, :, gi, j]
                tiles.append(acc)
            tot = tiles[0]
            for tl in tiles[1:]:
                tot = tot + tl
            out.append(tot)
        return torch.stack(out, dim=2)

    return (rows(dx).to(x.dtype), rows(ddt), da, over_heads(dbh).to(b.dtype),
            over_heads(dch).to(c.dtype), dd, d_init)


def ssd_decode_step(
    state: torch.Tensor,   # (B, H, N, P) fp32
    xt: torch.Tensor,      # (B, H, P)
    dtt: torch.Tensor,     # (B, H)
    a: torch.Tensor,       # (H,)
    bt: torch.Tensor,      # (B, G, N)
    ct: torch.Tensor,      # (B, G, N)
    d: torch.Tensor,       # (H,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence.  Returns (state, y_t in xt's dtype)."""
    hpg = state.shape[1] // bt.shape[1]
    bh = bt.repeat_interleave(hpg, dim=1).float()               # (B, H, N)
    ch = ct.repeat_interleave(hpg, dim=1).float()
    decay = torch.exp(a.float()[None, :] * dtt)                 # (B, H)
    state = decay[..., None, None] * state + (
        dtt[..., None, None] * bh[..., :, None] * xt.float()[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", ch, state) + d[None, :, None] * xt
    return state, y.to(xt.dtype)


def ssd_sequential(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence one step at a time from a zero state (the reference's
    ``ssd_ref``).  Returns (y in x's dtype, final fp32 state)."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    hpg = h // b.shape[2]
    bh = b.repeat_interleave(hpg, dim=2).float()
    ch = c.repeat_interleave(hpg, dim=2).float()
    xf, dtf, af = x.float(), dt.float(), a.float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(af[None, :] * dtf[:, t])               # (B, H)
        state = decay[..., None, None] * state + (
            dtf[:, t, :, None, None] * bh[:, t, :, :, None]
            * xf[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    y = torch.stack(ys, dim=1) + d.float()[None, None, :, None] * xf
    return y.to(x.dtype), state
