"""SSD scan wrapper: the CUDA kernels for CUDA tensors, the plain versions
for CPU tensors, and nothing in between.

``ssd`` checks device, dtypes, shapes and strides, picks the head and P
tiles of a block (:func:`ssd_plan`), allocates y, the final state and,
for more than one chunk, the chunk-state scratch with ``torch.empty``
(nothing syncs the host), and launches ``csrc/ssd.cu`` on the current
stream.  x, b and c may be strided views (the model passes slices
of the conv output, whose row stride is the conv width) as long as their
last dim is contiguous; a ragged S is handled inside the kernel, so
nothing is padded or copied.  When autograd records and an input
requires grad, the same forward runs inside a ``torch.autograd.Function``
that keeps the states entering each chunk (the forward's ``s_in``
scratch, in x's type) and whose backward is :func:`ssd_bwd`
(``csrc/ssd_bwd.cu``); otherwise (every serving call) the forward is
launched directly and keeps nothing.  ``ssd_chunk_fed`` runs the scan
over a sequence delivered in segments, carrying the state from one call
to the next through ``init_state`` (and its gradient back the same way).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.common import CudaKernel, launch_on
from repro_torch.kernels.ssd.ref import ssd_bwd_plain, ssd_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory one block may take on Hopper (227 KB)
SMEM_LIMIT = 232_448
#: the longest chunk the kernel takes (two 64-row tiles a block)
MAX_CHUNK = 128
MODE_STATE, MODE_OUT, MODE_BOTH = 1, 2, 3
#: P tiles the plan tries
_P_TILES = (64, 32)
#: the largest state size N and head dim P the backward takes (its
#: products' outputs are 128 rows of a block's register tiles)
BWD_MAX_NP = 128
#: CUDA kernels one backward call runs, in both dtypes: dlocal, the reverse
#: pass over the states, the chunks, the reduction over heads
SSD_BWD_KERNELS = 4
#: what the last backward call on the card launched: heads a block (the
#: kernel's clamp of the plan to a group's heads; fp32 takes 1) and blocks
#: of its dlocal and chunks kernels
BWD_LAUNCHED: dict = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SSD = CudaKernel(
    "ssd", "repro_ssd_fwd",
    [_I] + [_P] * 12 + [_I] * 10 + [_L] * 12 + [_P])
SSD_BWD = CudaKernel(
    "ssd/ssd_bwd", "repro_ssd_bwd",
    [_I] + [_P] * 23 + [_I] * 9 + [_L] * 12 + [_P])


def block_smem(chunk: int, n: int, pt: int, ht: int, dtype, nc: int) -> int:
    """The most shared memory one block of ``ssd_chunks`` takes in the
    modes a call of ``nc`` chunks launches (one chunk: both at once; more:
    state, then out), as the kernel lays it out: the library's own
    ``repro_ssd_smem_bytes(dtype, mode, chunk, n, pt, ht)``."""
    smem = SSD.symbol("repro_ssd_smem_bytes", [_I] * 6)
    modes = (MODE_BOTH,) if nc == 1 else (MODE_STATE, MODE_OUT)
    return max(smem(_DTYPES[dtype], m, chunk, n, pt, ht) for m in modes)


_SMS = {}


def _sm_count(device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


#: shared memory of one SM (228 KB), of which each block also takes 1 KB
SM_SMEM = 233_472


@functools.lru_cache(maxsize=512)
def ssd_plan(bsz: int, s: int, h: int, g: int, n: int, p: int, chunk: int,
             dtype, sms: int = 132) -> Optional[Tuple[int, int]]:
    """(heads a block, P columns a block) for a call: the plan whose grid
    takes the least modelled time, waves × (heads + 1) × (P columns + 32)
    (a block's time grows with its heads, plus its C·Bᵀ, and with its P
    tile, plus its B/C loads), where a wave is as many blocks as fit on the
    card at once (bf16: two an SM where shared memory allows; fp32: one) and
    the blocks fit in shared memory in every mode the call launches (one
    chunk: both at once; more: state, then out).  Ties go to the larger P
    tile, then the larger head tile.  None when nothing fits."""
    nc = -(-s // chunk)
    hpg = h // g
    best = None
    for pt in _P_TILES:
        if pt == 64 and p <= 32:
            continue
        for ht in range(1, min(hpg, 32) + 1):
            smem = block_smem(chunk, n, pt, ht, dtype, nc)
            if smem > SMEM_LIMIT:
                continue
            occ = min(2 if dtype == torch.bfloat16 else 1,
                      SM_SMEM // (smem + 1024))
            blocks = bsz * nc * g * -(-hpg // ht) * -(-p // pt)
            waves = -(-blocks // (sms * occ))
            key = (waves * (ht + 1) * (pt + 32), -pt, -ht)
            if best is None or key < best[0]:
                best = (key, ht, pt)
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=64)
def bwd_occupancy(chunk: int, n: int, p: int, dtype) -> Tuple[int, int]:
    """Blocks of the backward's dlocal and chunks kernels that fit one SM
    at once, by the library's occupancy query (registers and shared
    memory as built and launched)."""
    occ = (ctypes.c_int * 2)()
    fn = SSD_BWD.symbol("repro_ssd_bwd_occupancy", [_I] * 4 + [_P])
    SSD_BWD.check(fn(_DTYPES[dtype], chunk, n, p, occ))
    return occ[0], occ[1]


def bwd_smem(chunk: int, n: int, p: int, dtype) -> Tuple[int, int]:
    """Dynamic shared memory of one block of the backward's dlocal and
    chunks kernels, as the library lays them out."""
    fn = SSD_BWD.symbol("repro_ssd_bwd_smem_bytes", [_I] * 5)
    return tuple(fn(_DTYPES[dtype], kern, chunk, n, p) for kern in (0, 1))


@functools.lru_cache(maxsize=512)
def ssd_bwd_plan(bsz: int, s: int, h: int, g: int, n: int, p: int,
                 chunk: int, dtype, sms: int = 132, occ: int = 1) -> int:
    """Heads a block of the bf16 backward (dlocal and the chunks kernel):
    the head tile whose grid takes the least modelled time, waves × (heads
    + 1) (a block's time grows with its heads, plus its B and C loads and
    its dB and dC stores), a wave ``sms × occ`` blocks (``occ``, blocks an
    SM, from :func:`bwd_occupancy`); ties go to the larger tile (fewer dB
    and dC partials).  1 for fp32, whose kernels take one head a block."""
    if dtype != torch.bfloat16:
        return 1
    nc = -(-s // chunk)
    hpg = h // g
    best = None
    for ht in range(1, hpg + 1):
        blocks = bsz * nc * g * -(-hpg // ht)
        key = (-(-blocks // (sms * occ)) * (ht + 1), -ht)
        if best is None or key < best[0]:
            best = (key, ht)
    return best[1]


def bwd_scratch(bsz: int, s: int, h: int, g: int, n: int, p: int,
                chunk: int, dtype, ht: int) -> dict:
    """The backward's scratch as {name: (shape, dtype)}: dlocal (fp32),
    g_k's bf16 high and low parts (bf16 only), the chunk totals, each head
    tile's dB and dC (fp32: each head's) and the da/dd partials."""
    nc = -(-s // chunk)
    tiles = h if dtype != torch.bfloat16 else g * -(-(h // g) // ht)
    out = dict(gbuf=((bsz, nc, h, n, p), torch.float32),
               total=((bsz, nc, h), torch.float32),
               dbh=((bsz, s, tiles, n), torch.float32),
               dch=((bsz, s, tiles, n), torch.float32),
               part=((bsz, nc, h, 2), torch.float32))
    if dtype == torch.bfloat16:
        out["ghl"] = ((bsz, nc, h, 2, n, p), torch.bfloat16)
    return out


def bwd_scratch_bytes(bsz: int, s: int, h: int, g: int, n: int, p: int,
                      chunk: int, dtype, ht: int) -> Tuple[int, int]:
    """(bytes of scratch a backward call allocates, a model of the bytes
    of it the call moves, not a measurement): each buffer written once and
    read once, except fp32's dlocal, which the pass rewrites in place as
    g_k and the chunks kernel reads (four times)."""
    sizes = {k: torch.Size(shape).numel() * dt.itemsize
             for k, (shape, dt) in bwd_scratch(bsz, s, h, g, n, p, chunk,
                                               dtype, ht).items()}
    moved = 2 * sum(sizes.values())
    if dtype != torch.bfloat16:
        moved += 2 * sizes["gbuf"]
    return sum(sizes.values()), moved


def _aligned16(*ts: torch.Tensor) -> bool:
    """Base and strides of every view a multiple of 16 bytes: the kernel
    copies them by TMA (bf16, chunk 64 or 128) or 16-byte cp.async, else
    element by element."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st, sz in zip(t.stride()[:-1], t.shape[:-1])
                       if sz > 1)
               for t in ts)


def _check(x, dt, a, b, c, d, chunk, init_state) -> None:
    """What the kernels take: raises on anything else."""
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)} b {tuple(b.shape)} "
                         f"c {tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if b.shape[:2] != (bsz, s) or dt.shape != (bsz, s, h) \
            or a.shape != (h,) or d.shape != (h,):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} a {tuple(a.shape)} b "
                         f"{tuple(b.shape)} d {tuple(d.shape)}")
    if bsz == 0 or s == 0 or g == 0 or h % g:
        raise ValueError(f"ssd: batch {bsz}, seq {s}, heads {h}, groups {g}")
    if chunk <= 0 or chunk % 4 or n % 8 or p % 4:
        raise ValueError(f"ssd: chunk {chunk} and head dim {p} must be "
                         f"multiples of 4, state size {n} of 8")
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd: chunk {chunk} > {MAX_CHUNK}: the kernel "
                         f"takes a chunk in at most two 64-row tiles")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd: x/b/c dtypes {x.dtype}, {b.dtype}, {c.dtype}; "
                        f"supported: float32 or bfloat16, alike")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 \
            or d.dtype != torch.float32:
        raise TypeError(f"ssd: dt, a, d must be float32 ({dt.dtype}, "
                        f"{a.dtype}, {d.dtype})")
    if any(t.device != x.device for t in (dt, a, b, c, d)):
        raise ValueError("ssd: inputs on different devices")
    if x.stride(3) != 1 or b.stride(3) != 1 or c.stride(3) != 1:
        raise ValueError("ssd: the last dim of x, b and c must be contiguous")
    if init_state is not None:
        if init_state.shape != (bsz, h, n, p) \
                or init_state.dtype != torch.float32 \
                or init_state.device != x.device \
                or not init_state.is_contiguous():
            raise ValueError(
                f"ssd: init_state must be a contiguous float32 "
                f"{(bsz, h, n, p)} tensor on {x.device}, got "
                f"{init_state.dtype} {tuple(init_state.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _strides(x, dt, b, c) -> Tuple[int, ...]:
    return (x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            b.stride(0), b.stride(1), b.stride(2),
            c.stride(0), c.stride(1), c.stride(2))


def _on16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it whose data starts on 16 bytes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, dt, a, b, c, d, chunk, init_state):
    """The forward kernel on CUDA tensors: (y, final state, s_in), s_in the
    (B, nc, H, N, P) states entering each chunk in x's type (None for one
    chunk, whose entering state is ``init_state``)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    _check(x, dt, a, b, c, d, chunk, init_state)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // chunk)
    plan = ssd_plan(bsz, s, h, g, n, p, chunk, x.dtype, _sm_count(x.device))
    if plan is None:
        raise ValueError(
            f"ssd: chunk {chunk}, state {n}, head dim {p} in {x.dtype} need "
            f"{block_smem(chunk, n, 32, 1, x.dtype, nc)} B of "
            f"shared memory, more than {SMEM_LIMIT}")
    ht, pt = plan
    a, d = a.contiguous(), d.contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    local = s_in = total = None
    if nc > 1:      # chunk-local states, entering states, chunk totals
        local = torch.empty((bsz, nc, h, n, p), dtype=torch.float32,
                            device=x.device)
        s_in = torch.empty((bsz, nc, h, n, p), dtype=x.dtype, device=x.device)
        total = torch.empty((bsz, nc, h), dtype=torch.float32,
                            device=x.device)
    rc = launch_on(x.device, SSD.fn(), (
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), d.data_ptr(), _ptr(init_state),
        y.data_ptr(), state.data_ptr(), _ptr(local), _ptr(s_in), _ptr(total),
        bsz, s, h, g, n, p, chunk, ht, pt, int(_aligned16(x, b, c)),
        *_strides(x, dt, b, c)))
    SSD.check(rc)
    SSD.launches += 1
    return y, state, s_in


class _Scan(torch.autograd.Function):
    """The scan with its gradient: forward :func:`_forward` (the plain
    version on the CPU), keeping the inputs and ``s_in``; backward
    :func:`ssd_bwd`.  An unused output's cotangent arrives as None (no
    zeros are made): a None ``dstate`` is a zero one."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d, init_state, chunk):
        if x.device.type == "cpu":
            y, state = ssd_plain(x, dt, a, b, c, d, chunk=chunk,
                                 init_state=init_state)
            s_in = None
        else:
            y, state, s_in = _forward(x, dt, a, b, c, d, chunk, init_state)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c, d, init_state, s_in)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, b, c, d, init_state, s_in = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x, memory_format=torch.contiguous_format)
        dx, ddt, da, db, dc, dd, dinit = ssd_bwd(
            x, dt, a, b, c, d, dy, dstate, chunk=ctx.chunk,
            init_state=init_state, s_in=s_in)
        return (dx, ddt, da, db, dc, dd,
                None if init_state is None else dinit, None)


def ssd(
    x: torch.Tensor,                      # (B, S, H, P)
    dt: torch.Tensor,                     # (B, S, H) fp32
    a: torch.Tensor,                      # (H,) fp32
    b: torch.Tensor,                      # (B, S, G, N)
    c: torch.Tensor,                      # (B, S, G, N)
    d: torch.Tensor,                      # (H,) fp32
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,   # (B, H, N, P) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, N, P) fp32).  See :func:`~repro_torch.kernels.ssd.ref.ssd_plain`.
    On the card a call of more than one chunk runs three CUDA kernels
    (chunk-local states, the ordered state pass, outputs) and counts one
    launch.  When autograd records and an input requires grad, the
    outputs carry a ``grad_fn`` whose backward is :func:`ssd_bwd`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, d, init_state)):
        return _Scan.apply(x, dt, a, b, c, d, init_state, chunk)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, b, c, d, chunk=chunk,
                         init_state=init_state)
    return _forward(x, dt, a, b, c, d, chunk, init_state)[:2]


def ssd_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    dy: torch.Tensor,                              # (B, S, H, P), x's dtype
    dstate: Optional[torch.Tensor] = None,         # (B, H, N, P) fp32
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,
    s_in: Optional[torch.Tensor] = None,           # (B, nc, H, N, P)
) -> Tuple[torch.Tensor, ...]:
    """Gradient of :func:`ssd` for the cotangents ``dy`` and ``dstate``
    (zeros when None): (dx in x's dtype, ddt fp32, da fp32, db and dc in
    b's dtype, dd fp32, d init_state fp32).  See
    :func:`~repro_torch.kernels.ssd.ref.ssd_bwd_plain`, which the CPU takes
    (recomputing ``s_in`` when None).  On the card ``s_in`` is the
    forward's scratch (x's type), required for more than one chunk; the
    call runs ``SSD_BWD_KERNELS`` CUDA kernels (dlocal, the reverse pass,
    the chunks, the reduction over heads; bf16 on the tensor cores in head
    tiles of :func:`ssd_bwd_plan`, whose roundings
    ``ref.ssd_bwd_bf16_emulated`` repeats) and counts one launch of
    ``SSD_BWD``."""
    if x.device.type == "cpu":
        return ssd_bwd_plain(x, dt, a, b, c, d, dy, dstate, chunk=chunk,
                             init_state=init_state, s_in=s_in)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_bwd: unsupported device {x.device}")
    _check(x, dt, a, b, c, d, chunk, init_state)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // chunk)
    if n > BWD_MAX_NP or p > BWD_MAX_NP:
        raise ValueError(f"ssd_bwd: state size {n} and head dim {p} must be "
                         f"at most {BWD_MAX_NP}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_bwd: dy {dy.dtype} {tuple(dy.shape)} for x "
                         f"{x.dtype} {tuple(x.shape)}")
    # the kernels read dy and dstate as 8- or 16-byte vectors: a view that
    # starts off 16 bytes is copied
    dy = _on16(dy.contiguous())
    if dstate is not None:
        if dstate.shape != (bsz, h, n, p) or dstate.device != x.device:
            raise ValueError(f"ssd_bwd: dstate {tuple(dstate.shape)}, "
                             f"expected {(bsz, h, n, p)}")
        dstate = _on16(dstate.float().contiguous())
    if nc > 1:
        if s_in is None or s_in.shape != (bsz, nc, h, n, p) \
                or s_in.dtype != x.dtype or not s_in.is_contiguous():
            raise ValueError(
                f"ssd_bwd: s_in must be the forward's contiguous "
                f"{(bsz, nc, h, n, p)} {x.dtype} entering states")
    a, d = a.contiguous(), d.contiguous()
    dev = x.device
    ht = ssd_bwd_plan(bsz, s, h, g, n, p, chunk, x.dtype, _sm_count(dev),
                      bwd_occupancy(chunk, n, p, x.dtype)[1]
                      if x.dtype == torch.bfloat16 else 1)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    dx, ddt = empty(bsz, s, h, p, dtype=x.dtype), empty(bsz, s, h)
    da, dd, dinit = empty(h), empty(h), empty(bsz, h, n, p)
    db, dc = empty(bsz, s, g, n, dtype=b.dtype), empty(bsz, s, g, n,
                                                      dtype=b.dtype)
    scratch = {k: empty(*shape, dtype=dt_) for k, (shape, dt_) in
               bwd_scratch(bsz, s, h, g, n, p, chunk, x.dtype, ht).items()}
    rc = launch_on(dev, SSD_BWD.fn(), (
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), d.data_ptr(), _ptr(init_state),
        _ptr(s_in), dy.data_ptr(), _ptr(dstate), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        dd.data_ptr(), dinit.data_ptr(), scratch["gbuf"].data_ptr(),
        _ptr(scratch.get("ghl")), scratch["total"].data_ptr(),
        scratch["dbh"].data_ptr(), scratch["dch"].data_ptr(),
        scratch["part"].data_ptr(), bsz, s, h, g, n, p, chunk, ht,
        int(_aligned16(x, b, c)), *_strides(x, dt, b, c)))
    SSD_BWD.check(rc)
    SSD_BWD.launches += 1
    BWD_LAUNCHED.update(
        heads_a_block=min(ht, h // g) if x.dtype == torch.bfloat16 else 1,
        blocks=bsz * nc * scratch["dbh"].shape[2])
    return dx, ddt, da, db, dc, dd, dinit


def ssd_chunk_fed(
    fetch: Callable[[int], Tuple[torch.Tensor, ...]],
    n_segments: int,
    a: torch.Tensor,
    d: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan over a sequence delivered segment by segment: ``fetch(k)``
    returns segment ``k``'s ``(x, dt, b, c)``, and each segment's scan
    starts from the previous one's final state.  With every segment but
    the last a multiple of ``chunk``, the chunk walk is that of one
    :func:`ssd` call over the whole sequence.  (The reference overlaps the
    next fetch with the current scan; here the fetches are slices, and the
    loop runs them in turn.)  Returns (y (B, S_total, H, P), final state)."""
    if n_segments <= 0:
        raise ValueError("n_segments must be positive")
    ys, state = [], init_state
    for k in range(n_segments):
        x, dt, b, c = fetch(k)
        y, state = ssd(x, dt, a, b, c, d, chunk=chunk, init_state=state)
        ys.append(y)
    return torch.cat(ys, dim=1), state
