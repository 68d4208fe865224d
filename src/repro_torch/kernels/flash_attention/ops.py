"""Flash-attention wrapper: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors, and nothing in between.

``flash_attention`` checks device, dtype, shapes and strides, allocates the
output (and, for a split-KV launch, the fp32 partials) with ``torch.empty``
and launches ``csrc/flash_attention.cu`` on the current stream.  The dtype
picks the kernel: bf16 runs on the tensor cores (wgmma, cp.async K/V ring,
split-KV by :func:`kv_split_plan`); fp32 runs the CUDA-core kernel, the
reference's full-fp32 dot (tensor cores would make it TF32).  Inputs may be
strided views (the model passes q as a transposed projection and k/v as
layer slices of the scratch) as long as the head dim is contiguous; for
bf16 every base address and stride must also be a multiple of 16 bytes (the
16-byte copies), and a bf16 input that is not raises.  q and k share a
head dim DK and v has its own, DV: the kernel is built for the pairs of
:data:`HEAD_DIM_PAIRS` (every equal pair, and MLA's (96, 64)), and any
other pair raises.  The output is contiguous (B, Hq, Sq, DV).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.common import CudaKernel, launch_on, refuse_autograd
from repro_torch.kernels.flash_attention.ref import attention_plain

HEAD_DIMS = (16, 32, 64, 80, 96, 112, 128)
#: (q/k head dim, v head dim) pairs the kernel is built for: every equal
#: pair, and minicpm3-4b's MLA, whose q/k rows are 64 latent-expanded + 32
#: rope columns and whose v rows are 64
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((96, 64),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: q rows and kv rows a tile of the bf16 kernel
BLOCK_Q = 64
BLOCK_KV = 64
#: blocks that fill the card once (H100 SXM: 132 SMs)
WAVE = 132
#: the fewest kv tiles a split holds (fewer is not worth the merge)
MIN_TILES_PER_SPLIT = 2

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FLASH = CudaKernel(
    "flash_attention", "repro_flash_attention_fwd",
    [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _L, _L, _L,
     _I, _I, _I, _I, _F, _I, _I, _P, _P, _P])


@dataclasses.dataclass(frozen=True)
class KvSplitPlan:
    """How the bf16 kernel cuts the visible kv tiles of each q tile: split
    ``j`` of a q tile whose visible tiles are ``[t_lo, t_hi)`` takes
    ``[t_lo + j·tiles_per_split, …)``, at most ``tiles_per_split`` of them
    and none past ``t_hi``.  ``splits == 1`` is one block a q tile, which
    walks all of them (``tiles_per_split`` is then not read)."""

    splits: int
    tiles_per_split: int


_ONE = KvSplitPlan(1, 1)


def visible_tiles(i0: int, i1: int, skv: int, q_offset: int, causal: bool,
                  window: Optional[int]) -> Tuple[int, int]:
    """kv tiles ``[t_lo, t_hi)`` holding a column visible to some q row in
    ``[i0, i1)`` (the kernel's ``visible_tiles``).  Only ``None`` means no
    window: under a causal mask a window below 1 shows no column."""
    r_lo, r_hi = q_offset + i0, q_offset + i1 - 1
    c_hi = min(skv, r_hi + 1) if causal else skv
    c_lo = max(0, r_lo - window + 1) if window is not None else 0
    if causal and window is not None and window < 1:
        c_hi = c_lo
    t_lo = c_lo // BLOCK_KV
    t_hi = -(-c_hi // BLOCK_KV) if c_hi > c_lo else t_lo
    return t_lo, t_hi


@functools.lru_cache(maxsize=4096)
def kv_split_plan(sq: int, skv: int, q_offset: int, causal: bool,
                  window: Optional[int], hq: int) -> KvSplitPlan:
    """The split of a bf16 call.  No split when the q tiles of all heads
    of one sequence fill a wave of SMs; else as many splits as bring them
    to about a wave, each of at least :data:`MIN_TILES_PER_SPLIT` kv
    tiles.  Depends on the visible column range and Hq only (Skv matters
    only where it cuts that range; the batch not at all), so a chunk is
    summed in the same order whatever the length of the cache behind it
    and whatever sequences are prefilled beside it."""
    n_q = -(-sq // BLOCK_Q)
    units = hq * n_q
    if units >= WAVE:
        return KvSplitPlan(1, 1)
    most = max(hi - lo for lo, hi in (
        visible_tiles(i * BLOCK_Q, min((i + 1) * BLOCK_Q, sq), skv,
                      q_offset, causal, window) for i in range(n_q)))
    if most <= MIN_TILES_PER_SPLIT:
        return KvSplitPlan(1, 1)
    want = -(-WAVE // units)
    per = max(MIN_TILES_PER_SPLIT, -(-most // want))
    return KvSplitPlan(-(-most // per), per)


def split_ranges(plan: KvSplitPlan, q_tile: int, sq: int, skv: int,
                 q_offset: int, causal: bool, window: Optional[int]
                 ) -> List[Tuple[int, int]]:
    """The kv tile range ``[lo, hi)`` of each split of q tile ``q_tile``
    (empty ranges included), as the kernel walks them."""
    i0 = q_tile * BLOCK_Q
    t_lo, t_hi = visible_tiles(i0, min(i0 + BLOCK_Q, sq), skv, q_offset,
                               causal, window)
    if plan.splits == 1:
        return [(t_lo, t_hi)]
    out = []
    for j in range(plan.splits):
        lo = min(t_lo + j * plan.tiles_per_split, t_hi)
        out.append((lo, min(lo + plan.tiles_per_split, t_hi)))
    return out


def _aligned16(ptr: int, shape, stride) -> bool:
    """16-byte copies: the base and every stride used (a dim of size 1 is
    never stepped) a multiple of 16 bytes (8 bf16)."""
    return ptr % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(shape[:3], stride[:3]) if n > 1)


def resolve_q_offset(sq: int, skv: int, q_offset: Optional[int],
                     causal: bool, window: Optional[int]) -> int:
    """The absolute position of q row 0 (default ``Skv - Sq``, the rows
    right-aligned to the columns).  Only the causal mask and the window
    read it: a call with neither (the whisper encoder's, and a decoder's
    cross-attention, whose Sq may exceed Skv) sees every column from every
    row, so any offset is accepted and taken as 0.  A masked call with a
    negative offset raises."""
    offset = skv - sq if q_offset is None else int(q_offset)
    if not causal and window is None:
        return 0
    if offset < 0:
        raise ValueError(f"flash_attention: q_offset {offset} < 0 under a "
                         f"causal mask or a window")
    return offset


def flash_attention(
    q: torch.Tensor,               # (B, Hq, Sq, DK)
    k: torch.Tensor,               # (B, Hkv, Skv, DK)
    v: torch.Tensor,               # (B, Hkv, Skv, DV)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Attention of q rows at absolute positions ``q_offset + i`` (default
    ``Skv - Sq``; see :func:`resolve_q_offset`) over k/v with GQA
    (``Hq % Hkv == 0``), scaled by ``scale`` (default ``DK ** -0.5``):
    (B, Hq, Sq, DV).  See
    :func:`~repro_torch.kernels.flash_attention.ref.attention_plain`."""
    offset = resolve_q_offset(q.shape[2], k.shape[2], q_offset, causal,
                              window)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=offset)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    refuse_autograd("flash_attention", q, k, v)
    qs, ks, vs = q.shape, k.shape, v.shape
    b, hq, sq, d = qs
    if (k.dim() != 4 or v.dim() != 4 or vs[:3] != ks[:3] or ks[0] != b
            or ks[3] != d):
        raise ValueError(f"flash_attention: shapes q {tuple(qs)} "
                         f"k {tuple(ks)} v {tuple(vs)}")
    dv = vs[3]
    hkv, skv = ks[1], ks[2]
    if hkv == 0 or hq % hkv or sq == 0 or skv == 0 or b * hq > 65535:
        raise ValueError(f"flash_attention: batch {b}, heads {hq}/{hkv}, "
                         f"seq {sq}/{skv}")     # grid.y is b * hq (fp32)
    dtype = q.dtype
    if dtype not in _DTYPES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"flash_attention: dtypes {dtype}, {k.dtype}, "
                        f"{v.dtype}; supported: float32 or bfloat16, alike")
    if (d, dv) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention: head dims (q/k {d}, v {dv}) not "
                         f"in {HEAD_DIM_PAIRS}")
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k, v on different devices")
    qt, kt, vt = q.stride(), k.stride(), v.stride()
    if qt[3] != 1 or kt[3] != 1 or vt[3] != 1:
        raise ValueError("flash_attention: head dim must be contiguous")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    bf16 = dtype == torch.bfloat16
    if bf16 and not (_aligned16(qp, qs, qt) and _aligned16(kp, ks, kt)
                     and _aligned16(vp, vs, vt)):
        raise ValueError(
            "flash_attention: the bf16 kernel copies 16-byte chunks; q, k "
            "and v need 16-byte aligned bases and strides (got strides "
            f"{qt}, {kt}, {vt})")
    scale = float(scale) if scale is not None else d ** -0.5
    out = torch.empty((b, hq, sq, dv), dtype=dtype, device=dev)
    plan = (kv_split_plan(sq, skv, offset, causal, window, hq) if bf16
            else _ONE)
    part = part_o = part_ml = None
    if plan.splits > 1:        # (splits, B·Hq, Sq, DV) O, then (…, 2) m, l
        rows = plan.splits * b * hq * sq
        part = torch.empty(rows * (dv + 2), dtype=torch.float32, device=dev)
        part_o = part.data_ptr()
        part_ml = part_o + rows * dv * 4
    FLASH.check(launch_on(dev, FLASH.fn(), (
        _DTYPES[dtype], d, dv, qp, kp, vp, out.data_ptr(), b, hq, hkv, sq,
        skv, qt[0], qt[1], qt[2], kt[0], kt[1], kt[2], vt[0], vt[1], vt[2],
        offset, int(causal), int(window is not None), int(window or 0),
        scale, plan.splits, plan.tiles_per_split, part_o, part_ml)))
    FLASH.launches += 1
    return out
