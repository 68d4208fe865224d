"""Fused collective matmuls over the TP group, by hand-written CUDA kernels
(``csrc/cc_matmul.cu``).

Two paths, one schedule, picked as the reference picks between its
remote-DMA and emulated paths (``repro.kernels.cc_matmul.ops``):

* **in-kernel ring** — when the group's ranks have mapped each other's
  channels (``Group.peer``: the ranks share a card, CUDA IPC) and the
  activations are on the card: the whole ring of one direction enqueued
  at once, :func:`ag_matmul_ring` / :func:`rs_matmul_ring` (the
  counterparts of ``ag_matmul_ring_tpu`` / ``rs_matmul_ring_tpu``): n hop
  products on the tensor cores or CUDA cores and n − 1 forwards by the
  copy engine, on PyTorch's current stream, and every hand-off between
  ranks a wait the card holds in stream order (``ring.py``, the protocol;
  ``csrc/cc_matmul.cu``, the launcher).  The bidirectional composition
  runs two counter-rotating half rings.  Unlike the TPU kernels these take
  any row count and width, so nothing is padded.  A ring's waits have no
  deadline: a rank whose
  neighbour never arrives (a rank that raised, or ranks that issued
  different fused ops: every rank must issue the same ones in the same
  order) waits until the rank pool gives up on the group after
  ``dist.group.GROUP_TIMEOUT_S`` and kills the rank processes, whose
  contexts, and their waits, go with them.
* **emulated** — everywhere else (the CPU, or a group without peer
  memory): the hop runs over the group's wire and each arrival is
  consumed by a hop kernel reading its scratch slot.

The module has four parts:

1. **The hop kernels' wrappers** — :func:`matmul_tile`,
   :func:`consume_matmul` and :func:`consume_matmul_acc`.  The tensor's
   device alone decides: a CPU tensor takes the plain version
   (``ref.py``), a CUDA tensor launches the kernel or raises.  Each has a
   launch count (``MATMUL_TILE``, ``CONSUME_MATMUL``,
   ``CONSUME_MATMUL_ACC``) that grows where the kernel launches and
   nowhere else; ``PLAIN_CALLS`` counts the plain versions' runs.  A
   leading batch dim is part of the kernel's grid: the reference's
   ``jax.vmap`` over B is one launch here, with the same arithmetic.
2. **The ring's wrappers** — :func:`ag_matmul_ring` and
   :func:`rs_matmul_ring`, with the counts ``AG_MATMUL_RING`` and
   ``RS_MATMUL_RING`` (one a ring call: the hop products a call launches
   go through the ring's own entry, count in ``Group.stats
   ["ring_kernels"]``, and bump no hop kernel's count); on CPU tensors
   their plain versions are the unfused compositions of ``ref.py``.
3. **The emulated schedules** :func:`_ag` and :func:`_rs` — hop for hop the
   reference's ``_ag_2d``/``_rs_2d`` (the schedules of
   ``core/overlap.py``): the double-buffered scratch with hop k's arrival
   written into slot ``k % 2`` and consumed from there, the bidirectional
   half-rings for n > 2, the n == 1 and n == 2 branches, placement at
   ``((my ∓ hop) % n)·b_loc (+ half)``, and the add order
   ``arrived + dot``.  The hop is ``Group.exchange`` (paired
   ``isend``/``irecv`` to the two neighbours, staged through the host on
   the card) in place of ``lax.ppermute``.
4. **The differentiable ops** :func:`allgather_matmul_fused` and
   :func:`matmul_reducescatter_fused`, whose backward is the other fused
   op plus a plain gather for the weight gradient (``_ag_vjp`` /
   ``_rs_vjp`` of the reference).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels.cc_matmul.ref import (
    allgather_matmul_ref,
    consume_matmul_acc_plain,
    consume_matmul_plain,
    matmul_reducescatter_ref,
    matmul_tile_plain,
)
from repro_torch.kernels.cc_matmul import ring
from repro_torch.kernels.common import CudaKernel, current_stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (dtype_x, dtype_w, x, w, out, B, M, N, K, sxb, sxm, swk, stream)
MATMUL_TILE = CudaKernel(
    "cc_matmul", "repro_cc_matmul_tile",
    [_I, _I, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _P])
# (dtype_x, dtype_w, scratch, slot, w, out, B, M, N, K,
#  s_slot, sxb, sxm, swk, stream)
CONSUME_MATMUL = CudaKernel(
    "cc_matmul", "repro_cc_consume_matmul",
    [_I, _I, _P, _I, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _P])
# (dtype_x, dtype_w, scratch, slot, x, w, out, B, M, N, K,
#  s_slot, sab, sam, sxb, sxm, swk, stream)
CONSUME_MATMUL_ACC = CudaKernel(
    "cc_matmul", "repro_cc_consume_matmul_acc",
    [_I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _P])

_U = ctypes.c_ulonglong
# the ring's tail: (mine, next, slot_stride, n, done_base, arrive_base,
#  plan, n_ops, hops (out: the hop products launched), stream)
_RING_TAIL = [_P, _P, _L, _I, _U, _U, _P, _I, _P, _P]
# (dtype_x, dtype_w, x, w, out, B, b, N, K, sxb, sxm, swk, sob, sos, som,
#  ...tail)
AG_MATMUL_RING = CudaKernel(
    "cc_matmul", "repro_cc_ag_matmul_ring",
    [_I, _I, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L]
    + _RING_TAIL)
# (dtype_x, dtype_w, x, w, out, res, B, b, N, K, sxb, sxm, swk, sob, som,
#  ...tail)
RS_MATMUL_RING = CudaKernel(
    "cc_matmul", "repro_cc_rs_matmul_ring",
    [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _L]
    + _RING_TAIL)

#: runs of each plain version (the CPU path); a card run expects zero
PLAIN_CALLS: Dict[str, int] = {"matmul_tile": 0, "consume_matmul": 0,
                               "consume_matmul_acc": 0, "ag_matmul_ring": 0,
                               "rs_matmul_ring": 0}

#: the three hop kernels by entry name
HOP_KERNELS = {"matmul_tile": MATMUL_TILE,
               "consume_matmul": CONSUME_MATMUL,
               "consume_matmul_acc": CONSUME_MATMUL_ACC}
#: the two whole-ring ops by entry name
RING_KERNELS = {"ag_matmul_ring": AG_MATMUL_RING,
                "rs_matmul_ring": RS_MATMUL_RING}
KERNELS = {**HOP_KERNELS, **RING_KERNELS}


# ---------------------------------------------------------------------------
# 1. the hop kernels' wrappers
# ---------------------------------------------------------------------------


def _batched(t: torch.Tensor, name: str) -> torch.Tensor:
    """A (rows, cols) or (B, rows, cols) operand as a 3-D view."""
    if t.dim() == 2:
        return t.unsqueeze(0)
    if t.dim() != 3:
        raise ValueError(f"{name}: expected 2-D or 3-D, got "
                         f"{tuple(t.shape)}")
    return t


def _check(fn: str, x3: torch.Tensor, w: torch.Tensor,
           acc3: Optional[torch.Tensor] = None) -> None:
    if x3.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x3.device}")
    if w.dim() != 2 or x3.shape[-1] != w.shape[0]:
        raise ValueError(f"{fn}: shapes x {tuple(x3.shape)} w "
                         f"{tuple(w.shape)}")
    if x3.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtypes x {x3.dtype}, w {w.dtype}; "
                        f"supported: float32 or bfloat16")
    if w.device != x3.device:
        raise ValueError(f"{fn}: x on {x3.device}, w on {w.device}")
    if x3.stride(-1) != 1 or w.stride(-1) != 1:
        raise ValueError(f"{fn}: the last dim of x and w must be "
                         f"contiguous (strides {x3.stride()}, {w.stride()})")
    if acc3 is not None:
        if acc3.dtype != torch.float32 or acc3.device != x3.device \
                or acc3.shape != (x3.shape[0], x3.shape[1], w.shape[1]) \
                or acc3.stride(-1) != 1:
            raise ValueError(
                f"{fn}: the accumulator slot must be float32 "
                f"{(x3.shape[0], x3.shape[1], w.shape[1])} on {x3.device} "
                f"with a contiguous last dim, got {acc3.dtype} "
                f"{tuple(acc3.shape)} strides {acc3.stride()}")
    if x3.shape[0] > 65535:
        raise ValueError(f"{fn}: batch {x3.shape[0]} exceeds the grid")


def _out(x3: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.empty((x3.shape[0], x3.shape[1], w.shape[1]),
                       dtype=torch.float32, device=x3.device)


def matmul_tile(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The resident block's tile, ``dot(x, w)`` in fp32 (RS hop 0): x
    (b, K) or (B, b, K), possibly a strided row block; w (K, N) with a
    contiguous last dim.  Returns (…, b, N) fp32."""
    if x.device.type == "cpu":
        PLAIN_CALLS["matmul_tile"] += 1
        return matmul_tile_plain(x, w)
    x3 = _batched(x, "matmul_tile")
    _check("matmul_tile", x3, w)
    out = _out(x3, w)
    if out.numel() == 0:                 # nothing to compute, no launch
        return out[0] if x.dim() == 2 else out
    bsz, m, k = x3.shape
    fn = MATMUL_TILE.fn()
    rc = fn(_DTYPES[x3.dtype], _DTYPES[w.dtype], x3.data_ptr(), w.data_ptr(),
            out.data_ptr(), bsz, m, w.shape[1], k,
            x3.stride(0), x3.stride(1), w.stride(0),
            current_stream(x3.device))
    MATMUL_TILE.check(rc)
    MATMUL_TILE.launches += 1
    return out[0] if x.dim() == 2 else out


def consume_matmul(scratch: torch.Tensor, w: torch.Tensor, *,
                   slot: int) -> torch.Tensor:
    """AG hop consume, ``dot(scratch[slot], w)`` → (…, b, N) fp32:
    scratch (2, b, K) or (2, B, b, K), read in place through its strides."""
    if scratch.device.type == "cpu":
        PLAIN_CALLS["consume_matmul"] += 1
        return consume_matmul_plain(scratch, w, slot=slot)
    if slot not in (0, 1) or scratch.shape[0] != 2:
        raise ValueError(f"consume_matmul: slot {slot} of scratch "
                         f"{tuple(scratch.shape)}")
    x3 = _batched(scratch[slot], "consume_matmul")
    _check("consume_matmul", x3, w)
    out = _out(x3, w)
    if out.numel() == 0:
        return out[0] if scratch.dim() == 3 else out
    bsz, m, k = x3.shape
    fn = CONSUME_MATMUL.fn()
    rc = fn(_DTYPES[x3.dtype], _DTYPES[w.dtype], scratch.data_ptr(), slot,
            w.data_ptr(), out.data_ptr(), bsz, m, w.shape[1], k,
            scratch.stride(0), x3.stride(0), x3.stride(1), w.stride(0),
            current_stream(x3.device))
    CONSUME_MATMUL.check(rc)
    CONSUME_MATMUL.launches += 1
    return out[0] if scratch.dim() == 3 else out


def consume_matmul_acc(scratch: torch.Tensor, x: torch.Tensor,
                       w: torch.Tensor, *, slot: int) -> torch.Tensor:
    """RS hop consume, ``scratch[slot] + dot(x, w)`` → (…, b, N) fp32:
    scratch (2, b, N) or (2, B, b, N) fp32 of arrived accumulators; x
    (…, b, K), possibly a strided row block."""
    if x.device.type == "cpu":
        PLAIN_CALLS["consume_matmul_acc"] += 1
        return consume_matmul_acc_plain(scratch, x, w, slot=slot)
    if slot not in (0, 1) or scratch.shape[0] != 2 \
            or scratch.dim() != x.dim() + 1:
        raise ValueError(f"consume_matmul_acc: slot {slot} of scratch "
                         f"{tuple(scratch.shape)}, x {tuple(x.shape)}")
    x3 = _batched(x, "consume_matmul_acc")
    acc3 = _batched(scratch[slot], "consume_matmul_acc")
    _check("consume_matmul_acc", x3, w, acc3)
    out = _out(x3, w)
    if out.numel() == 0:
        return out[0] if x.dim() == 2 else out
    bsz, m, k = x3.shape
    fn = CONSUME_MATMUL_ACC.fn()
    rc = fn(_DTYPES[x3.dtype], _DTYPES[w.dtype], scratch.data_ptr(), slot,
            x3.data_ptr(), w.data_ptr(), out.data_ptr(), bsz, m, w.shape[1],
            k, scratch.stride(0), acc3.stride(0), acc3.stride(1),
            x3.stride(0), x3.stride(1), w.stride(0),
            current_stream(x3.device))
    CONSUME_MATMUL_ACC.check(rc)
    CONSUME_MATMUL_ACC.launches += 1
    return out[0] if x.dim() == 2 else out


# ---------------------------------------------------------------------------
# 2. the ring's wrappers
# ---------------------------------------------------------------------------


def _ring_out(out: Optional[torch.Tensor], shape, device,
              fn: str) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.float32 \
            or out.device != device or out.stride(-1) != 1:
        raise ValueError(f"{fn}: out must be float32 {tuple(shape)} on "
                         f"{device} with a contiguous last dim, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device} "
                         f"strides {out.stride()}")
    return out


def _peer_channel(group, direction: int, slot_bytes: int, fn: str):
    if group.peer is None:
        raise ValueError(f"{fn}: the group has no peer memory (its ranks "
                         f"must share the card and map each other's "
                         f"channels)")
    if direction not in (1, -1):
        raise ValueError(f"{fn}: direction {direction} is not ±1")
    return group.peer.channel(direction, slot_bytes)


def _ring_launch(kernel: CudaKernel, op: str, ch, group, direction: int,
                 args) -> None:
    """Enqueue one ring call of ``op`` on channel ``ch`` (this rank's
    plan, ``ring.ring_plan``) and advance the channel's bases as the call
    advances its counters.  Nothing waits on the host.  The hop products
    are counted where the launcher launches them."""
    n = group.size
    rows, n_ops = ring.encode(op, n, group.rank, direction)
    group.peer.require_stream_waits()
    hops = ctypes.c_int(0)
    rc = kernel.fn()(*args, ch.mine, ch.next, ch.slot_bytes, n,
                     ch.calls * n, ch.arrived, ctypes.addressof(rows), n_ops,
                     ctypes.byref(hops), current_stream(group.device))
    kernel.check(rc)
    ch.calls += 1                       # `done` grows by n a call
    ch.arrived += n - 1                 # and `arrive` by n − 1
    kernel.launches += 1
    group.stats["ring_kernels"] += hops.value


def ag_matmul_ring(x: torch.Tensor, w: torch.Tensor, group, *,
                   direction: int = 1,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``all_gather(x) @ w`` over one ring direction, the whole ring
    enqueued at once (``ag_matmul_ring_tpu``): x (b, K) or (B, b, K), w
    (K, N) with
    a contiguous last dim.  Returns (…, n·b, N) fp32, blocks in rank order
    (the direction only changes the order in which they arrive).  ``out``,
    if given, is a (B, n, b, N) fp32 view the result is written into (the
    bidirectional composition passes the two halves of each block)."""
    x3 = _batched(x, "ag_matmul_ring")
    n = group.size
    bsz, b, k = x3.shape
    nout = w.shape[1]
    if x.device.type == "cpu":
        PLAIN_CALLS["ag_matmul_ring"] += 1
        y = allgather_matmul_ref(x3, w, group)
        if out is None:
            return y[0] if x.dim() == 2 else y
        out.copy_(y.view(bsz, n, b, nout))
        return out
    _check("ag_matmul_ring", x3, w)
    out4 = _ring_out(out, (bsz, n, b, nout), x3.device, "ag_matmul_ring")
    slot_bytes = bsz * b * k * x3.element_size()
    ch = _peer_channel(group, direction, slot_bytes, "ag_matmul_ring")
    if out4.numel():
        _ring_launch(AG_MATMUL_RING, "ag", ch, group, direction, (
            _DTYPES[x3.dtype], _DTYPES[w.dtype], x3.data_ptr(), w.data_ptr(),
            out4.data_ptr(), bsz, b, nout, k, x3.stride(0), x3.stride(1),
            w.stride(0), out4.stride(0), out4.stride(1), out4.stride(2)))
        group.stats["hops"] += n - 1
        group.stats["peer_bytes"] += (n - 1) * slot_bytes
    if out is not None:
        return out
    y = out4.view(bsz, n * b, nout)
    return y[0] if x.dim() == 2 else y


def rs_matmul_ring(x: torch.Tensor, w: torch.Tensor, group, *,
                   direction: int = 1,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``reduce_scatter(x @ w)`` over one ring direction, the whole ring
    enqueued at once (``rs_matmul_ring_tpu``): the fp32 accumulator rides
    the ring.  x (n·b, K) or (B, n·b, K), w (K, N) with a contiguous last dim
    (a column slice is fine).  Returns this rank's (…, b, N) fp32 row
    block of the group's sum; ``out``, if given, is a (B, b, N) fp32 view
    the result is written into."""
    x3 = _batched(x, "rs_matmul_ring")
    n = group.size
    bsz, rows, k = x3.shape
    if rows % n:
        raise ValueError(f"rs_matmul_ring: rows {rows} do not split over "
                         f"{n} ranks")
    b, nout = rows // n, w.shape[1]
    if x.device.type == "cpu":
        PLAIN_CALLS["rs_matmul_ring"] += 1
        y = matmul_reducescatter_ref(x3, w, group)
        if out is None:
            return y[0] if x.dim() == 2 else y
        out.copy_(y)
        return out
    _check("rs_matmul_ring", x3, w)
    out3 = _ring_out(out, (bsz, b, nout), x3.device, "rs_matmul_ring")
    slot_bytes = bsz * b * nout * 4
    ch = _peer_channel(group, direction, slot_bytes, "rs_matmul_ring")
    if out3.numel():
        # the accumulator a rank forwards from (its reuse and its release
        # are ordered after each forward on the one stream)
        res = torch.empty((bsz, b, nout), dtype=torch.float32,
                          device=x3.device)
        _ring_launch(RS_MATMUL_RING, "rs", ch, group, direction, (
            _DTYPES[x3.dtype], _DTYPES[w.dtype], x3.data_ptr(), w.data_ptr(),
            out3.data_ptr(), res.data_ptr(), bsz, b, nout, k, x3.stride(0),
            x3.stride(1), w.stride(0), out3.stride(0), out3.stride(1)))
        group.stats["hops"] += n - 1
        group.stats["peer_bytes"] += (n - 1) * slot_bytes
    if out is not None:
        return out
    return out3[0] if x.dim() == 2 else out3


def _ag_peer(x: torch.Tensor, w: torch.Tensor, group,
             bidirectional: bool) -> torch.Tensor:
    """The in-kernel ring of ``_ag_2d_tpu``: one ring, or two
    counter-rotating half rings whose outputs interleave block by block
    (each writes its half of every block in place)."""
    n = group.size
    bsz, b_loc, _ = x.shape
    if not bidirectional or n == 2:
        return ag_matmul_ring(x, w, group, direction=1)
    half = b_loc // 2
    out = torch.empty((bsz, n, b_loc, w.shape[1]), dtype=torch.float32,
                      device=x.device)
    ag_matmul_ring(x[:, :half], w, group, direction=1, out=out[:, :, :half])
    ag_matmul_ring(x[:, half:], w, group, direction=-1, out=out[:, :, half:])
    return out.view(bsz, n * b_loc, w.shape[1])


def _rs_peer(x: torch.Tensor, w: torch.Tensor, group,
             bidirectional: bool) -> torch.Tensor:
    """The in-kernel ring of ``_rs_2d_tpu``: one ring, or the column
    halves of w on two counter-rotating rings."""
    n = group.size
    if not bidirectional or n == 2:
        return rs_matmul_ring(x, w, group, direction=1)
    bsz, rows, _ = x.shape
    nloc = w.shape[1]
    half = nloc // 2
    out = torch.empty((bsz, rows // n, nloc), dtype=torch.float32,
                      device=x.device)
    rs_matmul_ring(x, w[:, :half], group, direction=1, out=out[..., :half])
    rs_matmul_ring(x, w[:, half:], group, direction=-1, out=out[..., half:])
    return out


def _on_peer_path(x: torch.Tensor, group) -> bool:
    """The in-kernel ring runs when the ranks have mapped each other's
    channels and the activations are on the card (the reference's
    ``use_remote_dma``)."""
    return getattr(group, "peer", None) is not None and x.is_cuda


# ---------------------------------------------------------------------------
# 3. the emulated schedules (batched: x is (B, rows, K))
# ---------------------------------------------------------------------------


def _ag(x: torch.Tensor, w: torch.Tensor, group,
        bidirectional: bool) -> torch.Tensor:
    """all_gather(x) @ w: x (B, b_loc, K) → (B, n·b_loc, N) fp32.  On the
    peer path the in-kernel ring; else each hop's arrival is consumed from
    the double-buffered scratch."""
    if _on_peer_path(x, group):
        return _ag_peer(x, w, group, bidirectional)
    n, my = group.size, group.rank
    bsz, b_loc, _ = x.shape
    out = torch.empty((bsz, n * b_loc, w.shape[1]), dtype=torch.float32,
                      device=x.device)

    if not bidirectional or n == 2:
        scr = x.new_empty((2,) + tuple(x.shape))
        scr[0] = x
        out[:, my * b_loc:(my + 1) * b_loc] = consume_matmul(scr, w, slot=0)
        if n == 1:
            return out
        for hop in range(1, n):
            prev, cur = (hop - 1) % 2, hop % 2
            # hop k's chunk lands in the free slot while slot `prev`
            # holds what the last consume read (the remote-DMA kernel's
            # double-buffer discipline, the exchange standing in for DMA)
            group.exchange([(scr[prev], 1)], into=[scr[cur]])
            src = (my - hop) % n
            out[:, src * b_loc:(src + 1) * b_loc] = consume_matmul(
                scr, w, slot=cur)
        return out

    half = b_loc // 2
    scr_f = x.new_empty((2, bsz, half, x.shape[2]))
    scr_b = x.new_empty((2, bsz, b_loc - half, x.shape[2]))
    scr_f[0] = x[:, :half]
    scr_b[0] = x[:, half:]

    def place(y, src, second_half):
        row = src * b_loc + (half if second_half else 0)
        out[:, row:row + y.shape[1]] = y

    place(consume_matmul(scr_f, w, slot=0), my, False)
    place(consume_matmul(scr_b, w, slot=0), my, True)
    if n == 1:
        return out
    for hop in range(1, n):
        prev, cur = (hop - 1) % 2, hop % 2
        group.exchange([(scr_f[prev], 1), (scr_b[prev], -1)],
                       into=[scr_f[cur], scr_b[cur]])
        place(consume_matmul(scr_f, w, slot=cur), (my - hop) % n, False)
        place(consume_matmul(scr_b, w, slot=cur), (my + hop) % n, True)
    return out


def _rs(x: torch.Tensor, w: torch.Tensor, group,
        bidirectional: bool) -> torch.Tensor:
    """reduce_scatter(x @ w): x (B, n·b_loc, K) → (B, b_loc, N) fp32.  On
    the peer path the in-kernel ring; else the in-flight accumulator is
    consumed from the double-buffered scratch."""
    if _on_peer_path(x, group):
        return _rs_peer(x, w, group, bidirectional)
    n, my = group.size, group.rank
    bsz, rows, _ = x.shape
    if rows % n:
        raise ValueError(f"reduce_scatter rows {rows} do not split over "
                         f"{n} ranks")
    b_loc = rows // n

    def row_block(owner_offset: int) -> torch.Tensor:
        start = ((my + owner_offset) % n) * b_loc
        return x[:, start:start + b_loc]

    if not bidirectional or n == 2:
        acc = matmul_tile(row_block(-1), w)
        if n == 1:
            return acc
        scr = torch.empty((2, bsz, b_loc, w.shape[1]), dtype=torch.float32,
                          device=x.device)
        for hop in range(1, n):
            cur = hop % 2
            group.exchange([(acc, 1)], into=[scr[cur]])
            acc = consume_matmul_acc(scr, row_block(-(hop + 1)), w,
                                     slot=cur)
        return acc

    nloc = w.shape[1]
    half = nloc // 2

    def w_part(second_half: bool) -> torch.Tensor:
        return w[:, half:] if second_half else w[:, :half]

    if n == 1:
        return torch.cat([matmul_tile(row_block(-1), w_part(False)),
                          matmul_tile(row_block(+1), w_part(True))], dim=-1)
    acc_f = matmul_tile(row_block(-1), w_part(False))
    acc_b = matmul_tile(row_block(+1), w_part(True))
    scr_f = torch.empty((2, bsz, b_loc, half), dtype=torch.float32,
                        device=x.device)
    scr_b = torch.empty((2, bsz, b_loc, nloc - half), dtype=torch.float32,
                        device=x.device)
    for hop in range(1, n):
        cur = hop % 2
        group.exchange([(acc_f, 1), (acc_b, -1)],
                       into=[scr_f[cur], scr_b[cur]])
        acc_f = consume_matmul_acc(scr_f, row_block(-(hop + 1)),
                                   w_part(False), slot=cur)
        acc_b = consume_matmul_acc(scr_b, row_block(+(hop + 1)),
                                   w_part(True), slot=cur)
    return torch.cat([acc_f, acc_b], dim=-1)


def _impl(sched, x: torch.Tensor, w: torch.Tensor, group,
          bidirectional: bool) -> torch.Tensor:
    """Run a schedule on 2-D (rows, K) or 3-D (B, rows, K) activations."""
    if x.dim() == 2:
        return sched(x.unsqueeze(0), w, group, bidirectional)[0]
    return sched(x, w, group, bidirectional)


# ---------------------------------------------------------------------------
# 4. the differentiable ops
# ---------------------------------------------------------------------------


def _dw(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``aᵀ @ g`` summed over the batch, in fp32 (a plain GEMM outside the
    hop kernels, as the reference's ``jnp.dot``/``einsum``)."""
    a2 = a.reshape(-1, a.shape[-1]).float()
    g2 = g.reshape(-1, g.shape[-1]).float()
    return a2.t() @ g2


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, bidirectional):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.group, ctx.bidirectional = group, bidirectional
        return _impl(_ag, x, w, group, bidirectional)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        # y = AG(x) @ w  ⇒  dx = RS(g @ wᵀ), itself a fused ring, and
        # dw = AG(x)ᵀ @ g (a plain gather: weight gradients are not
        # ring-shaped)
        dx = _impl(_rs, g, w.t().contiguous(), ctx.group,
                   ctx.bidirectional).to(x.dtype)
        x_full = ctx.group.all_gather(x, dim=x.dim() - 2)
        return dx, _dw(x_full, g).to(w.dtype), None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, bidirectional):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.group, ctx.bidirectional = group, bidirectional
        return _impl(_rs, x, w, group, bidirectional)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        # y = RS(x @ w)  ⇒  dY = AG(g): dx = dY @ wᵀ is the fused AG
        # matmul, dw = xᵀ @ dY (plain gather)
        dx = _impl(_ag, g, w.t().contiguous(), ctx.group,
                   ctx.bidirectional).to(x.dtype)
        g_full = ctx.group.all_gather(g, dim=g.dim() - 2)
        return dx, _dw(x, g_full).to(w.dtype), None, None


def allgather_matmul_fused(x: torch.Tensor, w: torch.Tensor, group, *,
                           bidirectional: bool = True) -> torch.Tensor:
    """Fused ``all_gather(x) @ w`` over ``group`` (the counterpart of
    ``repro.kernels.cc_matmul.allgather_matmul_pallas``): x (b, K) or
    (B, b, K) local rows, w (K, N_loc) the resident column shard; returns
    (n·b, N_loc) / (B, n·b, N_loc) fp32.  Differentiable."""
    if x.dim() not in (2, 3):
        raise ValueError(f"allgather_matmul_fused: x {tuple(x.shape)}")
    return _AllGatherMatmul.apply(x, w, group, bool(bidirectional))


def matmul_reducescatter_fused(x: torch.Tensor, w: torch.Tensor, group, *,
                               bidirectional: bool = True) -> torch.Tensor:
    """Fused ``reduce_scatter(x @ w)`` over ``group`` (the counterpart of
    ``repro.kernels.cc_matmul.matmul_reducescatter_pallas``): x (n·b,
    K_loc) or (B, n·b, K_loc), w (K_loc, N) the resident row shard;
    returns (b, N) / (B, b, N) fp32.  Differentiable."""
    if x.dim() not in (2, 3):
        raise ValueError(f"matmul_reducescatter_fused: x {tuple(x.shape)}")
    return _MatmulReduceScatter.apply(x, w, group, bool(bidirectional))


def launches() -> Dict[str, int]:
    """The five kernels' launch counts, by name."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_counts() -> None:
    """Zero the kernels' launch counts and the plain-version counts."""
    for k in KERNELS.values():
        k.launches = 0
    for name in PLAIN_CALLS:
        PLAIN_CALLS[name] = 0


__all__ = ["AG_MATMUL_RING", "CONSUME_MATMUL", "CONSUME_MATMUL_ACC",
           "HOP_KERNELS", "KERNELS", "MATMUL_TILE", "PLAIN_CALLS",
           "RING_KERNELS", "RS_MATMUL_RING",
           "ag_matmul_ring", "allgather_matmul_fused", "consume_matmul",
           "consume_matmul_acc", "launches", "matmul_reducescatter_fused",
           "matmul_tile", "reset_counts", "rs_matmul_ring"]
