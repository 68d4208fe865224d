"""The protocol of the whole-ring ops (``ag_matmul_ring`` /
``rs_matmul_ring``), written once: :func:`ring_plan` lists what one rank
enqueues for one ring call, in order.  The card's launcher
(``csrc/cc_matmul.cu``, ``run_plan``) enqueues exactly these operations,
and the CPU tests (``tests/test_torch_ring_plan.py``) run every rank's
plan under a scheduler that takes the ranks in any order.

A rank enqueues the whole call on one stream, PyTorch's current one: the
hop products (the hop kernel) and the forwards (``cudaMemcpyAsync``
device to device into the next rank's mapped slot: the copy engine moves
them), each after the one before.  It owns one channel a ring direction,
mapped by the previous rank (``peer.py``): two counters and two slots.
Both counters only grow, and a call's values are relative to the bases
the host keeps (``peer.Channel``):

* ``arrive`` (written by the previous rank) counts the slots forwarded into
  this channel: arrival ``a`` of a call (``a`` = 1 … n−1) lands in slot
  ``a % 2`` and then sets ``arrive`` to ``a``;
* ``done`` (written by this rank) is the number of hops this rank has
  finished: every read of the hop's slot (its product and, for AG, its
  forward).  A forward into the next rank's slot ``(h+1) % 2`` waits for
  the next rank's ``done`` to reach ``h``: that rank has finished hop
  h − 1, the last to read the slot.

Every hand-off between ranks is a ``wait`` on a counter, which the card's
front end holds in stream order (``cuStreamWaitValue64``, greater or
equal), and a ``write`` after the copy or product it publishes
(``cuStreamWriteValue64``, with its memory barrier).  A rank whose
neighbour is behind has no runnable work, and the card runs another
rank's context.  The same protocol on a second stream a rank for the
forwards, joined to the first by events, ran 2.5–5.9× slower a call on
the card (``PERF.md`` §6): every join not yet met held the rank's
context as a wait on a neighbour does, so a call paid for several more
context switches; the forward and the product of one rank do not overlap
on a card whose ranks take turns anyway.

AG (``all_gather(x) @ w``, ``ag_matmul_ring_tpu``): hop h multiplies the
block of rank ``(rank − dir·h) mod n`` (``x`` itself at hop 0, else slot
``h % 2``) into that block of the output, then forwards the same block
into the next rank's slot ``(h+1) % 2`` (hops 0 … n−2; hop 0 reads ``x``
in place, no seed copy).

RS (``reduce_scatter(x @ w)``, ``rs_matmul_ring_tpu``): hop h adds the
local partial of row block ``(rank − dir·(h+1)) mod n`` to the arrived
accumulator (slot ``h % 2``; none at hop 0) in the reference's order,
``arrived + dot``, into the local scratch ``RES`` (the output at the last
hop), then forwards it into the next rank's slot ``(h+1) % 2``.  The
partial is taken after the arrival, by one accumulating hop product
(``consume_matmul_acc``'s kernel), so a call is n hop kernels; on one
stream computing it before the arrival would overlap nothing.

Operations are tuples ``(kind, a, b, c, d)`` (:class:`Op`); the launcher
reads them as rows of :data:`FIELDS` int64 (:func:`encode`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

#: what an operation does (the launcher's codes)
WAIT, WRITE, GEMM, COPY = 1, 2, 3, 4
#: buffers: the caller's x, this channel's two slots, the local
#: accumulator (RS), the caller's output
X, SLOT0, SLOT1, RES, OUT = 0, 1, 2, 3, 4
NONE = -1
#: counters: this channel's ``arrive`` and the next rank's ``done`` (waited
#: on); this channel's ``done`` and the next rank's ``arrive`` (written)
ARRIVE, NEXT_DONE, DONE, NEXT_ARRIVE = 0, 1, 2, 3
#: int64 fields an operation takes in the launcher's encoding
FIELDS = 5


class Op(NamedTuple):
    """One enqueued operation.  ``wait``/``write``: ``a`` the counter,
    ``b`` its value relative to the call's base.  ``gemm``: ``a`` the
    operand (AG: ``X`` or a slot; RS: always ``X``), ``b`` the block (AG:
    the output block; RS: x's row block), ``c`` the fp32 accumulator
    (``NONE`` or a slot), ``d`` the destination (AG: ``OUT``; RS: ``RES``
    or ``OUT``).  ``copy``: ``a`` the source buffer, ``b`` the next rank's
    slot (0 or 1)."""

    kind: int
    a: int = 0
    b: int = 0
    c: int = 0
    d: int = 0


def _check(op: str, n: int, rank: int, direction: int) -> None:
    if op not in ("ag", "rs"):
        raise ValueError(f"ring_plan: op {op!r} is not 'ag' or 'rs'")
    if n < 2 or not 0 <= rank < n or direction not in (1, -1):
        raise ValueError(f"ring_plan: rank {rank} of {n}, direction "
                         f"{direction}")


@functools.lru_cache(maxsize=None)
def ring_plan(op: str, n: int, rank: int, direction: int) -> Tuple[Op, ...]:
    """Every operation rank ``rank`` of ``n`` enqueues for one ring call
    of ``op`` (``"ag"`` or ``"rs"``) in ``direction`` (±1), in enqueue
    order (see the module docstring)."""
    _check(op, n, rank, direction)
    ops = []
    for h in range(n):
        last = h == n - 1
        slot = SLOT0 + h % 2
        if h > 0:
            ops.append(Op(WAIT, ARRIVE, h))
        if op == "ag":
            src = X if h == 0 else slot
            ops.append(Op(GEMM, src, (rank - direction * h) % n, NONE, OUT))
        else:
            src = RES
            ops += [Op(GEMM, X, (rank - direction * (h + 1)) % n,
                       NONE if h == 0 else slot, OUT if last else RES),
                    Op(WRITE, DONE, h + 1)]
        if not last:
            ops += [Op(WAIT, NEXT_DONE, h), Op(COPY, src, (h + 1) % 2),
                    Op(WRITE, NEXT_ARRIVE, h + 1)]
        if op == "ag":
            ops.append(Op(WRITE, DONE, h + 1))
    return tuple(ops)


@functools.lru_cache(maxsize=None)
def encode(op: str, n: int, rank: int, direction: int,
           ) -> Tuple[ctypes.Array, int]:
    """The plan as the launcher reads it: a ctypes array of
    ``FIELDS`` × len int64, and the number of operations."""
    plan = ring_plan(op, n, rank, direction)
    flat = [int(v) for o in plan for v in o]
    return (ctypes.c_longlong * len(flat))(*flat), len(plan)


__all__ = ["ARRIVE", "COPY", "DONE", "FIELDS", "GEMM", "NEXT_ARRIVE",
           "NEXT_DONE", "NONE", "OUT", "Op", "RES", "SLOT0", "SLOT1", "WAIT",
           "WRITE", "X", "encode", "ring_plan"]
