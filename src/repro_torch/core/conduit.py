"""Conduit: one collective API over a group, with named transports
(``repro.core.conduit``).

A :class:`Conduit` binds a :class:`~repro_torch.dist.group.Group` — the
port's stand-in for the reference's mesh axis — to a transport policy,
an ART chunk size and a link model.  Transports:

``xla``
    The reference's XLA built-ins, here the group's builtin gloo
    collectives (``Group.all_gather``, ``all_reduce``, ``broadcast``,
    ``all_to_all``, and ``reduce_scatter`` as each foreign block sent
    straight to its owner since gloo has no reduce-scatter; barrier as the
    all-reduced count).
``ring``
    The paper-faithful unidirectional PUT rings for all six ops: n−1
    neighbour hops (``Group.exchange``/``Group.permute`` in place of
    ``lax.ppermute``), every hop split into ``chunk_bytes`` pieces that
    ride the same ring order.
``bidir``
    Two counter-rotating half-sized rings: the low half of each block
    rides the +1 ring, the high half the −1 ring, both directions of a
    hop in flight at once (``pipeline.ring_pipeline`` /
    ``Group.permute_start``).  barrier and broadcast walk both directions
    (n//2 hops reach the antipode); all_to_all enumerates its shifts as
    ±s, the same permutations as the ring in another order.  At n == 2,
    or a block of fewer than 2 rows, gather and reduce-scatter (and so
    all_reduce) fall back to the ring, as in the reference.
``fused``
    With a resident weight ``w`` the fused collective matmuls of
    ``kernels/cc_matmul`` (the hop consumed by a CUDA kernel); without one
    the bare collective delegates to the ``ring`` wire, as in the
    reference.

all_gather, reduce_scatter and all_to_all are differentiable on every
transport (``auto`` may pick any of them on a training path): the
gradient of a gather is the same wire's reduce-scatter of the cotangent
and the other way round, and a tiled all-to-all is its own transpose
(the expert exchange of ``models/moe_ep.py`` trains through it).
``xla``'s all_reduce is differentiable too, its backward the all-reduce
of the cotangents (``models/tp_block.py`` sums its row products through
it where the residual is whole on every rank).

``auto`` is a policy, not a transport: :meth:`Conduit._resolve` prices
every registered transport and ART chunk on the call's payload bytes
(:func:`auto_select` over :func:`estimate_time`, the netmodel of
``core/netmodel.py``) and runs the cheapest; at a TP edge
:meth:`Conduit.matmul_schedule` prices the collective-matmul families
(:func:`matmul_edge_estimate`).  The link models it prices are the
reference's modelled links (the paper's QSFP+, the reference's ICI), not
a measurement of the port's wire, so a choice says which schedule the
model prefers, not which is faster on one card's gloo.

Every op can also run streamed (:meth:`Conduit.streamed`, the consumer
pipeline of ``core/pipeline.py``); :func:`pipeline_estimate` and
:func:`auto_select_pipeline` price such a pipeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import netmodel as nm
from repro_torch.core import pipeline as pl

OPS = (
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "all_to_all",
    "broadcast",
    "barrier",
)

LINKS: Dict[str, nm.LinkParams] = {
    "qsfp": nm.FSHMEM_QSFP,
    "ici": nm.TPU_ICI,
}

_REGISTRY: Dict[Tuple[str, str], Callable] = {}


def register(op: str, name: str):
    """Decorator: register ``fn`` as transport ``name`` for ``op``."""
    if op not in OPS:
        raise ValueError(f"unknown collective op {op!r} (one of {OPS})")

    def deco(fn):
        _REGISTRY[(op, name)] = fn
        return fn

    return deco


def unregister(op: str, name: str) -> None:
    """Remove a transport registered with :func:`register`."""
    del _REGISTRY[(op, name)]


def transports(op: str) -> Tuple[str, ...]:
    """Names of every transport registered for ``op`` (sorted)."""
    return tuple(sorted(name for o, name in _REGISTRY if o == op))


def resolve(op: str, name: str) -> Callable:
    """The transport callable for ``(op, name)``; ``KeyError`` (listing
    what is registered) for an unknown pair."""
    try:
        return _REGISTRY[(op, name)]
    except KeyError:
        raise KeyError(f"no transport {name!r} for {op!r}; registered: "
                       f"{transports(op)}") from None


# ---------------------------------------------------------------------------
# ring wire (differentiable)
# ---------------------------------------------------------------------------


def _ring_perm(n: int, shift: int = 1):
    return [(i, (i + shift) % n) for i in range(n)]


def ring_all_gather(x: torch.Tensor, group, dim: int,
                    chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """The ``ring`` wire's all_gather along ``dim`` (no autograd): block
    ``src`` lands at ``src·b`` after ``(my − src) % n`` hops of shift +1;
    ``chunk_bytes`` splits each hop's message into column pieces that
    ride the same ring order."""
    n, my = group.size, group.rank
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    b = xm.shape[0]
    flat = xm.reshape(b, -1)
    out = flat.new_empty((n * b, flat.shape[1]))
    c = pl.n_chunks(flat.numel() * flat.element_size(), chunk_bytes,
                    flat.shape[1])
    pieces = pl.chunk_slices(flat.shape[1], c)
    out[my * b:(my + 1) * b] = flat
    cur = [flat[:, lo:hi] for lo, hi in pieces]
    for hop in range(1, n):
        cur = group.exchange([(t, 1) for t in cur])
        src = (my - hop) % n
        for (lo, hi), t in zip(pieces, cur):
            out[src * b:(src + 1) * b, lo:hi] = t
    return out.reshape((n * b,) + xm.shape[1:]).movedim(0, dim)


def ring_reduce_scatter(x: torch.Tensor, group, dim: int,
                        chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """The ``ring`` wire's reduce_scatter along ``dim`` (no autograd): the
    accumulator of block q rides the ring and lands on rank q, each hop
    adding the local block as ``arrived + block`` (the reference's order)."""
    n, my = group.size, group.rank
    if n == 1:
        return x
    xm = x.movedim(dim, 0)
    if xm.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    b = xm.shape[0] // n
    flat = xm.reshape(n * b, -1)
    c = pl.n_chunks(b * flat.shape[1] * flat.element_size(), chunk_bytes,
                    flat.shape[1])
    pieces = pl.chunk_slices(flat.shape[1], c)

    def block(owner_offset: int, lo: int, hi: int) -> torch.Tensor:
        start = ((my + owner_offset) % n) * b
        return flat[start:start + b, lo:hi]

    cur = [block(-1, lo, hi).contiguous() for lo, hi in pieces]
    for hop in range(1, n):
        arrived = group.exchange([(t, 1) for t in cur])
        cur = [a + block(-(hop + 1), lo, hi)
               for a, (lo, hi) in zip(arrived, pieces)]
    out = torch.cat(cur, dim=1) if len(cur) > 1 else cur[0]
    return out.reshape((b,) + xm.shape[1:]).movedim(0, dim)


def bidir_all_gather(x: torch.Tensor, group, dim: int,
                     chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """The ``bidir`` wire's all_gather along ``dim`` (no autograd): the low
    half (``b // 2`` rows) of every block rides the +1 ring and lands at
    ``src·b``, the high half the −1 ring and lands at ``src·b + b//2``;
    each hop's two directions are in flight at once.  The ring at n == 2
    or a block of fewer than 2 rows."""
    n, my = group.size, group.rank
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    b = xm.shape[0]
    if n == 2 or b < 2:
        return ring_all_gather(x, group, dim, chunk_bytes)
    h = b // 2
    flat = xm.reshape(b, -1)
    out = flat.new_empty((n * b, flat.shape[1]))
    c = pl.n_chunks((x.numel() // 2) * x.element_size(), chunk_bytes,
                    flat.shape[1])
    pieces = pl.chunk_slices(flat.shape[1], c)
    out[my * b:(my + 1) * b] = flat

    def body(hop, arrived):
        cur_f, cur_b = arrived
        src_f, src_b = (my - hop) % n, (my + hop) % n
        for (lo, hi), tf, tb in zip(pieces, cur_f, cur_b):
            out[src_f * b:src_f * b + h, lo:hi] = tf
            out[src_b * b + h:(src_b + 1) * b, lo:hi] = tb
        return (cur_f, cur_b), None

    pl.ring_pipeline(([flat[:h, lo:hi].contiguous() for lo, hi in pieces],
                      [flat[h:, lo:hi].contiguous() for lo, hi in pieces]),
                     (_ring_perm(n, 1), _ring_perm(n, -1)), group, n - 1,
                     body)
    return out.reshape((n * b,) + xm.shape[1:]).movedim(0, dim)


def bidir_reduce_scatter(x: torch.Tensor, group, dim: int,
                         chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """The ``bidir`` wire's reduce_scatter along ``dim`` (no autograd): the
    low halves of the blocks reduce around the +1 ring (block q's
    accumulator starts on q + 1), the high halves around the −1 ring
    (starting on q − 1), each hop adding ``arrived + block``; the ring at
    n == 2 or a block of fewer than 2 rows."""
    n, my = group.size, group.rank
    if n == 1:
        return x
    xm = x.movedim(dim, 0)
    if xm.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    b = xm.shape[0] // n
    if n == 2 or b < 2:
        return ring_reduce_scatter(x, group, dim, chunk_bytes)
    h = b // 2
    flat = xm.reshape(n * b, -1)
    c = pl.n_chunks((x.numel() // n // 2) * x.element_size(), chunk_bytes,
                    flat.shape[1])
    pieces = pl.chunk_slices(flat.shape[1], c)

    def block(owner_offset: int, low: bool, lo: int, hi: int):
        start = ((my + owner_offset) % n) * b + (0 if low else h)
        return flat[start:start + (h if low else b - h), lo:hi]

    def body(hop, arrived):
        arr_f, arr_b = arrived
        cur_f = [a + block(-(hop + 1), True, lo, hi)
                 for a, (lo, hi) in zip(arr_f, pieces)]
        cur_b = [a + block(hop + 1, False, lo, hi)
                 for a, (lo, hi) in zip(arr_b, pieces)]
        return (cur_f, cur_b), (cur_f, cur_b)

    cur_f, cur_b = pl.ring_pipeline(
        ([block(-1, True, lo, hi).contiguous() for lo, hi in pieces],
         [block(1, False, lo, hi).contiguous() for lo, hi in pieces]),
        (_ring_perm(n, 1), _ring_perm(n, -1)), group, n - 1, body)
    out = torch.cat([torch.cat(cur_f, dim=1), torch.cat(cur_b, dim=1)])
    return out.reshape((b,) + xm.shape[1:]).movedim(0, dim)


def _gloo_all_gather(x, group, dim, chunk_bytes=None):
    return group.all_gather(x, dim)


def _gloo_reduce_scatter(x, group, dim, chunk_bytes=None):
    return group.reduce_scatter(x, dim)


#: each wire's (all_gather, reduce_scatter), the one the other's gradient
_GATHER_SCATTER = {"ring": (ring_all_gather, ring_reduce_scatter),
                   "bidir": (bidir_all_gather, bidir_reduce_scatter),
                   "xla": (_gloo_all_gather, _gloo_reduce_scatter)}


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, chunk_bytes, wire):
        ctx.group, ctx.dim, ctx.chunk_bytes = group, dim, chunk_bytes
        ctx.wire = wire
        return _GATHER_SCATTER[wire][0](x, group, dim, chunk_bytes)

    @staticmethod
    def backward(ctx, g):
        return (_GATHER_SCATTER[ctx.wire][1](g, ctx.group, ctx.dim,
                                            ctx.chunk_bytes),
                None, None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, chunk_bytes, wire):
        ctx.group, ctx.dim, ctx.chunk_bytes = group, dim, chunk_bytes
        ctx.wire = wire
        return _GATHER_SCATTER[wire][1](x, group, dim, chunk_bytes)

    @staticmethod
    def backward(ctx, g):
        return (_GATHER_SCATTER[ctx.wire][0](g, ctx.group, ctx.dim,
                                            ctx.chunk_bytes),
                None, None, None, None)


class _AllReduce(torch.autograd.Function):
    """The all-reduce of partial sums whose result every rank holds
    whole: each rank's cotangent is its part of the result's, so the
    backward is the all-reduce of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


class _AllToAll(torch.autograd.Function):
    """A tiled all_to_all over dim 0 is its own transpose: the cotangent
    of block q that arrived from rank q goes back to rank q by the same
    exchange, over the same transport."""

    @staticmethod
    def forward(ctx, x, wire, group, chunk_bytes):
        ctx.wire, ctx.group, ctx.chunk_bytes = wire, group, chunk_bytes
        return wire(x, group, chunk_bytes)

    @staticmethod
    def backward(ctx, g):
        return (ctx.wire(g.contiguous(), ctx.group, ctx.chunk_bytes), None,
                None, None)


@register("all_gather", "ring")
def _all_gather_ring(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _AllGather.apply(x, axis, dim, chunk_bytes, "ring")


@register("reduce_scatter", "ring")
def _reduce_scatter_ring(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _ReduceScatter.apply(x, axis, dim, chunk_bytes, "ring")


@register("barrier", "ring")
def _barrier_ring(*, axis, chunk_bytes=None) -> torch.Tensor:
    """A ones-token relayed n−1 hops: each arrival is one more
    participant; returns the group size as an int32 scalar."""
    group = axis
    n = group.size
    one = torch.ones((), dtype=torch.int32, device=group.device)
    if n == 1:
        return one
    acc = one

    def body(hop, arrived):
        nonlocal acc
        ((token,),) = arrived
        acc = acc + token
        return ((token,),), acc

    return pl.ring_pipeline(((one,),), (_ring_perm(n, 1),), group, n - 1,
                            body)


@register("broadcast", "ring")
def _broadcast_ring(x, *, root: int, axis, chunk_bytes=None):
    """Root's value propagates around the ring, one PUT a hop (n−1 hops);
    non-root inputs are ignored, as in shmem_broadcast."""
    group = axis
    n, my = group.size, group.rank
    if n == 1:
        return x

    def piece(flat):
        cur = flat.clone() if my == root else torch.zeros_like(flat)
        have = torch.tensor(my == root, device=flat.device)

        def body(hop, arrived):
            nonlocal cur, have
            ((cur_prev, have_prev),) = arrived
            cur = torch.where(~have & have_prev, cur_prev, cur)
            have = have | have_prev
            return ((cur, have),), cur

        return pl.ring_pipeline(((cur, have),), (_ring_perm(n, 1),), group,
                                n - 1, body)

    flat = x.reshape(1, -1)
    c = pl.n_chunks(x.numel() * x.element_size(), chunk_bytes,
                    max(1, flat.shape[-1]))
    if c == 1:
        out = piece(flat.contiguous())
    else:
        out = torch.cat([piece(p.contiguous()) for p in pl.split(flat, c, axis=-1)],
                        -1)
    return out.reshape(x.shape)


def _flat_all_reduce(x: torch.Tensor, group, rs, ag,
                     chunk_bytes: Optional[int]) -> torch.Tensor:
    """all-reduce as reduce-scatter + all-gather over the flattened
    payload, zero-padded to a multiple of n (2·(n−1)/n·|x| wire bytes a
    rank)."""
    n = group.size
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    reduced = rs(flat, group, 0, chunk_bytes)
    gathered = ag(reduced, group, 0, chunk_bytes)
    return gathered[:x.numel()].reshape(x.shape)


@register("all_reduce", "ring")
def _all_reduce_ring(x, *, axis, chunk_bytes=None):
    """Ring reduce-scatter + ring all-gather."""
    return _flat_all_reduce(x, axis, ring_reduce_scatter, ring_all_gather,
                            chunk_bytes)


def ring_all_to_all(x: torch.Tensor, group,
                    chunk_bytes: Optional[int] = None,
                    shifts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The ``ring`` wire's all-to-all (no autograd) as n−1 single-block
    ring permutes: ``x`` (n·g, ...) with rows [q·g, (q+1)·g) destined for
    rank q; returns the same shape with slot q holding what rank q sent
    here.  ``shifts`` orders the permutes (default 1 … n−1)."""
    n, my = group.size, group.rank
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {n} ranks")

    def piece(x2d):  # (n, Fi) -> (n, Fi)
        out = torch.zeros_like(x2d)
        out[my] = x2d[my]
        for shift in (range(1, n) if shifts is None else shifts):
            block = x2d[(my + shift) % n].contiguous()
            (arrived,) = group.exchange([(block, shift)])
            out[(my - shift) % n] = arrived
        return out

    hop_bytes = (x.numel() // n) * x.element_size()
    flat = x.reshape(n, -1)
    c = pl.n_chunks(hop_bytes, chunk_bytes, flat.shape[-1])
    if c == 1:
        out = piece(flat)
    else:
        out = torch.cat([piece(p) for p in pl.split(flat, c, axis=-1)], -1)
    return out.reshape(x.shape)


@register("all_to_all", "ring")
def _all_to_all_ring(x, *, axis, chunk_bytes=None):
    """:func:`ring_all_to_all`, differentiable: its backward is the ring
    all-to-all of the cotangent."""
    return _AllToAll.apply(x, ring_all_to_all, axis, chunk_bytes)


# ---------------------------------------------------------------------------
# bidir transports — two counter-rotating half-sized rings
# ---------------------------------------------------------------------------


@register("barrier", "bidir")
def _barrier_bidir(*, axis, chunk_bytes=None) -> torch.Tensor:
    """Tokens walk both directions; rank my hears my−h (+1 ring) and my+h
    (−1 ring): n//2 forward and (n−1)//2 backward hops count every rank
    once."""
    group = axis
    n = group.size
    one = torch.ones((), dtype=torch.int32, device=group.device)
    if n == 1:
        return one
    fwd, bwd = _ring_perm(n, 1), _ring_perm(n, -1)
    acc = tf = tb = one
    for h in range(1, n // 2 + 1):
        pend_f = group.permute_start([tf], fwd)
        pend_b = (group.permute_start([tb], bwd) if h <= (n - 1) // 2
                  else None)
        (tf,) = pend_f.wait()
        acc = acc + tf
        if pend_b is not None:
            (tb,) = pend_b.wait()
            acc = acc + tb
    return acc


@register("broadcast", "bidir")
def _broadcast_bidir(x, *, root: int, axis, chunk_bytes=None):
    """The value floods outward from root in both directions: n//2 hops
    reach the antipode instead of the ring's n−1."""
    group = axis
    n, my = group.size, group.rank
    if n == 1:
        return x
    fwd, bwd = _ring_perm(n, 1), _ring_perm(n, -1)

    def piece(flat):
        cur = flat.clone() if my == root else torch.zeros_like(flat)
        have = torch.tensor(my == root, device=flat.device)
        for _ in range(n // 2):
            pend_f = group.permute_start([cur, have], fwd)
            pend_b = group.permute_start([cur, have], bwd)
            cur_f, have_f = pend_f.wait()
            cur_b, have_b = pend_b.wait()
            cur = torch.where(~have & have_f, cur_f,
                              torch.where(~have & have_b, cur_b, cur))
            have = have | have_f | have_b
        return cur

    flat = x.reshape(1, -1)
    c = pl.n_chunks(x.numel() * x.element_size(), chunk_bytes,
                    max(1, flat.shape[-1]))
    if c == 1:
        out = piece(flat.contiguous())
    else:
        out = torch.cat([piece(p.contiguous())
                         for p in pl.split(flat, c, axis=-1)], -1)
    return out.reshape(x.shape)


@register("all_gather", "bidir")
def _all_gather_bidir(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _AllGather.apply(x, axis, dim, chunk_bytes, "bidir")


@register("reduce_scatter", "bidir")
def _reduce_scatter_bidir(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _ReduceScatter.apply(x, axis, dim, chunk_bytes, "bidir")


@register("all_reduce", "bidir")
def _all_reduce_bidir(x, *, axis, chunk_bytes=None):
    """Bidir reduce-scatter + bidir all-gather."""
    return _flat_all_reduce(x, axis, bidir_reduce_scatter, bidir_all_gather,
                            chunk_bytes)


def bidir_shifts(n: int) -> Tuple[int, ...]:
    """The ``bidir`` all_to_all's shift order: +1, −1, +2, −2, … (−s as
    n − s), up to ±n//2: the ring's permutations, each once."""
    shifts = []
    for s in range(1, n // 2 + 1):
        shifts.append(s)
        if s <= (n - 1) // 2:
            shifts.append(n - s)
    return tuple(shifts)


def bidir_all_to_all(x: torch.Tensor, group,
                     chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """The ``bidir`` wire's all-to-all (no autograd): the ring's permutes
    in the order of :func:`bidir_shifts` (the same data moved; the cost
    model prices the shorter hop distance)."""
    return ring_all_to_all(x, group, chunk_bytes,
                           shifts=bidir_shifts(group.size))


@register("all_to_all", "bidir")
def _all_to_all_bidir(x, *, axis, chunk_bytes=None):
    """:func:`bidir_all_to_all`, differentiable as the ring's."""
    return _AllToAll.apply(x, bidir_all_to_all, axis, chunk_bytes)


# ---------------------------------------------------------------------------
# xla transports — the group's builtin gloo collectives
# ---------------------------------------------------------------------------


@register("barrier", "xla")
def _barrier_xla(*, axis, chunk_bytes=None) -> torch.Tensor:
    one = torch.ones((), dtype=torch.int32, device=axis.device)
    return axis.all_reduce(one)


@register("broadcast", "xla")
def _broadcast_xla(x, *, root: int, axis, chunk_bytes=None):
    return axis.broadcast(x, root)


@register("all_gather", "xla")
def _all_gather_xla(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _AllGather.apply(x, axis, dim, chunk_bytes, "xla")


@register("reduce_scatter", "xla")
def _reduce_scatter_xla(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _ReduceScatter.apply(x, axis, dim, chunk_bytes, "xla")


@register("all_reduce", "xla")
def _all_reduce_xla(x, *, axis, chunk_bytes=None):
    return _AllReduce.apply(x, axis)


def _gloo_all_to_all(x, group, chunk_bytes=None):
    return group.all_to_all(x)


@register("all_to_all", "xla")
def _all_to_all_xla(x, *, axis, chunk_bytes=None):
    """The group's gloo all-to-all, differentiable: its backward is the
    gloo all-to-all of the cotangent."""
    return _AllToAll.apply(x, _gloo_all_to_all, axis, chunk_bytes)


@register("all_gather", "fused")
def _all_gather_fused(x, *, axis, chunk_bytes=None, w=None,
                      bidirectional: bool = True, dim: int = 0):
    """With a resident weight ``w`` (K, N_loc): the fused
    ``all_gather(x) @ w`` of ``kernels/cc_matmul`` (rows on ``x``'s
    second-to-last dim).  Without one there is nothing to fuse into, so
    the bare gather rides the ``ring`` wire."""
    if w is None:
        return _all_gather_ring(x, axis=axis, chunk_bytes=chunk_bytes,
                                dim=dim)
    from repro_torch.kernels.cc_matmul.ops import allgather_matmul_fused

    return allgather_matmul_fused(x, w, axis, bidirectional=bidirectional)


@register("reduce_scatter", "fused")
def _reduce_scatter_fused(x, *, axis, chunk_bytes=None, w=None,
                          bidirectional: bool = True, dim: int = 0):
    """Fused ``reduce_scatter(x @ w)``; without a weight, the ``ring``
    wire (see :func:`_all_gather_fused`)."""
    if w is None:
        return _reduce_scatter_ring(x, axis=axis, chunk_bytes=chunk_bytes,
                                    dim=dim)
    from repro_torch.kernels.cc_matmul.ops import matmul_reducescatter_fused

    return matmul_reducescatter_fused(x, w, axis,
                                      bidirectional=bidirectional)


# ---------------------------------------------------------------------------
# cost model and the auto policy (Fig. 5 as a runtime decision)
# ---------------------------------------------------------------------------

#: candidate ART chunk sizes the auto policy sweeps (bytes)
CHUNK_CANDIDATES = (256, 1024, 4096, 16384, 65536, 262144)


def _default_packet(link: nm.LinkParams) -> int:
    return max(link.packet_overhead_bytes)


def estimate_time(op: str, transport: str, *, size_bytes: int,
                  axis_size: int, link: nm.LinkParams = nm.FSHMEM_QSFP,
                  chunk_bytes: Optional[int] = None) -> float:
    """Modeled wall-clock of one collective (``repro.core.conduit``'s
    formula, term for term).

    ``size_bytes`` is the op's global payload: for ``all_gather`` the
    gathered size (local shard × n), for ``reduce_scatter`` and
    ``all_to_all`` the whole per-rank input, for ``all_reduce`` and
    ``broadcast`` the tensor; every ring hop then moves ``S/n`` bytes of
    the bandwidth-optimal ops.  The axis is a ring of full-duplex links;
    ``ring``/``bidir`` messages travel one hop, ``bidir`` with half the
    bytes a direction; ``xla`` is a distance-oblivious doubling schedule
    (round k's messages cross 2^k links); each message is priced by
    ``netmodel.put_time`` at packet size ``chunk_bytes`` (default the
    link's largest).  ``fused`` prices as the ring wire a bare gather or
    scatter rides.  An unmodeled pair raises ``ValueError``."""
    n, s = int(axis_size), int(size_bytes)
    if n <= 1:
        return 0.0
    if transport == "fused" and op in ("all_gather", "reduce_scatter"):
        transport = "ring"
    p = int(chunk_bytes or _default_packet(link))
    rounds = max(1, math.ceil(math.log2(n)))

    def t_put(b: float) -> float:
        return nm.put_time(link, max(1, int(b)), p)

    if op == "barrier":
        s = 4
    if op in ("all_gather", "reduce_scatter", "all_reduce", "barrier"):
        phases = 2 if op == "all_reduce" else 1
        if op == "barrier":
            if transport == "xla":
                return rounds * t_put(s)
            if transport == "ring":
                return (n - 1) * t_put(s)
            if transport == "bidir":
                return -(-n // 2) * t_put(s)
            raise ValueError(
                f"unknown (op, transport) = ({op!r}, {transport!r})")
        if transport == "xla":
            one = sum(t_put((s / n) * (4 ** k)) for k in range(rounds))
            return phases * one
        if transport == "ring":
            return phases * (n - 1) * t_put(s / n)
        if transport == "bidir":
            return phases * (n - 1) * t_put(s / (2 * n))
    if op == "broadcast":
        if transport == "xla":
            return sum(t_put(s * (2 ** k)) for k in range(rounds))
        c = max(1, -(-s // p))
        if transport == "ring":
            return (n - 2 + c) * t_put(s / c)
        if transport == "bidir":
            return (n // 2 - 1 + c) * t_put(s / c)
    if op == "all_to_all":
        if transport == "xla":
            return sum(t_put((s / 2) * (2 ** k)) for k in range(rounds))
        if transport == "ring":
            return sum(t_put((s / n) * d) for d in range(1, n))
        if transport == "bidir":
            fwd = sum(t_put((s / n) * d) for d in range(1, n // 2 + 1))
            bwd = sum(t_put((s / n) * d) for d in range(1, (n - 1) // 2 + 1))
            return max(fwd, bwd)
    raise ValueError(f"unknown (op, transport) = ({op!r}, {transport!r})")


def matmul_edge_estimate(op: str, transport: str, *, size_bytes: int,
                         axis_size: int, compute_time: float,
                         link: nm.LinkParams = nm.FSHMEM_QSFP,
                         chunk_bytes: Optional[int] = None) -> float:
    """Modeled wall-clock of a collective-matmul edge: ``compute_time`` of
    matmul riding an all_gather or reduce_scatter of ``size_bytes``
    (global payload).  ``xla`` serializes the two; ``ring``/``bidir``
    (``core/overlap.py``) interleave n sub-matmuls with n − 1 hops, each
    paying ``netmodel.hop_launch_overhead``; ``fused`` (the kernels'
    ring) pays it once, with the best direction split and no host
    command a hop."""
    n, s = int(axis_size), int(size_bytes)
    if op not in ("all_gather", "reduce_scatter"):
        raise ValueError(f"not a collective-matmul edge op: {op!r}")
    if n <= 1:
        return float(compute_time)
    if transport == "xla":
        return compute_time + estimate_time(
            op, "xla", size_bytes=s, axis_size=n, link=link,
            chunk_bytes=chunk_bytes)
    p = int(chunk_bytes or _default_packet(link))
    hop_bytes = s / n
    per_dir = hop_bytes if transport == "ring" else hop_bytes / 2
    tx = nm.put_time(link, max(1, int(per_dir)), p)
    oh = nm.hop_launch_overhead(link, int(hop_bytes))
    computes = [compute_time / n] * n
    wires = [tx] * (n - 1) + [0.0]       # the last block is resident
    if transport in ("ring", "bidir"):
        return nm.pipeline_time([tc + oh for tc in computes], wires)
    if transport == "fused":
        half = nm.put_time(link, max(1, int(hop_bytes / 2)), p)
        tx_f = min(tx, half) - link.latency.t_host_cmd
        tx_f = max(tx_f, per_dir / link.peak_bandwidth)
        wires_f = [tx_f] * (n - 1) + [0.0]
        return nm.fused_pipeline_time(computes, wires_f,
                                      launch_overhead=oh)
    raise ValueError(f"unknown matmul-edge transport {transport!r}")


def auto_select(op: str, *, size_bytes: int, axis_size: int,
                link: nm.LinkParams = nm.FSHMEM_QSFP,
                chunk_bytes: Optional[int] = None,
                compute_time: Optional[float] = None
                ) -> Tuple[str, Optional[int]]:
    """The (transport, chunk_bytes) with the least :func:`estimate_time`
    over every registered transport and :data:`CHUNK_CANDIDATES` (or the
    pinned ``chunk_bytes``); a transport the model cannot price is
    skipped.  With ``compute_time`` the payload is a collective-matmul
    edge, priced by :func:`matmul_edge_estimate`."""
    if axis_size <= 1:
        return "xla", None
    candidates = (chunk_bytes,) if chunk_bytes else CHUNK_CANDIDATES
    best: Tuple[float, str, Optional[int]] = (float("inf"), "xla", None)
    for name in transports(op):
        for chunk in candidates:
            try:
                if compute_time is None:
                    t = estimate_time(op, name, size_bytes=size_bytes,
                                      axis_size=axis_size, link=link,
                                      chunk_bytes=chunk)
                else:
                    t = matmul_edge_estimate(
                        op, name, size_bytes=size_bytes,
                        axis_size=axis_size, compute_time=compute_time,
                        link=link, chunk_bytes=chunk)
            except ValueError:
                break                      # unmodeled transport: skip it
            if t < best[0]:
                best = (t, name, chunk)
    return best[1], best[2]


#: candidate chunk counts the pipeline auto policy sweeps
PIPELINE_CHUNKS = (1, 2, 4, 8, 16, 32, 64)


def pipeline_estimate(op: str, transport: str, *, size_bytes: int,
                      axis_size: int, n_chunks: int,
                      compute_time: float = 0.0,
                      link: nm.LinkParams = nm.FSHMEM_QSFP,
                      chunk_bytes: Optional[int] = None) -> float:
    """Modeled wall-clock of a streamed schedule of ``op``: ``n_chunks``
    collectives of ``size_bytes / n_chunks`` interleaved with
    ``compute_time`` of work (``netmodel.pipeline_time``); one chunk is
    the bulk baseline, compute then wire."""
    c = max(1, int(n_chunks))
    per_wire = estimate_time(
        op, transport, size_bytes=max(1, round(size_bytes / c)),
        axis_size=axis_size, link=link, chunk_bytes=chunk_bytes)
    if c == 1:
        return compute_time + per_wire
    return nm.pipeline_time([compute_time / c] * c, [per_wire] * c)


def crossover_bytes(op: str, *, axis_size: int,
                    link: nm.LinkParams = nm.FSHMEM_QSFP, lo: int = 16,
                    hi: int = 1 << 30) -> Optional[int]:
    """The smallest payload (on a power-of-two grid from ``lo``) at which
    :func:`auto_select` leaves ``xla``; None if it never does up to
    ``hi``."""
    if axis_size <= 1:
        return None
    s = lo
    while s <= hi:
        name, _ = auto_select(op, size_bytes=s, axis_size=axis_size,
                              link=link)
        if name != "xla":
            return s
        s *= 2
    return None


def auto_select_pipeline(op: str, *, size_bytes: int, axis_size: int,
                         compute_time: float = 0.0,
                         link: nm.LinkParams = nm.FSHMEM_QSFP,
                         chunk_bytes: Optional[int] = None,
                         chunk_counts: Sequence[int] = PIPELINE_CHUNKS
                         ) -> Tuple[str, Optional[int], int]:
    """The ``(transport, chunk_bytes, n_chunks)`` with the least
    :func:`pipeline_estimate`; bulk (one chunk) is always a candidate."""
    if axis_size <= 1:
        return "xla", None, 1
    candidates = (chunk_bytes,) if chunk_bytes else CHUNK_CANDIDATES
    best: Tuple[float, str, Optional[int], int] = (float("inf"), "xla",
                                                   None, 1)
    for name in transports(op):
        for chunk in candidates:
            for c in chunk_counts:
                try:
                    t = pipeline_estimate(
                        op, name, size_bytes=size_bytes, axis_size=axis_size,
                        n_chunks=c, compute_time=compute_time, link=link,
                        chunk_bytes=chunk)
                except ValueError:
                    break                  # unmodeled transport: skip it
                if t < best[0]:
                    best = (t, name, chunk, c)
            else:
                continue
            break
    return best[1], best[2], best[3]


# ---------------------------------------------------------------------------
# the user-facing handle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conduit:
    """A bound (group, transport policy, chunk size, link model).

    ``axis`` is the :class:`~repro_torch.dist.group.Group` the collectives
    run over — the port's counterpart of the reference's mesh-axis name.
    ``transport="auto"`` resolves a call from its payload's byte size
    (:func:`auto_select`).
    """

    axis: object
    transport: str = "auto"    # "xla" | "ring" | "bidir" | "fused" | "auto"
    chunk_bytes: Optional[int] = None
    link: str = "qsfp"         # key into LINKS

    def _resolve(self, op: str, size_bytes: int
                 ) -> Tuple[str, Optional[int]]:
        """(transport, chunk) of a call of ``op`` on ``size_bytes`` of
        global payload: the policy's own, or ``auto``'s choice."""
        if self.transport != "auto":
            return self.transport, self.chunk_bytes
        return auto_select(op, size_bytes=size_bytes,
                           axis_size=self.axis.size, link=LINKS[self.link],
                           chunk_bytes=self.chunk_bytes)

    def _call(self, op: str, x, **kw):
        size = x.numel() * x.element_size()
        if op == "all_gather":
            # the global payload: every rank's shard
            size *= self.axis.size
        name, chunk = self._resolve(op, size)
        return resolve(op, name)(x, axis=self.axis, chunk_bytes=chunk, **kw)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Local blocks along ``dim`` → ``n`` blocks in rank order."""
        return self._call("all_gather", x, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``n`` blocks along ``dim`` → block q summed onto rank q."""
        return self._call("reduce_scatter", x, dim=dim)

    def barrier(self) -> torch.Tensor:
        """Full-group rendezvous; returns the group size on every rank."""
        name, chunk = self._resolve("barrier", 4)
        return resolve("barrier", name)(axis=self.axis, chunk_bytes=chunk)

    def broadcast(self, x: torch.Tensor, root: int) -> torch.Tensor:
        """Rank ``root``'s ``x`` delivered to every rank."""
        return self._call("broadcast", x, root=root)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum of ``x`` across the group, on every rank."""
        return self._call("all_reduce", x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled exchange: dim 0 a multiple of n; block q of ``x`` goes to
        rank q, returns the blocks the peers addressed here."""
        return self._call("all_to_all", x)

    def streamed(self, op: str, payloads, *, work=None, **kw):
        """Per-chunk schedule of ``op`` instead of one bulk call: chunk k's
        collective is issued while ``work(k−1, arrived)`` digests the
        previous arrival (``pipeline.streamed``), each chunk resolved on
        its own bytes.  Returns the per-chunk results, in order; each is
        bit-identical to the matching slice of the bulk call when the
        split is orthogonal to the op's rank-blocking layout (see the
        reference's docstring)."""
        return pl.streamed(len(payloads),
                           lambda k: self._call(op, payloads[k], **kw), work)

    def matmul_bidirectional(self, size_bytes: int) -> bool:
        """Whether the ring-matmul schedules counter-rotate: ``bidir``
        yes, ``ring`` no, anything else by the cost model restricted to
        {ring, bidir}."""
        if self.transport == "bidir":
            return True
        if self.transport == "ring":
            return False
        n = self.axis.size
        link = LINKS[self.link]
        t_ring = estimate_time("all_gather", "ring", size_bytes=size_bytes,
                               axis_size=n, link=link,
                               chunk_bytes=self.chunk_bytes)
        t_bidir = estimate_time("all_gather", "bidir",
                                size_bytes=size_bytes, axis_size=n,
                                link=link, chunk_bytes=self.chunk_bytes)
        return t_bidir <= t_ring

    def matmul_schedule(self, op: str, size_bytes: int,
                        compute_time: Optional[float] = None) -> str:
        """Which collective-matmul family runs at a TP edge ``op``:
        ``ring``/``bidir`` (``core/overlap.py``) or ``fused``
        (``kernels/cc_matmul``).  Those three pass through; ``xla`` and
        ``auto`` price the families on the edge's global ``size_bytes``
        and ``compute_time`` (:func:`matmul_edge_estimate`), or without a
        compute time choose between the two rings by
        :meth:`matmul_bidirectional`."""
        if self.transport in ("ring", "bidir", "fused"):
            return self.transport
        if compute_time is None:
            return "bidir" if self.matmul_bidirectional(size_bytes) else "ring"
        n = self.axis.size
        link = LINKS[self.link]
        best, best_t = "ring", float("inf")
        for name in ("ring", "bidir", "fused"):
            t = matmul_edge_estimate(
                op, name, size_bytes=size_bytes, axis_size=n,
                compute_time=compute_time, link=link,
                chunk_bytes=self.chunk_bytes)
            if t < best_t:
                best, best_t = name, t
        return best


__all__ = ["CHUNK_CANDIDATES", "Conduit", "LINKS", "OPS", "PIPELINE_CHUNKS",
           "auto_select", "auto_select_pipeline", "bidir_all_gather",
           "bidir_all_to_all", "bidir_reduce_scatter", "bidir_shifts",
           "crossover_bytes", "estimate_time", "matmul_edge_estimate",
           "pipeline_estimate", "register", "resolve", "ring_all_gather",
           "ring_all_to_all", "ring_reduce_scatter", "transports",
           "unregister"]
