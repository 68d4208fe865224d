"""Conduit: one collective API over a group, with named transports
(``repro.core.conduit``).

A :class:`Conduit` binds a :class:`~repro_torch.dist.group.Group` — the
port's stand-in for the reference's mesh axis — to a transport name, an
ART chunk size and a link model.  Ported transports:

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
    ride the same ring order.  all_gather and reduce_scatter are
    differentiable: the gradient of the ring gather is the ring
    reduce-scatter of the cotangent, and the other way round.
``fused``
    With a resident weight ``w`` the fused collective matmuls of
    ``kernels/cc_matmul`` (the hop consumed by a CUDA kernel); without one
    the bare collective delegates to the ``ring`` wire, as in the
    reference.

The ``all_to_all`` of ``ring`` and of ``xla`` is differentiable too (the
expert exchange of ``models/moe_ep.py`` trains through it): a tiled
all-to-all is its own transpose, so its backward is the same transport's
all-to-all of the cotangent.

Every op can also run streamed (:meth:`Conduit.streamed`, the consumer
pipeline of ``core/pipeline.py``).  The reference's ``bidir`` transports
are known to :func:`transports`, so a policy that names them validates as
in the reference, but calling one raises ``NotImplementedError`` naming
the ROADMAP item that ports it.  So does ``transport="auto"``: its pricing
(``auto_select``, ``matmul_edge_estimate``) is not ported, and no other
schedule stands in for it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

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

#: every transport the reference registers, per op (``repro.core.conduit``)
_KNOWN: Dict[str, Tuple[str, ...]] = {
    "all_gather": ("bidir", "fused", "ring", "xla"),
    "reduce_scatter": ("bidir", "fused", "ring", "xla"),
    "all_reduce": ("bidir", "ring", "xla"),
    "all_to_all": ("bidir", "ring", "xla"),
    "broadcast": ("bidir", "ring", "xla"),
    "barrier": ("bidir", "ring", "xla"),
}

#: where the port of each unported piece is queued
ROADMAP_SUBSTRATE = ("ROADMAP queue 1 item 6 (PGAS substrate over "
                     "torch.distributed: the bidir transports)")
ROADMAP_AUTO = ("ROADMAP queue 1 item 7 (distributed steps: the `auto` "
                "transport policy and matmul_edge_estimate pricing)")
ROADMAP_OVERLAP = ("ROADMAP queue 1 item 7 (distributed steps: the "
                   "ring/bidir overlap schedules of core/overlap.py)")

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
    """Names of every transport the reference registers for ``op``, and
    of any the caller has registered since (sorted)."""
    return tuple(sorted(set(_KNOWN[op])
                        | {name for o, name in _REGISTRY if o == op}))


def resolve(op: str, name: str) -> Callable:
    """The transport callable for ``(op, name)``: ``KeyError`` for a name
    neither the reference nor a caller registers, ``NotImplementedError``
    for one the port has not ported yet."""
    fn = _REGISTRY.get((op, name))
    if fn is not None:
        return fn
    if name not in transports(op):
        raise KeyError(f"no transport {name!r} for {op!r}; registered: "
                       f"{transports(op)}")
    raise NotImplementedError(
        f"transport {name!r} for {op!r} is not ported yet: "
        f"{ROADMAP_SUBSTRATE}")


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


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, chunk_bytes):
        ctx.group, ctx.dim, ctx.chunk_bytes = group, dim, chunk_bytes
        return ring_all_gather(x, group, dim, chunk_bytes)

    @staticmethod
    def backward(ctx, g):
        return (ring_reduce_scatter(g, ctx.group, ctx.dim, ctx.chunk_bytes),
                None, None, None)


class _RingReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, chunk_bytes):
        ctx.group, ctx.dim, ctx.chunk_bytes = group, dim, chunk_bytes
        return ring_reduce_scatter(x, group, dim, chunk_bytes)

    @staticmethod
    def backward(ctx, g):
        return (ring_all_gather(g, ctx.group, ctx.dim, ctx.chunk_bytes),
                None, None, None)


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
    return _RingAllGather.apply(x, axis, dim, chunk_bytes)


@register("reduce_scatter", "ring")
def _reduce_scatter_ring(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _RingReduceScatter.apply(x, axis, dim, chunk_bytes)


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


@register("all_reduce", "ring")
def _all_reduce_ring(x, *, axis, chunk_bytes=None):
    """Ring reduce-scatter + ring all-gather over the flattened payload,
    zero-padded to a multiple of n (2·(n−1)/n·|x| wire bytes a rank)."""
    group = axis
    n = group.size
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    reduced = ring_reduce_scatter(flat, group, 0, chunk_bytes)
    gathered = ring_all_gather(reduced, group, 0, chunk_bytes)
    return gathered[:x.numel()].reshape(x.shape)


def ring_all_to_all(x: torch.Tensor, group,
                    chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """The ``ring`` wire's all-to-all (no autograd) as n−1 single-block
    ring permutes: ``x`` (n·g, ...) with rows [q·g, (q+1)·g) destined for
    rank q; returns the same shape with slot q holding what rank q sent
    here."""
    n, my = group.size, group.rank
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {n} ranks")

    def piece(x2d):  # (n, Fi) -> (n, Fi)
        out = torch.zeros_like(x2d)
        out[my] = x2d[my]
        for shift in range(1, n):
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
    return axis.all_gather(x, dim)


@register("reduce_scatter", "xla")
def _reduce_scatter_xla(x, *, axis, chunk_bytes=None, dim: int = 0):
    return axis.reduce_scatter(x, dim)


@register("all_reduce", "xla")
def _all_reduce_xla(x, *, axis, chunk_bytes=None):
    return axis.all_reduce(x)


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
# cost model (the ring/bidir all_gather terms of estimate_time)
# ---------------------------------------------------------------------------


def _default_packet(link: nm.LinkParams) -> int:
    return max(link.packet_overhead_bytes)


def estimate_time(op: str, transport: str, *, size_bytes: int,
                  axis_size: int, link: nm.LinkParams = nm.FSHMEM_QSFP,
                  chunk_bytes: Optional[int] = None) -> float:
    """Modeled wall-clock of one collective (``repro.core.conduit``'s
    formula), for ``all_gather`` and ``reduce_scatter`` over ``ring`` and
    ``bidir``; ``fused`` prices as the ring wire it delegates to.  Other
    (op, transport) pairs are not ported.  ``size_bytes`` is the global
    payload, so each ring hop moves ``S/n`` bytes."""
    n, s = int(axis_size), int(size_bytes)
    if n <= 1:
        return 0.0
    if transport == "fused" and op in ("all_gather", "reduce_scatter"):
        transport = "ring"
    if op not in ("all_gather", "reduce_scatter") \
            or transport not in ("ring", "bidir"):
        raise NotImplementedError(
            f"estimate_time({op!r}, {transport!r}) is not ported: "
            f"{ROADMAP_SUBSTRATE}")
    p = int(chunk_bytes or _default_packet(link))

    def t_put(b: float) -> float:
        return nm.put_time(link, max(1, int(b)), p)

    if transport == "ring":
        return (n - 1) * t_put(s / n)
    return (n - 1) * t_put(s / (2 * n))


# ---------------------------------------------------------------------------
# the user-facing handle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conduit:
    """A bound (group, transport, chunk size, link model).

    ``axis`` is the :class:`~repro_torch.dist.group.Group` the collectives
    run over — the port's counterpart of the reference's mesh-axis name.
    """

    axis: object
    transport: str = "auto"    # "ring" | "xla" | "fused"; bidir/auto raise
    chunk_bytes: Optional[int] = None
    link: str = "qsfp"         # key into LINKS

    def _resolve(self) -> str:
        if self.transport == "auto":
            raise NotImplementedError(
                f"transport 'auto' is not ported yet: {ROADMAP_AUTO}")
        return self.transport

    def _call(self, op: str, x, **kw):
        return resolve(op, self._resolve())(
            x, axis=self.axis, chunk_bytes=self.chunk_bytes, **kw)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Local blocks along ``dim`` → ``n`` blocks in rank order."""
        return self._call("all_gather", x, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """``n`` blocks along ``dim`` → block q summed onto rank q."""
        return self._call("reduce_scatter", x, dim=dim)

    def barrier(self) -> torch.Tensor:
        """Full-group rendezvous; returns the group size on every rank."""
        return resolve("barrier", self._resolve())(
            axis=self.axis, chunk_bytes=self.chunk_bytes)

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
        previous arrival (``pipeline.streamed``).  Returns the per-chunk
        results, in order; each is bit-identical to the matching slice of
        the bulk call when the split is orthogonal to the op's
        rank-blocking layout (see the reference's docstring)."""
        return pl.streamed(len(payloads),
                           lambda k: self._call(op, payloads[k], **kw), work)

    def matmul_bidirectional(self, size_bytes: int) -> bool:
        """Whether the fused ring-matmul schedules counter-rotate:
        ``bidir`` yes, ``ring`` no, anything else by the cost model
        restricted to {ring, bidir} (the branch ``fused`` takes)."""
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

    def matmul_schedule(self, op: str) -> str:
        """Which collective-matmul family runs at a TP edge ``op``.
        Explicit ring transports pass through; ``xla``/``auto`` would
        price the families on the edge's bytes and matmul time
        (``matmul_edge_estimate``), which is not ported."""
        if self.transport in ("ring", "bidir", "fused"):
            return self.transport
        raise NotImplementedError(
            f"matmul_schedule for transport {self.transport!r} prices the "
            f"schedule families, which is not ported yet: {ROADMAP_AUTO}")


__all__ = ["Conduit", "LINKS", "OPS", "ROADMAP_AUTO", "ROADMAP_OVERLAP",
           "ROADMAP_SUBSTRATE", "estimate_time", "register", "resolve",
           "ring_all_gather", "ring_all_to_all", "ring_reduce_scatter",
           "transports", "unregister"]
