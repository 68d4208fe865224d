"""Conduit: one collective API over the TP group, with named transports
(the subset of ``repro.core.conduit`` that TP training over the fused
ring needs).

A :class:`Conduit` binds a :class:`~repro_torch.dist.group.Group` — the
port's stand-in for the reference's mesh axis — to a transport name, an
ART chunk size and a link model.  Ported transports:

``ring``
    The unidirectional PUT ring for ``all_gather`` and ``reduce_scatter``:
    n−1 neighbour hops (``Group.exchange`` with shift +1, the reference's
    ``lax.ppermute`` over ``_ring_perm(n, 1)``).  Both are differentiable:
    the gradient of the ring gather is the ring reduce-scatter of the
    cotangent, and the other way round.
``fused``
    With a resident weight ``w`` the fused collective matmuls of
    ``kernels/cc_matmul`` (the hop consumed by a CUDA kernel); without one
    the bare collective delegates to the ``ring`` wire, as in the
    reference.

The reference's other names (``xla``, ``bidir`` and the ``all_reduce``,
``all_to_all``, ``broadcast`` and ``barrier`` transports) are known to
:func:`transports`, so a policy that names them validates as in the
reference, but calling one raises ``NotImplementedError`` naming the
ROADMAP item that ports it.  So does ``transport="auto"``: its pricing
(``auto_select``, ``matmul_edge_estimate``) is not ported, and no other
schedule stands in for it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import netmodel as nm

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
                     "torch.distributed: xla/bidir transports, all_reduce, "
                     "all_to_all, broadcast, barrier)")
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


def transports(op: str) -> Tuple[str, ...]:
    """Names of every transport the reference registers for ``op``."""
    return _KNOWN[op]


def resolve(op: str, name: str) -> Callable:
    """The transport callable for ``(op, name)``: ``KeyError`` for a name
    the reference does not know, ``NotImplementedError`` for one the port
    has not ported yet."""
    if name not in _KNOWN.get(op, ()):
        raise KeyError(f"no transport {name!r} for {op!r}; registered: "
                       f"{_KNOWN.get(op, ())}")
    try:
        return _REGISTRY[(op, name)]
    except KeyError:
        raise NotImplementedError(
            f"transport {name!r} for {op!r} is not ported yet: "
            f"{ROADMAP_SUBSTRATE}") from None


# ---------------------------------------------------------------------------
# ring wire (differentiable)
# ---------------------------------------------------------------------------


def _n_chunks(total_bytes: int, chunk_bytes: Optional[int],
              limit: int) -> int:
    """⌈total / chunk⌉ clamped to ``[1, limit]``; ``None`` means bulk."""
    if not chunk_bytes or total_bytes <= chunk_bytes:
        return 1
    return max(1, min(limit, -(-total_bytes // chunk_bytes)))


def _col_pieces(flat: torch.Tensor, c: int):
    """``c`` nearly equal, order-preserving column slices of a 2-D view."""
    f = flat.shape[-1]
    cuts = [round(i * f / c) for i in range(c + 1)]
    return [(lo, hi) for lo, hi in zip(cuts, cuts[1:]) if hi > lo]


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
    c = _n_chunks(flat.numel() * flat.element_size(), chunk_bytes,
                  flat.shape[1])
    pieces = _col_pieces(flat, c)
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
    c = _n_chunks(b * flat.shape[1] * flat.element_size(), chunk_bytes,
                  flat.shape[1])
    pieces = _col_pieces(flat, c)

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


@register("all_gather", "ring")
def _all_gather_ring(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _RingAllGather.apply(x, axis, dim, chunk_bytes)


@register("reduce_scatter", "ring")
def _reduce_scatter_ring(x, *, axis, chunk_bytes=None, dim: int = 0):
    return _RingReduceScatter.apply(x, axis, dim, chunk_bytes)


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
    transport: str = "auto"    # "ring" | "fused" (ported) | others raise
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
           "ring_all_gather", "ring_reduce_scatter", "transports"]
