"""ART on tensor-parallel matmuls: the collective-matmul schedules of
``repro.core.overlap``, with the wire the group's permute.

A transformer under tensor parallelism has the paper's producer→consumer
edge at every layer: an **all-gather edge** before a column-sharded
matmul (``all_gather(x) @ w``) and a **reduce-scatter edge** after a
row-sharded one (``reduce_scatter(x @ w)``).  Both split the product into
ring steps, each hop's ``Group.permute_start`` in flight while a block
product runs (Wang et al., ASPLOS'23: ART on a TPU ring):

* the unidirectional ring: n − 1 hops of |X|/n a call;
* the bidirectional ring: two counter-rotating half rings, both
  directions of a hop in flight at once (links are full-duplex).

Each function takes either ``conduit=`` (its transport picks the
direction: ``ring`` one, ``bidir`` two, ``auto``/``xla`` by the cost
model on the edge's global bytes, :meth:`Conduit.matmul_bidirectional`)
or ``axis=`` (a group) plus ``bidirectional=``.  Activations are (b, K)
or (B, b, K): the leading batch dim is the reference's ``jax.vmap``,
written out, each batch element's payload priced on its own.

A block product is the reference's ``jnp.dot(...,
preferred_element_type=float32)``: a plain product outside any kernel
(cuBLAS with an fp32 result on the card, fp32 on the CPU, where it is the
fused ops' plain hop products, so the two agree bit for bit).  The
placement, the halves (``b // 2`` rows; ``N // 2`` columns of the RS
weight) and the add order ``arrived + dot`` are the reference's.

Both ops are differentiable, each backward the other schedule of the
same family, as the fused ops' (``kernels/cc_matmul/ops.py``): for
``y = AG(x) @ w``, dx is the RS schedule of ``g @ wᵀ`` and dw is the
gathered x (kept from the forward's arrivals) transposed times g; for
``y = RS(x @ w)``, dx is the AG schedule of ``g @ wᵀ`` and dw is xᵀ times
the gathered g (kept from that schedule's arrivals).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def _ring_perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with an fp32 result: on the card a bf16 pair in one
    cuBLAS call with fp32 output, else both operands in fp32."""
    if a.is_cuda and a.dtype == w.dtype == torch.bfloat16:
        a2 = a.reshape(-1, a.shape[-1])
        y = torch.mm(a2, w, out_dtype=torch.float32)
        return y.view(*a.shape[:-1], w.shape[-1])
    return torch.matmul(a.float(), w.float())


def payload_bytes(op: str, x: torch.Tensor, w: torch.Tensor,
                  n: int) -> int:
    """The global payload of one batch element's edge, which the conduit
    prices the direction on: the AG's gathered rows (this rank's × n),
    the RS's full fp32 partial product."""
    if op == "all_gather":
        return x.shape[-2] * x.shape[-1] * x.element_size() * n
    return x.shape[-2] * w.shape[1] * 4


def _schedule(op: str, x: torch.Tensor, w: torch.Tensor, conduit, axis,
              bidirectional: bool) -> Tuple[object, bool]:
    """(group, bidirectional) from either calling convention: a conduit
    decides the direction on the edge's :func:`payload_bytes`."""
    if conduit is None:
        if axis is None:
            raise ValueError("pass either conduit= or axis=")
        return axis, bool(bidirectional)
    return conduit.axis, conduit.matmul_bidirectional(
        payload_bytes(op, x, w, conduit.axis.size))


def _directions(rows: int, group, bidirectional: bool
                ) -> List[Tuple[slice, int]]:
    """(rows of a block, ring shift) a direction: the whole block on the
    +1 ring, or the low half on +1 and the high half on −1."""
    if not bidirectional or group.size == 2:
        return [(slice(0, rows), 1)]
    h = rows // 2
    return [(slice(0, h), 1), (slice(h, rows), -1)]


def _ag(x: torch.Tensor, w: torch.Tensor, group, bidirectional: bool
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """all_gather(x) @ w on x (B, b, K): ((B, n·b, N) fp32, the gathered
    x (B, n·b, K)).  Hop k's arrivals are forwarded before their products
    are issued, so each product runs while the next hop is in flight."""
    n, my = group.size, group.rank
    bsz, b, k = x.shape
    out = torch.empty((bsz, n * b, w.shape[1]), dtype=torch.float32,
                      device=x.device)
    full = x.new_empty((bsz, n * b, k))
    dirs = _directions(b, group, bidirectional)
    perms = [_ring_perm(n, shift) for _, shift in dirs]

    def place(src: int, rows: slice, cur: torch.Tensor) -> None:
        at = slice(src * b + rows.start, src * b + rows.stop)
        full[:, at] = cur
        out[:, at] = _dot(cur, w)

    # a fresh copy each: a view's strides may steer the product elsewhere
    cur = [x.new_empty((bsz, rows.stop - rows.start, k)).copy_(x[:, rows])
           for rows, _ in dirs]
    pending = ([group.permute_start([c], p) for c, p in zip(cur, perms)]
               if n > 1 else [])
    for (rows, _), c in zip(dirs, cur):
        place(my, rows, c)
    for hop in range(1, n):
        cur = [p.wait()[0] for p in pending]
        pending = ([group.permute_start([c], p) for c, p in zip(cur, perms)]
                   if hop < n - 1 else [])
        for (rows, shift), c in zip(dirs, cur):
            place((my - shift * hop) % n, rows, c)
    return out, full


def _rs(x: torch.Tensor, w: torch.Tensor, group,
        bidirectional: bool) -> torch.Tensor:
    """reduce_scatter(x @ w) on x (B, n·b, K): (B, b, N) fp32.  The +1
    ring's accumulator of block q starts on q + 1 (the −1 ring's, over the
    high half of w's columns, on q − 1); while it flies, the product of
    the block it meets next runs, and the arrival adds it."""
    n, my = group.size, group.rank
    bsz, rows, _ = x.shape
    if rows % n:
        raise ValueError(f"reduce_scatter rows {rows} do not split over "
                         f"{n} ranks")
    b = rows // n
    cols = w.shape[1]
    if not bidirectional or n == 2:
        dirs = [(w, 1)]
    else:
        dirs = [(w[:, :cols // 2], 1), (w[:, cols // 2:], -1)]

    def block(owner_offset: int) -> torch.Tensor:
        start = ((my + owner_offset) % n) * b
        return x[:, start:start + b]

    acc = [_dot(block(-shift), wp) for wp, shift in dirs]
    for hop in range(1, n):
        pending = [group.permute_start([a], _ring_perm(n, shift))
                   for a, (_, shift) in zip(acc, dirs)]
        nxt = [_dot(block(-shift * (hop + 1)), wp) for wp, shift in dirs]
        acc = [p.wait()[0] + y for p, y in zip(pending, nxt)]
    return acc[0] if len(acc) == 1 else torch.cat(acc, dim=-1)


def _batched(x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 2:
        return x.unsqueeze(0)
    if x.dim() != 3:
        raise ValueError(f"expected (b, K) or (B, b, K), got "
                         f"{tuple(x.shape)}")
    return x


def _unbatched(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t[0] if like.dim() == 2 else t


def _dw(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``aᵀ @ g`` summed over the batch, in fp32."""
    a2 = a.reshape(-1, a.shape[-1]).float()
    g2 = g.reshape(-1, g.shape[-1]).float()
    return a2.t() @ g2


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, bidirectional):
        out, full = _ag(_batched(x), w, group, bidirectional)
        ctx.save_for_backward(full, w)
        ctx.group, ctx.bidirectional, ctx.two_d = (group, bidirectional,
                                                   x.dim() == 2)
        return _unbatched(out, x)

    @staticmethod
    def backward(ctx, g):
        full, w = ctx.saved_tensors
        g3 = _batched(g.contiguous())
        dx = _rs(g3, w.t().contiguous(), ctx.group, ctx.bidirectional)
        dx = dx[0] if ctx.two_d else dx
        return dx.to(full.dtype), _dw(full, g3).to(w.dtype), None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, bidirectional):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.bidirectional = group, bidirectional
        return _unbatched(_rs(_batched(x), w, group, bidirectional), x)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, g_full = _ag(_batched(g.contiguous()), w.t().contiguous(),
                         ctx.group, ctx.bidirectional)
        return (_unbatched(dx, x).to(x.dtype),
                _dw(x, g_full).to(w.dtype), None, None)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, *, axis=None,
                     bidirectional: bool = True,
                     conduit=None) -> torch.Tensor:
    """``all_gather(x) @ w`` without materializing the gather before the
    products: x (b, K) or (B, b, K) this rank's rows, w (K, N_loc) its
    resident column shard; returns (n·b, N_loc) / (B, n·b, N_loc) fp32,
    rank j's rows at ``[j·b, (j+1)·b)``.  Differentiable."""
    group, bidir = _schedule("all_gather", x, w, conduit, axis,
                             bidirectional)
    return _AllGatherMatmul.apply(x, w, group, bidir)


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, *, axis=None,
                         bidirectional: bool = True,
                         conduit=None) -> torch.Tensor:
    """``reduce_scatter(x @ w)`` with the scatter riding the products:
    x (n·b, K_loc) or (B, n·b, K_loc), w (K_loc, N) the resident row
    shard; returns (b, N) / (B, b, N) fp32, row block ``rank`` of the
    group's sum.  Differentiable."""
    group, bidir = _schedule("reduce_scatter", x, w, conduit, axis,
                             bidirectional)
    return _MatmulReduceScatter.apply(x, w, group, bidir)


__all__ = ["allgather_matmul", "matmul_reducescatter", "payload_bytes"]
