"""ART — Automatic Result Transfer (paper Sec. III-B), over a rank group
(``repro.core.art``).

Instead of one bulk PUT after the computation, ART ships every finished
chunk of results during the computation, hiding the wire under the
remaining compute.  Here that is :func:`~repro_torch.core.pipeline.chunk_pipeline`
with a transfer that starts a :meth:`Group.permute_start` and returns its
:class:`Pending`: chunk k−1's message is in flight (gloo's own thread;
staged through host memory on the card) while chunk k computes, and is
waited on only when consumed.

* :func:`art_send` — generic producer → consumer chunk pipeline.
* :func:`art_matmul_reducescatter` — the paper's Fig. 6(a) parallel
  matmul, generalized from 2 ranks to an n-rank ring: partial sums ride a
  ring reduce-scatter chunk by chunk while the next row chunk computes.
* :func:`bulk_matmul_reducescatter` — the paper's baseline: the whole
  product, then one bulk reduce-scatter.
* :func:`split_conv_allgather` — Fig. 6(b): output channels split across
  ranks, synchronised and concatenated at the end.

The products are ``torch.matmul`` and ``conv2d`` (the reference leaves them
to XLA, outside any Pallas kernel); every rank of the group calls these
functions, in the same order.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.conduit import Conduit, _ring_perm
from repro_torch.core.pipeline import chunk_pipeline
from repro_torch.dist.group import Pending

# ---------------------------------------------------------------------------
# generic ART pipeline
# ---------------------------------------------------------------------------


def art_send(compute_chunk: Callable[[int], torch.Tensor], n_chunks: int,
             *, group, shift: int = 1, accumulate: bool = True):
    """Build an ART producer/consumer: each rank computes ``n_chunks``
    chunks with ``compute_chunk(k)`` and PUTs each finished chunk to
    ``rank + shift``; the receiver accumulates (or stacks) them.  Returns
    ``run() -> received``."""

    def run():
        perm = _ring_perm(group.size, shift)

        def transfer(k, prev):
            return group.permute_start([prev], perm)

        if accumulate:
            def init(c0):
                return torch.zeros_like(c0)

            def consume(acc, k, arrived):
                return acc + arrived[0]
        else:
            def init(c0):
                return c0.new_zeros((n_chunks,) + tuple(c0.shape))

            def consume(acc, k, arrived):
                acc[k] = arrived[0]
                return acc

        return chunk_pipeline(n_chunks, compute_chunk, transfer, consume,
                              init=init)

    return run


# ---------------------------------------------------------------------------
# paper case study (a): parallel matmul with ART partial-sum exchange
# ---------------------------------------------------------------------------


def art_matmul_reducescatter(m_cols: torch.Tensor, n_rows: torch.Tensor, *,
                             group, n_chunks: int) -> torch.Tensor:
    """Fig. 6(a), n-rank generalization.

    Rank p of n holds ``m_cols`` (R, K/n), column block p of M, and
    ``n_rows`` (K/n, C), row block p of N.  It computes the full-width
    partial product row chunk by row chunk; while the ring reduce-scatter
    of chunk k−1 is in flight it computes chunk k.  Block ``b_q`` starts
    at rank q+1 and moves +1 around the ring gathering each rank's
    partial, arriving complete at its owner after n−1 hops (``arrived +
    local`` at each, the reference's order).  Returns (R, C/n): rank p's
    column block of ``M @ N``, fp32."""
    n, my = group.size, group.rank
    rows = m_cols.shape[0]
    cols = n_rows.shape[1]
    if rows % n_chunks or cols % n:
        raise ValueError(f"art_matmul_reducescatter: {rows} rows over "
                         f"{n_chunks} chunks, {cols} columns over {n} ranks")
    rchunk, ccols = rows // n_chunks, cols // n
    perm = _ring_perm(n, 1)
    mf, nf = m_cols.float(), n_rows.float()

    def col_block(full: torch.Tensor, owner_offset: int) -> torch.Tensor:
        start = ((my + owner_offset) % n) * ccols
        return full[:, start:start + ccols]

    def compute(k: int) -> torch.Tensor:
        return torch.matmul(mf[k * rchunk:(k + 1) * rchunk], nf)

    def transfer(k: int, partial: torch.Tensor):
        if n == 1:
            return col_block(partial, -1)
        first = group.permute_start([col_block(partial, -1).contiguous()],
                                    perm)

        def finish() -> torch.Tensor:
            (arrived,) = first.wait()
            block = arrived + col_block(partial, -2)
            for hop in range(2, n):
                block = group.permute(block, perm) \
                    + col_block(partial, -(hop + 1))
            return block

        return Pending(finish)

    def consume(acc: torch.Tensor, k: int, done: torch.Tensor):
        acc[k * rchunk:(k + 1) * rchunk] = done
        return acc

    init = torch.zeros((rows, ccols), dtype=torch.float32,
                       device=m_cols.device)
    return chunk_pipeline(n_chunks, compute, transfer, consume, init=init)


def bulk_matmul_reducescatter(m_cols: torch.Tensor, n_rows: torch.Tensor,
                              *, group) -> torch.Tensor:
    """The paper-faithful baseline (no ART): the whole partial product,
    then one bulk synchronous reduce-scatter over its columns (the builtin
    collective, the reference's ``psum_scatter``)."""
    partial = torch.matmul(m_cols.float(), n_rows.float())
    return Conduit(axis=group, transport="xla").reduce_scatter(partial,
                                                               dim=1)


# ---------------------------------------------------------------------------
# paper case study (b): kernel-split convolution, end sync
# ---------------------------------------------------------------------------


def split_conv_allgather(images: torch.Tensor, kernels_local: torch.Tensor,
                         *, group) -> torch.Tensor:
    """Fig. 6(b): each rank convolves its share of output channels (VALID,
    stride 1), then the results are gathered so every rank holds the
    complete output.  The reference's layouts at the boundary:

    images:        (B, H, W, Cin)          replicated
    kernels_local: (kh, kw, Cin, Cout/n)   this rank's kernel group
    returns:       (B, H', W', Cout)       complete on every rank
    """
    out = F.conv2d(images.permute(0, 3, 1, 2),
                   kernels_local.permute(3, 2, 0, 1))
    out = out.permute(0, 2, 3, 1).contiguous()
    return Conduit(axis=group, transport="xla").all_gather(out, dim=3)


__all__ = ["art_matmul_reducescatter", "art_send",
           "bulk_matmul_reducescatter", "split_conv_allgather"]
