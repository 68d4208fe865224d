"""GASNet "extended API" collectives — thin wrappers over the conduit layer
(``repro.core.collectives``).

Every function binds the paper-faithful ``ring`` transport (n−1 one-sided
PUT hops, each an ART-sized message); callers who want the builtin
collectives construct ``Conduit(group, "xla")`` directly.  Every rank of
``group`` calls them, in the same order.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.conduit import Conduit


def _ring(group, chunk_bytes: Optional[int] = None) -> Conduit:
    return Conduit(axis=group, transport="ring", chunk_bytes=chunk_bytes)


def barrier(group) -> torch.Tensor:
    """GASNet barrier: a ones-token relayed around the PUT ring (n−1
    hops); returns the participant count."""
    return _ring(group).barrier()


def broadcast(x: torch.Tensor, root: int, *, group) -> torch.Tensor:
    """One-sided broadcast: root's value propagates around the ring, one
    PUT a hop.  Non-root inputs are ignored, as in shmem_broadcast."""
    return _ring(group).broadcast(x, root)


def ring_all_gather(x: torch.Tensor, *, group,
                    chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """All-gather via n−1 ring PUTs: ``x`` (B, ...) → (n·B, ...)."""
    return _ring(group, chunk_bytes).all_gather(x)


def ring_reduce_scatter(x: torch.Tensor, *, group,
                        chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """Reduce-scatter via the ring invariant of ``art_matmul_reducescatter``:
    ``x`` (n·B, ...) → this rank's fully reduced (B, ...) block."""
    return _ring(group, chunk_bytes).reduce_scatter(x)


def ring_all_reduce(x: torch.Tensor, *, group,
                    chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """Ring reduce-scatter + ring all-gather (2·(n−1)/n·|x| wire bytes a
    rank)."""
    return _ring(group, chunk_bytes).all_reduce(x)


def all_to_all_chunked(x: torch.Tensor, *, group,
                       chunk_bytes: Optional[int] = None) -> torch.Tensor:
    """All-to-all via n−1 single-block ring hops: ``x`` (n, B, ...), slot q
    destined for rank q; returns slot q holding what rank q sent here."""
    return _ring(group, chunk_bytes).all_to_all(x)


__all__ = ["all_to_all_chunked", "barrier", "broadcast", "ring_all_gather",
           "ring_all_reduce", "ring_reduce_scatter"]
