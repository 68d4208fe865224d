"""The generalized ART scheduler (``repro.core.pipeline``): any collective,
any per-chunk compute.

The paper's ART (Sec. III-B) streams a producer's results chunk by chunk
so the wire time hides under the remaining compute.  The structural
property every loop here keeps is the reference's: **the transfer of
chunk k−1 is issued before the compute of chunk k, and neither depends
on the other.**  On a TPU, XLA's latency-hiding scheduler then overlaps
them; PyTorch runs eagerly, so here the overlap is explicit: a
``transfer`` may return a :class:`~repro_torch.dist.group.Pending` (a
``Group.permute_start`` in flight), and the loop waits on it only when
the arrival is consumed, after the next chunk's compute.  A transfer that
returns a plain value works too, without overlap.

* :func:`chunk_pipeline` — the producer pipeline (ART proper).  The
  reference's ``loop`` switch (``fori_loop`` or unrolled) is not kept:
  eagerly both are the same loop.
* :func:`chunk_pipeline_carried` — the same with a carry chained through
  the computes.
* :func:`streamed` — the consumer pipeline: chunk k issued, chunk k−1
  consumed while it flies.
* :func:`ring_pipeline` — the hop-carried ring loop every ring collective
  of ``core/conduit.py`` is an instance of.

Chunking never changes numerics: :func:`chunk_slices` partitions a
payload elementwise, and re-concatenation restores the bulk result bit
for bit.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.dist.group import Pending


def _arrived(x: Any) -> Any:
    """What a transfer delivered: a :class:`Pending` is waited on here, at
    the last moment, so the compute issued before this ran meanwhile."""
    return x.wait() if isinstance(x, Pending) else x


# ---------------------------------------------------------------------------
# chunk partitioning (elementwise, order-preserving — numerics-neutral)
# ---------------------------------------------------------------------------


def chunk_slices(total: int, n: int) -> List[Tuple[int, int]]:
    """``n`` nearly equal, order-preserving ``(lo, hi)`` cuts of ``total``.

    Boundaries are ``round(i·total/n)``; empty cuts (when ``n > total``)
    are dropped, so the returned list partitions ``range(total)`` exactly.
    """
    cuts = [round(i * total / n) for i in range(n + 1)]
    return [(lo, hi) for lo, hi in zip(cuts, cuts[1:]) if hi > lo]


def n_chunks(total_bytes: int, chunk_bytes: Optional[int], limit: int) -> int:
    """⌈total_bytes / chunk_bytes⌉ clamped to ``[1, limit]`` (the splittable
    extent); ``None``/oversized ``chunk_bytes`` means one chunk (bulk)."""
    if not chunk_bytes or total_bytes <= chunk_bytes:
        return 1
    return max(1, min(limit, -(-total_bytes // chunk_bytes)))


def split(x: torch.Tensor, n: int, axis: int = 0) -> List[torch.Tensor]:
    """Static split of ``x`` along ``axis`` into ≤ ``n`` nearly equal pieces
    (views; uneven extents allowed)."""
    return [x.narrow(axis, lo, hi - lo)
            for lo, hi in chunk_slices(x.shape[axis], n)]


# ---------------------------------------------------------------------------
# the producer pipeline (ART proper)
# ---------------------------------------------------------------------------


def chunk_pipeline(
    n: int,
    compute: Callable[[int], Any],
    transfer: Callable[[int, Any], Any],
    consume: Callable[[Any, int, Any], Any],
    *,
    init: Any = None,
) -> Any:
    """Run ``n`` chunks of ``compute`` with each finished chunk's
    ``transfer`` overlapping the next chunk's compute.

    Per chunk k: ``payload_k = compute(k)`` is shipped with
    ``transfer(k, payload_k)`` and folded by
    ``state = consume(state, k, arrived_k)``.  The transfer of chunk k−1
    is issued before the compute of chunk k; a :class:`Pending` it returns
    is waited on only when consumed.  ``init`` seeds the state; a callable
    ``init`` receives chunk 0's payload.
    """
    first = compute(0)
    state = init(first) if callable(init) else init
    if n <= 1:
        return consume(state, 0, _arrived(transfer(0, first)))
    prev = first
    for k in range(1, n):
        arrived = transfer(k - 1, prev)     # chunk k−1 in flight ...
        nxt = compute(k)                    # ... while chunk k computes
        state = consume(state, k - 1, _arrived(arrived))
        prev = nxt
    return consume(state, n - 1, _arrived(transfer(n - 1, prev)))


def chunk_pipeline_carried(
    n: int,
    compute: Callable[[int, Any], Tuple[Any, Any]],
    transfer: Callable[[int, Any], Any],
    consume: Callable[[Any, int, Any], Any],
    *,
    carry: Any,
    init: Any = None,
) -> Tuple[Any, Any]:
    """:func:`chunk_pipeline` with a sequential carry through the computes:
    ``compute(k, carry) -> (payload_k, carry')``; the transfer/consume of
    chunk k−1 depends only on its payload, never on the carry.  Returns
    ``(state, carry)`` after all ``n`` chunks."""
    first, carry = compute(0, carry)
    state = init(first) if callable(init) else init
    if n <= 1:
        return consume(state, 0, _arrived(transfer(0, first))), carry
    prev = first
    for k in range(1, n):
        arrived = transfer(k - 1, prev)     # chunk k−1's payload in flight
        nxt, carry = compute(k, carry)      # ... while chunk k computes
        state = consume(state, k - 1, _arrived(arrived))
        prev = nxt
    return consume(state, n - 1, _arrived(transfer(n - 1, prev))), carry


# ---------------------------------------------------------------------------
# the consumer pipeline (streamed collectives)
# ---------------------------------------------------------------------------


def streamed(
    n: int,
    issue: Callable[[int], Any],
    consume: Optional[Callable[[int, Any], Any]] = None,
) -> List[Any]:
    """Issue ``n`` chunked collectives with each arrival's ``consume``
    overlapping the next chunk's flight: ``issue(k)`` starts chunk k,
    ``consume(k, arrived)`` (identity when ``None``) digests chunk k while
    chunk k+1 is in flight.  Returns the ``n`` consumed results in order."""
    if n <= 0:
        return []
    if consume is None:
        def consume(_k, arrived):
            return arrived
    prev = issue(0)
    outs: List[Any] = []
    for k in range(1, n):
        cur = issue(k)                               # chunk k in flight ...
        outs.append(consume(k - 1, _arrived(prev)))  # ... k−1 consumed
        prev = cur
    outs.append(consume(n - 1, _arrived(prev)))
    return outs


# ---------------------------------------------------------------------------
# the hop-carried ring loop
# ---------------------------------------------------------------------------


def ring_pipeline(wire: Sequence[Sequence[torch.Tensor]], perms: Sequence,
                  group, hops: int, body) -> Any:
    """The one ring loop every ring collective is an instance of.

    ``wire``: one tuple of tensors per direction riding the ring;
    ``perms``: the matching static permutations; ``body(hop, arrived) ->
    (wire', state)`` consumes what the hop delivered.  Every tensor of
    every direction of a hop is in flight at once.  Returns the last
    ``state``."""
    state = None
    for hop in range(1, hops + 1):
        pending = [group.permute_start(list(w), p)
                   for w, p in zip(wire, perms)]
        arrived = tuple(tuple(p.wait()) for p in pending)
        wire, state = body(hop, arrived)
    return state


__all__ = [
    "chunk_slices", "n_chunks", "split",
    "chunk_pipeline", "chunk_pipeline_carried", "streamed", "ring_pipeline",
]
