"""Partitioned Global Address Space over a rank group — the FSHMEM core
(``repro.core.pgas``).

The paper gives every FPGA a globally addressed memory partition and
implements one-sided ``gasnet_put``/``gasnet_get`` in hardware, so a node
writes or reads a remote partition without interrupting the remote
process.  Here the ranks are processes of a
:class:`~repro_torch.dist.group.Group`, and a rank's partition is a 1-D
tensor of ``heap.size`` elements.  Two wires carry PUT and GET:

* **peer memory** — on a card group whose ranks map each other's memory
  (``Group.peer``, CUDA IPC, ``RankPool(n)`` on the card): every rank's
  partition is device memory that every other rank maps
  (:meth:`GlobalAddressSpace.zeros_local`), so a PUT is a copy by the
  source into the destination's partition and a GET a copy out of the
  source's: the port's counterpart of "the sender's DMA engine deposits
  data directly into the receiver's memory";
* **the group's wire** — :meth:`Group.permute` (gloo; on the card staged
  through host memory), the reference's ``lax.ppermute``, for CPU heaps
  and for card groups built without peer memory
  (``RankPool(n, peer_memory=False)``).

The tensor's device and the group decide, never a fallback: a CPU heap
rides the wire; a CUDA heap on a group with peer memory must be the
partition that group mapped, and anything else raises.

A mapped partition lives as long as its heap: when a rank's heap tensor
goes, that rank drops its views of the peers' partitions, and the next
:func:`map_partition` on the group (or the pool's close) unmaps and frees
every partition whose heap has gone on every rank.

Semantics are the reference's ``ppermute`` snapshot: every source sends
its payload as it was before the call.  On peer memory that takes two
barriers around the stores: payloads are copied first, then every rank
passes a barrier, then the stores run, then each rank synchronises its
device and passes a second barrier, so a ring PUT of a slice of the
sender's own heap reads the old slice, and every store has landed before
any rank goes on.  The port's heap is updated in place (the reference is
functional): :func:`put` writes the destination's partition and returns
the caller's own, which is the same tensor.

A global address is ``(rank, offset)``; routing is a static ``perm`` list
of ``(src_rank, dst_rank)`` pairs, offsets and payloads are message data.
Offsets are clamped as ``lax.dynamic_slice`` clamps them, so an update
that would run past the end lands flush with it.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

Perm = Sequence[Tuple[int, int]]


# ---------------------------------------------------------------------------
# symmetric heap layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Symbol:
    """One named allocation in the symmetric heap (offset identical on
    every rank — the SHMEM property remote addressing relies on)."""

    name: str
    offset: int
    size: int


class SymmetricHeap:
    """Named bump allocator over each rank's partition (SHMEM symmetric
    heap): every rank has the same layout, so ``addr("x")`` is a valid
    remote offset on any peer."""

    def __init__(self, size: int, dtype: torch.dtype = torch.float32):
        self.size = int(size)
        self.dtype = dtype
        self._symbols: Dict[str, Symbol] = {}
        self._top = 0

    def alloc(self, name: str, size: int) -> Symbol:
        """Bump-allocate ``size`` words for ``name`` (same offset on every
        rank); raises on double allocation or heap overflow."""
        if name in self._symbols:
            raise ValueError(f"symbol {name!r} already allocated")
        if self._top + size > self.size:
            raise MemoryError(
                f"symmetric heap overflow: {self._top}+{size} > {self.size}")
        sym = Symbol(name, self._top, int(size))
        self._symbols[name] = sym
        self._top += int(size)
        return sym

    def addr(self, name: str) -> int:
        """The symbol's offset — valid as a remote address on any peer."""
        return self._symbols[name].offset

    def symbol(self, name: str) -> Symbol:
        """The full :class:`Symbol` record for ``name``."""
        return self._symbols[name]

    def zeros_local(self, device: DeviceLike = None) -> torch.Tensor:
        """A zeroed local partition with the heap's size and dtype, on
        ``device`` (``None``: the card)."""
        return torch.zeros((self.size,), dtype=self.dtype,
                           device=resolve_device(device))


@dataclasses.dataclass
class BlockSegment:
    """Block-granular view of a symmetric-heap symbol: blocks numbered
    ``0 .. n_blocks-1`` owner-major across ranks; :meth:`addr` resolves a
    global block id to ``(owner rank, local word offset)``."""

    symbol: Symbol
    block_words: int
    blocks_per_rank: int
    n_ranks: int

    @property
    def n_blocks(self) -> int:
        """Total blocks across all ranks."""
        return self.blocks_per_rank * self.n_ranks

    def owner(self, bid):
        """Rank owning global block ``bid`` (int or tensor)."""
        return bid // self.blocks_per_rank

    def local_index(self, bid):
        """Owner-local block index of global block ``bid``."""
        return bid % self.blocks_per_rank

    def local_offset(self, bid):
        """Word offset of ``bid`` inside the owner's partition."""
        return self.symbol.offset + self.local_index(bid) * self.block_words

    def addr(self, bid):
        """Translate a global block id to ``(owner_rank, local_offset)``."""
        return self.owner(bid), self.local_offset(bid)


@dataclasses.dataclass
class HeartbeatSegment:
    """Membership wire state in the symmetric heap: ``[0, n)`` lease
    counters, ``[n, 2n)`` join flags, one slot per rank."""

    symbol: Symbol
    n_ranks: int

    @property
    def words(self) -> int:
        """Total heap words the segment occupies (leases + join flags)."""
        return 2 * self.n_ranks

    def lease_offset(self, rank) -> int:
        """Heap word offset of rank ``rank``'s lease slot."""
        return self.symbol.offset + rank

    def join_offset(self, rank) -> int:
        """Heap word offset of rank ``rank``'s join flag."""
        return self.symbol.offset + self.n_ranks + rank


# ---------------------------------------------------------------------------
# the peer-mapped partition
# ---------------------------------------------------------------------------


class _DeviceBytes:
    """``nbytes`` of device memory at ``ptr``, for ``torch.as_tensor``
    (which keeps this object alive with the tensor)."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


class _Partitions:
    """This rank's peer-mapped heaps on one group's peer memory.

    ``live`` holds, keyed by this rank's pointer, every peer's partition
    as a tensor (this rank's own is ``None``: only the heap itself holds
    it, so the heap can go).  When the heap goes, its partition moves to
    ``gone`` under its number, which is the same on every rank because
    mapping is collective."""

    def __init__(self):
        self.mapped = 0
        self.live: Dict[int, List[Optional[torch.Tensor]]] = {}
        self.gone: Dict[int, List[int]] = {}

    def heap_gone(self, number: int, ptrs: List[int], mine: int) -> None:
        self.live.pop(mine, None)
        self.gone[number] = ptrs

    def release_gone(self, peer) -> None:
        """Unmap and free the partitions whose heap has gone on every rank
        (collective)."""
        everyone: List[Optional[List[int]]] = [None] * peer.size
        dist.all_gather_object(everyone, sorted(self.gone), group=peer.pg)
        done = sorted(set.intersection(*(set(g) for g in everyone)))
        peer.release_partitions([self.gone.pop(i) for i in done])


#: the mapped heaps, by the group's peer memory
_PARTITIONS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def map_partition(group, heap: SymmetricHeap) -> torch.Tensor:
    """This rank's zeroed partition of ``heap`` in device memory that
    every other rank of ``group`` maps (collective).  Returns the local
    partition; :func:`put` and :func:`get` find the peers' through it.
    First frees the partitions of heaps gone on every rank."""
    if group.peer is None:
        raise ValueError("map_partition needs a card group with peer "
                         "memory (RankPool(n) on the card)")
    parts = _PARTITIONS.setdefault(group.peer, _Partitions())
    parts.release_gone(group.peer)
    nbytes = heap.size * torch.empty((), dtype=heap.dtype).element_size()
    ptrs = group.peer.map_partition(nbytes)
    mine = _DeviceBytes(ptrs[group.rank], nbytes)
    parts.live[ptrs[group.rank]] = [
        None if r == group.rank else
        torch.as_tensor(_DeviceBytes(p, nbytes), device=group.device)
        .view(heap.dtype) for r, p in enumerate(ptrs)]
    # the tensor keeps ``mine`` alive exactly as long as its storage
    weakref.finalize(mine, parts.heap_gone, parts.mapped, ptrs,
                     ptrs[group.rank])
    parts.mapped += 1
    return torch.as_tensor(mine, device=group.device).view(heap.dtype)


def _peer_views(group, heap: torch.Tensor) -> Optional[List[torch.Tensor]]:
    """Every rank's partition, ``heap`` at this rank's index, when
    ``heap`` is a CUDA heap on a group with peer memory (it must be one
    that :func:`map_partition` gave); ``None`` for a heap that rides the
    wire."""
    if heap.device.type != "cuda" or group.peer is None:
        return None
    parts = _PARTITIONS.get(group.peer)
    views = None if parts is None else parts.live.get(heap.data_ptr())
    # views[rank - 1] is a peer's partition, which has the heap's size
    if views is None or views[group.rank - 1].numel() != heap.numel():
        raise ValueError(
            "on a card group with peer memory the heap must be the "
            "partition GlobalAddressSpace.zeros_local mapped; a group "
            "built with peer_memory=False runs PUT/GET over the wire")
    return [heap if v is None else v for v in views]


def _settle(group, device: torch.device) -> None:
    """This rank's device work is done, and every rank's is."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    group.barrier()


# ---------------------------------------------------------------------------
# one-sided primitives (rank-local code; every rank of the group calls them)
# ---------------------------------------------------------------------------


def _recv_mask(group, perm: Perm) -> bool:
    """True on ranks that are a destination in ``perm`` (a static table,
    no wire traffic)."""
    return any(d == group.rank for _, d in perm)


def _start(offset: int, length: int, size: int) -> int:
    """``offset`` clamped as ``lax.dynamic_slice`` clamps a start index."""
    return min(max(int(offset), 0), max(size - length, 0))


def _header(offset) -> torch.Tensor:
    """An AM header word: the offset as int32 on the host."""
    return torch.tensor([int(offset)], dtype=torch.int32)


def put(heap: torch.Tensor, payload: torch.Tensor, offset, *, group,
        perm: Perm) -> torch.Tensor:
    """One-sided remote write: each ``src`` in ``perm`` deposits
    ``payload`` at ``offset`` words into ``dst``'s partition.  Returns the
    local partition, updated in place on destinations.  The paper's
    ``gasnet_put``: one long message whose header is the offset and whose
    body is the payload."""
    perm = list(perm)
    group._check_perm(perm)
    payload = payload.reshape(-1).to(device=heap.device, dtype=heap.dtype)
    views = _peer_views(group, heap)
    if views is not None:
        dst = next((d for s, d in perm if s == group.rank), None)
        snap = payload.clone() if dst is not None else None
        _settle(group, heap.device)         # every payload as it was
        if dst is not None:
            s = _start(offset, snap.numel(), heap.numel())
            views[dst][s:s + snap.numel()].copy_(snap)
            group.stats["peer_bytes"] += snap.numel() * snap.element_size()
        _settle(group, heap.device)         # every store has landed
        return heap
    body, hdr = group.permute_start([payload, _header(offset)], perm).wait()
    if _recv_mask(group, perm):
        s = _start(hdr[0], body.numel(), heap.numel())
        heap[s:s + body.numel()] = body
    return heap


def get(heap: torch.Tensor, offset, size: int, *, group,
        perm: Perm) -> torch.Tensor:
    """One-sided remote read: each ``(requester, source)`` pair in
    ``perm`` reads ``size`` words at ``source``'s ``offset``.  Returns the
    fetched chunk on requesters, zeros elsewhere.  Over the wire it is the
    reference's two messages (a short request carrying the offset, a long
    reply carrying the payload); over peer memory the requester copies
    out of the source's partition."""
    perm = list(perm)
    group._check_perm(perm)
    views = _peer_views(group, heap)
    if views is not None:
        src = next((s for r, s in perm if r == group.rank), None)
        _settle(group, heap.device)         # every earlier write landed
        if src is None:
            out = heap.new_zeros(size)
        else:
            s = _start(offset, size, heap.numel())
            out = views[src][s:s + size].clone()
            group.stats["peer_bytes"] += out.numel() * out.element_size()
        _settle(group, heap.device)         # no write overtakes a read
        return out
    rep_perm = [(s, r) for r, s in perm]    # source -> requester
    hdr_at_src = group.permute(_header(offset), perm)
    s = _start(hdr_at_src[0], size, heap.numel())
    return group.permute(heap[s:s + size], rep_perm)


def put_ring(heap: torch.Tensor, payload: torch.Tensor, offset, *, group,
             shift: int = 1) -> torch.Tensor:
    """``put`` along a ring: every rank sends to ``(rank + shift) % n``."""
    n = group.size
    perm = [(i, (i + shift) % n) for i in range(n)]
    return put(heap, payload, offset, group=group, perm=perm)


# ---------------------------------------------------------------------------
# user-facing handle
# ---------------------------------------------------------------------------


class GlobalAddressSpace:
    """Bundles a rank group with a symmetric-heap layout (the programming
    model of the paper's Fig. 2).  Rank-local code with one-sided
    communication is ``fn(local_heap, *args)``; :meth:`run` returns it as
    the callable each rank applies to its partition (the reference wraps
    it in ``shard_map`` over the PGAS axis; here every rank process runs
    it itself)."""

    def __init__(self, group, heap: SymmetricHeap):
        self.group = group
        self.heap = heap

    @property
    def n_ranks(self) -> int:
        """Number of partitions (the group size)."""
        return self.group.size

    def zeros_local(self) -> torch.Tensor:
        """This rank's zeroed partition on the group's device: on a card
        group with peer memory, device memory every peer maps
        (collective); otherwise a plain tensor."""
        if self.group.peer is not None and self.group.device.type == "cuda":
            return map_partition(self.group, self.heap)
        return self.heap.zeros_local(self.group.device)

    def run(self, fn: Callable) -> Callable:
        """``fn(heap_local, *extras) -> (heap_local, *outs)``, as the
        callable every rank applies to its own partition."""
        def _run(heap, *args):
            return fn(heap, *args)

        return _run

    # convenience: symbol-level remote write/read closures -------------------

    def write_symbol(self, name: str, *, perm: Perm) -> Callable:
        """``f(heap, payload)`` PUTting into symbol ``name`` on the peers
        named by ``perm``."""
        sym = self.heap.symbol(name)

        def _w(heap, payload):
            return put(heap, payload, sym.offset, group=self.group,
                       perm=perm)

        return self.run(_w)

    def block_segment(self, name: str, block_words: int) -> BlockSegment:
        """Block-granular view of symbol ``name``, globally numbered
        owner-major across the group."""
        sym = self.heap.symbol(name)
        if sym.size % block_words:
            raise ValueError(
                f"symbol {name!r} size {sym.size} not a multiple of "
                f"block_words {block_words}")
        return BlockSegment(symbol=sym, block_words=int(block_words),
                            blocks_per_rank=sym.size // int(block_words),
                            n_ranks=self.n_ranks)

    def heartbeat_segment(self, name: str = "hb_leases") -> HeartbeatSegment:
        """Allocate (or reuse) the ``2·n_ranks``-word membership segment;
        idempotent."""
        try:
            sym = self.heap.symbol(name)
        except KeyError:
            sym = self.heap.alloc(name, 2 * self.n_ranks)
        if sym.size != 2 * self.n_ranks:
            raise ValueError(
                f"symbol {name!r} has {sym.size} words, heartbeat needs "
                f"{2 * self.n_ranks}")
        return HeartbeatSegment(symbol=sym, n_ranks=self.n_ranks)

    def write_block(self, name: str, block_words: int, *,
                    perm: Perm) -> Callable:
        """``f(heap, payload, bid)`` PUTting one block into the segment of
        symbol ``name`` on the peers named by ``perm``; the sender resolves
        the global block id to the destination's local offset."""
        seg = self.block_segment(name, block_words)

        def _w(heap, payload, bid):
            return put(heap, payload, seg.local_offset(int(bid)),
                       group=self.group, perm=perm)

        return self.run(_w)

    def read_symbol(self, name: str, *, perm: Perm) -> Callable:
        """``f(heap) -> (heap, chunk)`` GETting symbol ``name`` from the
        peers named by ``perm``."""
        sym = self.heap.symbol(name)

        def _r(heap):
            return heap, get(heap, sym.offset, sym.size, group=self.group,
                             perm=perm)

        return self.run(_r)


__all__ = [
    "BlockSegment", "GlobalAddressSpace", "HeartbeatSegment", "Perm",
    "Symbol", "SymmetricHeap", "get", "map_partition", "put", "put_ring",
]
