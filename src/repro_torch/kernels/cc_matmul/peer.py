"""Device memory the ranks of a TP group map from each other: the
channels the whole-ring ops (``ag_matmul_ring``/``rs_matmul_ring``,
``ring.py``'s protocol, ``csrc/cc_matmul.cu``'s launcher) forward their
slots through.

The ranks are processes that share one card.  Each rank allocates one
channel per ring direction with ``cudaMalloc``, exports it as a CUDA IPC
handle, and maps the channel of its next rank in that direction
(``(rank + direction) % n``): the port's counterpart of the TPU's remote
DMA into a neighbour's VMEM.  A channel is a 256-byte header (the
``arrive`` and ``done`` counters, 64 bits each) and two slots.  The
pointers are device pointers in mapped memory, so nothing here assumes
that the ranks share one card beyond the IPC mapping itself.

Both counters only grow, so the host keeps, per channel, how many calls
ran on it (``done`` advances by n a call: one a hop) and how far
``arrive`` has counted (one a forwarded slot, n − 1 a call).  Every rank
issues the same ring calls in the same order, so these agree across
ranks.  A call that needs bigger slots than the channel has re-allocates
the channel on every rank at once (a collective over the group's gloo
process group); the new channel starts from zero.  The first ring call
checks that the card takes 64-bit stream waits
(:meth:`PeerMemory.require_stream_waits`).

The same memory serves the PGAS heap (``core/pgas.py``):
:meth:`PeerMemory.map_partition` gives each rank a partition that every
other rank maps, so a PUT is a store into the destination's partition,
and :meth:`PeerMemory.release_partitions` unmaps and frees partitions
nobody uses any more.  Which ones those are is the heap's business.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.kernels.common import CudaKernel

HEADER_BYTES = 256
_MIN_SLOT_BYTES = 1 << 20

_P, _L, _C = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_char)
_ALLOC = CudaKernel("cc_matmul", "repro_cc_channel_alloc",
                    [_L, ctypes.POINTER(_P), _C])
_OPEN = CudaKernel("cc_matmul", "repro_cc_channel_open",
                   [_C, ctypes.POINTER(_P)])
_CLOSE = CudaKernel("cc_matmul", "repro_cc_channel_close", [_P])
_FREE = CudaKernel("cc_matmul", "repro_cc_channel_free", [_P])
_I = ctypes.POINTER(ctypes.c_int)
_STREAM_OPS = CudaKernel("cc_matmul", "repro_cc_stream_ops", [_I, _I])


def stream_ops() -> Dict[str, int]:
    """The current card's support for the ring's stream waits: the values
    of ``CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS`` and
    ``CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR``."""
    can_64, can_nor = ctypes.c_int(0), ctypes.c_int(0)
    _check(_STREAM_OPS.fn()(ctypes.byref(can_64), ctypes.byref(can_nor)),
           "stream-ops query")
    return {"CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS": can_64.value,
            "CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR":
                can_nor.value}


class Channel:
    """One ring direction's channel as this rank sees it."""

    def __init__(self, mine: int, next_: int, slot_bytes: int):
        self.mine, self.next = mine, next_
        self.slot_bytes = slot_bytes
        self.calls = 0        # ring calls so far: `done` is calls × n
        self.arrived = 0      # slots forwarded into this channel so far


class PeerMemory:
    """The channels of one rank of a group whose ranks share a card."""

    def __init__(self, rank: int, size: int, pg, device: torch.device):
        if size < 2 or device.type != "cuda":
            raise ValueError(f"peer memory needs >= 2 ranks on a card, got "
                             f"{size} on {device}")
        self.rank, self.size, self.pg, self.device = rank, size, pg, device
        self.channels: Dict[int, Channel] = {}
        #: every partition of :meth:`map_partition` not yet released, as
        #: pointers by rank, keyed by this rank's pointer
        self.partitions: Dict[int, List[int]] = {}
        self._stream_waits = False

    def require_stream_waits(self) -> None:
        """Check once that the card takes the ring's 64-bit stream waits
        (its only hand-off; there is no other path), and raise, naming
        the attribute, when it does not."""
        if self._stream_waits:
            return
        with torch.cuda.device(self.device):
            name = "CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS"
            if not stream_ops()[name]:
                raise RuntimeError(f"the whole-ring ops wait on 64-bit "
                                   f"counters in stream order, and this "
                                   f"card reports {name} = 0")
        self._stream_waits = True

    def channel(self, direction: int, slot_bytes: int) -> Channel:
        """The channel of ``direction`` with slots of at least
        ``slot_bytes``; (re-)allocated on every rank at once when missing
        or too small (all ranks ask for the same sizes in the same
        order)."""
        ch = self.channels.get(direction)
        if ch is not None and ch.slot_bytes >= slot_bytes:
            return ch
        cap = _MIN_SLOT_BYTES
        while cap < slot_bytes:
            cap *= 2
        with torch.cuda.device(self.device):
            torch.cuda.synchronize()       # this rank's kernels are done
            dist.barrier(group=self.pg)    # and every other rank's
            if ch is not None:
                _check(_CLOSE.fn()(ch.next), "close")
                dist.barrier(group=self.pg)   # nobody maps the old ones
                _check(_FREE.fn()(ch.mine), "free")
            mine = ctypes.c_void_p()
            handle = ctypes.create_string_buffer(64)
            _check(_ALLOC.fn()(HEADER_BYTES + 2 * cap, ctypes.byref(mine),
                               handle), "alloc")
            mine_handle = torch.frombuffer(bytearray(handle.raw),
                                           dtype=torch.uint8)
            handles = [torch.empty(64, dtype=torch.uint8)
                       for _ in range(self.size)]
            dist.all_gather(handles, mine_handle, group=self.pg)
            nxt = ctypes.c_void_p()
            peer = handles[(self.rank + direction) % self.size]
            peer_handle = ctypes.create_string_buffer(bytes(peer.tolist()), 64)
            _check(_OPEN.fn()(peer_handle, ctypes.byref(nxt)), "open")
        ch = Channel(mine.value, nxt.value, cap)
        self.channels[direction] = ch
        return ch

    def map_partition(self, nbytes: int) -> List[int]:
        """Allocate ``nbytes`` of zeroed device memory on this rank, export
        it, and map every other rank's allocation of the same call.
        Returns the device pointers by rank (this rank's own at its
        index).  Collective: every rank calls it in the same order with
        the same size.  Raises if an allocation or a mapping fails."""
        with torch.cuda.device(self.device):
            mine = ctypes.c_void_p()
            handle = ctypes.create_string_buffer(64)
            _check(_ALLOC.fn()(nbytes, ctypes.byref(mine), handle), "alloc")
            mine_handle = torch.frombuffer(bytearray(handle.raw),
                                           dtype=torch.uint8)
            handles = [torch.empty(64, dtype=torch.uint8)
                       for _ in range(self.size)]
            dist.all_gather(handles, mine_handle, group=self.pg)
            ptrs = []
            for r, h in enumerate(handles):
                if r == self.rank:
                    ptrs.append(mine.value)
                    continue
                ptr = ctypes.c_void_p()
                peer_handle = ctypes.create_string_buffer(bytes(h.tolist()),
                                                          64)
                _check(_OPEN.fn()(peer_handle, ctypes.byref(ptr)), "open")
                ptrs.append(ptr.value)
        self.partitions[mine.value] = ptrs
        return ptrs

    def release_partitions(self, parts: Sequence[List[int]]) -> None:
        """Unmap the peers' allocations of each of ``parts`` (pointers by
        rank, as :meth:`map_partition` returned them) and free this
        rank's.  Collective: every rank calls it with the same partitions,
        once no rank reads or writes them any more."""
        if not parts:
            return
        torch.cuda.synchronize(self.device)
        for ptrs in parts:
            for r, ptr in enumerate(ptrs):
                if r != self.rank:
                    _CLOSE.fn()(ptr)
        dist.barrier(group=self.pg)        # no rank maps them any more
        for ptrs in parts:
            _FREE.fn()(self.partitions.pop(ptrs[self.rank])[self.rank])

    def close(self) -> None:
        """Unmap the peers' channels and partitions and free this rank's.
        Call only when no rank has a ring call in flight or a store
        pending (the rank pool does, after its last task)."""
        for ch in self.channels.values():
            _CLOSE.fn()(ch.next)
            _FREE.fn()(ch.mine)
        self.channels = {}
        for ptrs in self.partitions.values():
            for r, ptr in enumerate(ptrs):
                (_FREE if r == self.rank else _CLOSE).fn()(ptr)
        self.partitions = {}


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"peer memory {what} failed with cudaError "
                           f"{rc}")


__all__ = ["Channel", "HEADER_BYTES", "PeerMemory", "stream_ops"]
