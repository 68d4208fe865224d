"""GASNet Active Messages over a rank group — the FSHMEM GASNet-core
dispatch layer (``repro.core.am``).

Every message names a handler by opcode, as the paper's hardware replaces
the handler function pointer with an opcode checked by the AM receive
handler (Sec. III-A):

* a :class:`HandlerRegistry` assigns each registered handler a dense
  opcode, in registration order (the built-ins first, in the reference's
  order, so the opcodes agree);
* delivery is one :meth:`Group.permute` of ``(opcode, args, payload)``:
  the header (opcode and the ``MAX_ARGS`` int32 arguments) travels as host
  tensors, the payload on the heap's device;
* dispatch reads the opcode once on the host and calls the handler.  An
  opcode outside the table is clamped into it, as ``lax.switch`` clamps.

Message classes (Table I): Short (header and args only), Medium (payload
handed to the handler as scratch), Long (payload deposited at a heap
address before the handler runs).  ``gasnet_put``/``gasnet_get`` are built
on them as in the paper: PUT = a long request running the PUT handler;
GET = a short request whose handler issues a long PUT reply.

Handlers are the port's: ``request(heap, args, payload) -> (heap,
reply_opcode, reply_args, reply_payload)`` and ``reply(heap, args,
payload) -> heap``, where ``args`` is an int32 CPU tensor and ``heap`` may
be updated in place or returned anew (a new one is copied back into the
partition).  A reply payload has the request payload's shape (the
reference's ``lax.switch`` forces it on every handler of a registry).
Only the ranks a message reaches run handlers; the reference also runs
opcode 0 with zero payloads on the others and masks the result away,
which leaves the same heaps.

Membership epochs are not ported: ``epoch`` must be ``None`` (ROADMAP
queue 1 item 8), and the conduit's failure probe has no counterpart until
the fault hooks are.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.core.pgas import Perm, _header, _recv_mask, _start

MAX_ARGS = 8  # i32 argument slots in an AM header

RequestHandler = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor],
    Tuple[torch.Tensor, int, torch.Tensor, torch.Tensor],
]
ReplyHandler = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                        torch.Tensor]

ROADMAP_EPOCHS = ("ROADMAP queue 1 item 8 (elastic runtime: membership "
                  "epochs and the fault hooks)")


def make_args(*vals) -> torch.Tensor:
    """Pack up to MAX_ARGS integers into an AM header argument block."""
    if len(vals) > MAX_ARGS:
        raise ValueError(f"{len(vals)} args > MAX_ARGS {MAX_ARGS}")
    a = torch.zeros((MAX_ARGS,), dtype=torch.int32)
    for i, v in enumerate(vals):
        a[i] = int(v)
    return a


def _check_epoch(epoch) -> None:
    if epoch is not None:
        raise NotImplementedError(
            f"AM delivery pinned to a membership epoch is not ported: "
            f"{ROADMAP_EPOCHS}")


def _write_back(heap: torch.Tensor, new: torch.Tensor) -> None:
    """Keep the partition's storage: a handler that returned a new heap
    is copied into it."""
    if new is not heap:
        heap.copy_(new)


@dataclasses.dataclass
class _Entry:
    name: str
    opcode: int
    fn: Callable


class HandlerRegistry:
    """Opcode table for AM request and reply handlers; registration order
    defines opcodes.  Built-ins, as in the reference: ``NOP_REPLY`` (reply
    0), ``PUT_REPLY`` (reply 1), ``PUT`` (request 0), ``GET`` (request 1).
    """

    def __init__(self) -> None:
        self._requests: List[_Entry] = []
        self._replies: List[_Entry] = []
        self.register_reply("NOP_REPLY", lambda heap, args, payload: heap)
        self.register_reply("PUT_REPLY", _put_reply_handler)
        self.register_request("PUT", _put_request_handler)
        self.register_request("GET", _get_request_handler)

    def register_request(self, name: str, fn: RequestHandler) -> int:
        """Register a request handler; returns its integer opcode."""
        opcode = len(self._requests)
        self._requests.append(_Entry(name, opcode, fn))
        return opcode

    def register_reply(self, name: str, fn: ReplyHandler) -> int:
        """Register a reply handler; returns its integer opcode."""
        opcode = len(self._replies)
        self._replies.append(_Entry(name, opcode, fn))
        return opcode

    def request_opcode(self, name: str) -> int:
        """Opcode of the request handler registered as ``name``."""
        for e in self._requests:
            if e.name == name:
                return e.opcode
        raise KeyError(name)

    def reply_opcode(self, name: str) -> int:
        """Opcode of the reply handler registered as ``name``."""
        for e in self._replies:
            if e.name == name:
                return e.opcode
        raise KeyError(name)

    @staticmethod
    def _entry(table: List[_Entry], opcode) -> _Entry:
        # lax.switch clamps an out-of-range index into the table
        return table[min(max(int(opcode), 0), len(table) - 1)]

    def dispatch_request(self, opcode, heap, args, payload):
        """Run the request handler of ``opcode`` (read once, on the host);
        returns ``(heap, reply_opcode, reply_args, reply_payload)``."""
        heap_out, rop, rargs, rbody = self._entry(self._requests, opcode).fn(
            heap, args, payload)
        if tuple(rbody.shape) != tuple(payload.shape):
            raise ValueError(f"reply payload {tuple(rbody.shape)} must have "
                             f"the request payload's shape "
                             f"{tuple(payload.shape)}")
        return heap_out, int(rop), rargs, rbody

    def dispatch_reply(self, opcode, heap, args, payload):
        """Run the reply handler of ``opcode``; returns the heap."""
        return self._entry(self._replies, opcode).fn(heap, args, payload)


# -- built-in handlers (the paper's PUT / GET flows) -------------------------


def _deposit(heap: torch.Tensor, offset, payload: torch.Tensor) -> None:
    s = _start(offset, payload.numel(), heap.numel())
    heap[s:s + payload.numel()] = payload.to(heap.dtype)


def _put_request_handler(heap, args, payload):
    _deposit(heap, args[0], payload)
    return heap, 0, make_args(), torch.zeros_like(payload)


def _get_request_handler(heap, args, payload):
    # args[0] = source offset on this rank; args[1] = dst offset at requester
    n = payload.numel()
    s = _start(args[0], n, heap.numel())
    chunk = heap[s:s + n].to(payload.dtype).reshape(payload.shape)
    return heap, 1, make_args(int(args[1])), chunk


def _put_reply_handler(heap, args, payload):
    _deposit(heap, args[0], payload)
    return heap


# ---------------------------------------------------------------------------
# wire transfer + round trip
# ---------------------------------------------------------------------------


def _deliver(msg: Sequence[torch.Tensor], group, perm: Perm, *,
             epoch=None) -> List[torch.Tensor]:
    """One wire transfer of the message's fields, all in flight together
    (the reference's ``ppermute`` of a pytree)."""
    _check_epoch(epoch)
    return group.permute_start(list(msg), perm).wait()


def am_request(registry: HandlerRegistry, heap: torch.Tensor, opcode,
               args: torch.Tensor, payload: torch.Tensor, *, group,
               perm: Perm, epoch=None) -> torch.Tensor:
    """Send an AM request from each ``src`` to ``dst`` in ``perm``, run the
    request handler at the destination, deliver its reply back and run
    the reply handler at the origin.  Returns the local heap (updated in
    place)."""
    perm = list(perm)
    rev = [(d, s) for (s, d) in perm]
    payload = payload.to(heap.device)
    op_r, args_r, body_r = _deliver((_header(opcode), args, payload), group,
                                    perm, epoch=epoch)
    reply = (_header(0), make_args(), torch.zeros_like(payload))
    if _recv_mask(group, perm):
        new_heap, rop, rargs, rbody = registry.dispatch_request(
            op_r[0], heap, args_r, body_r)
        _write_back(heap, new_heap)
        reply = (_header(rop), rargs, rbody.to(payload.device))
    rop_b, rargs_b, rbody_b = _deliver(reply, group, rev, epoch=epoch)
    if _recv_mask(group, rev):
        _write_back(heap, registry.dispatch_reply(rop_b[0], heap, rargs_b,
                                                  rbody_b))
    return heap


# -- message-class wrappers (Table I) ----------------------------------------


def am_request_short(registry, heap, opcode, args, *, group, perm,
                     epoch=None):
    """Short AM: header + args, a one-word null payload."""
    payload = torch.zeros((1,), dtype=heap.dtype, device=heap.device)
    return am_request(registry, heap, opcode, args, payload, group=group,
                      perm=perm, epoch=epoch)


def am_request_medium(registry, heap, opcode, args, payload, *, group, perm,
                      epoch=None):
    """Medium AM: the payload handed to the handler as scratch (not heap
    addressed).  Returns ``(heap, scratch)``: the delivered payload on
    receiving ranks, zeros elsewhere."""
    perm = list(perm)
    op_r, args_r, body_r = _deliver(
        (_header(opcode), args, payload.to(heap.device)), group, perm,
        epoch=epoch)
    if _recv_mask(group, perm):
        new_heap, _, _, _ = registry.dispatch_request(op_r[0], heap, args_r,
                                                      body_r)
        _write_back(heap, new_heap)
    return heap, body_r


def am_request_long(registry, heap, opcode, args, payload, dst_offset, *,
                    group, perm, epoch=None):
    """Long AM: the payload is deposited at ``dst_offset`` in the
    destination's heap before the handler runs (the spec's ordering
    guarantee); the handler sees the deposit address in ``args[0]``."""
    _check_epoch(epoch)
    perm = list(perm)
    body_r, off_r = group.permute_start(
        [payload.to(heap.device), _header(dst_offset)], perm).wait()
    recv = _recv_mask(group, perm)
    if recv:
        _deposit(heap, off_r[0], body_r)
    op_r, args_r = _deliver((_header(opcode), args), group, perm)
    if recv:
        args_r = args_r.clone()
        args_r[0] = off_r[0]
        new_heap, _, _, _ = registry.dispatch_request(
            op_r[0], heap, args_r,
            torch.zeros((1,), dtype=heap.dtype, device=heap.device))
        _write_back(heap, new_heap)
    return heap


# -- extended API on top of AM (the paper's gasnet_put / gasnet_get) ---------


def gasnet_put(registry, heap, payload, dst_offset, *, group, perm,
               epoch=None):
    """PUT = long AM request invoking the PUT handler (paper Sec. III-A)."""
    return am_request(registry, heap, registry.request_opcode("PUT"),
                      make_args(dst_offset), payload, group=group,
                      perm=perm, epoch=epoch)


def gasnet_get(registry, heap, src_offset, dst_offset, size, *, group,
               perm, epoch=None):
    """GET = short AM request whose handler issues a long PUT reply.
    ``perm`` lists ``(requester, source)`` pairs; the chunk lands at
    ``dst_offset`` in the requester's heap."""
    payload = torch.zeros((size,), dtype=heap.dtype, device=heap.device)
    return am_request(registry, heap, registry.request_opcode("GET"),
                      make_args(src_offset, dst_offset), payload,
                      group=group, perm=perm, epoch=epoch)


__all__ = [
    "MAX_ARGS", "ROADMAP_EPOCHS", "HandlerRegistry", "am_request",
    "am_request_long", "am_request_medium", "am_request_short",
    "gasnet_get", "gasnet_put", "make_args",
]
