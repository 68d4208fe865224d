"""Process groups of rank processes and grids of them: the port's
counterpart of the reference's device mesh (``launch/mesh.py``).

Four things live here:

* :class:`Group` — one rank's handle on a gloo process group: its rank
  in the group, the group size, its device (``cuda:0`` on the card,
  ``cpu`` when asked), the wire every collective of the port rides, and,
  on the card, the peer memory the ring ops forward through (``peer``:
  each rank maps its ring neighbours' channels,
  ``kernels/cc_matmul/peer.py``).  On the card the wire is gloo over
  host memory, and the staging is explicit: each message is copied from
  the device into a host buffer, sent, received into a host buffer and
  copied back to the device.  ``stats`` counts the ring hops (over the
  wire or the peer memory), the bytes staged through the host, the bytes
  this rank sent point to point (``sent_bytes``: the payloads of the
  ring transports' hops, counted on the CPU too), the bytes forwarded
  through peer memory, the hop products the whole-ring ops launched
  (``ring_kernels``, as the launcher counts its launches: n a ring call)
  and the host seconds spent in the wire (``wire_s``: from the moment the
  device has produced the payload to the moment the arrival is back on
  the device).  :meth:`Group.permute` is the reference's ``lax.ppermute``
  with any static ``(src, dst)`` list; :meth:`Group.permute_start` starts
  one and returns a :class:`Pending` to wait on, so a caller can compute
  while the message is in flight (the ART overlap).
* :class:`Grid` — one rank's place in a grid of ranks ``("data",
  "model")`` or ``("data", "expert")``: its coordinates, the world group
  and one :class:`Group` for each axis line it lies on, each line with
  its own ``stats`` (and, on the card, a model line its own peer
  memory).  :func:`grid_lines` builds the lines; ``launch/mesh.py``'s
  ``make_host_mesh`` is the entry point.
* :func:`init_group` — joins the gloo group through ``file://`` in a
  temporary directory, so no network is needed.
* :class:`RankPool` — spawns N rank processes (the ``spawn`` start
  method) that hold one group for their lifetime and run, in lockstep,
  whatever module-level function the parent hands them.  The pool builds
  the CUDA kernels before it starts the ranks, so N processes never race
  to compile the same library at first use.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.cc_matmul.peer import PeerMemory

#: how long a collective may wait for its peers before gloo raises
GROUP_TIMEOUT_S = 900


def _new_stats() -> Dict[str, float]:
    return {"hops": 0, "staged_bytes": 0, "sent_bytes": 0, "peer_bytes": 0,
            "ring_kernels": 0, "wire_s": 0.0}


def _ready(tensors: Sequence[torch.Tensor]) -> float:
    """Wait until the device has produced ``tensors`` (a staging copy
    would wait for it anyway), and return the host clock: the wire's time
    starts here, without the device work before it."""
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()
    return time.perf_counter()


#: gloo tags of :meth:`Group.permute_start`, above :meth:`Group.exchange`'s
#: (which tags by position, from 0)
_PERMUTE_TAG0, _PERMUTE_TAGS = 1 << 20, 1 << 20


class Pending:
    """Messages in flight: :meth:`wait` blocks until they have arrived
    and returns what ``finish`` makes of them (once; later calls return
    the same)."""

    def __init__(self, finish: Callable[[], Any]):
        self._finish: Optional[Callable[[], Any]] = finish
        self._out: Any = None

    def wait(self) -> Any:
        if self._finish is not None:
            self._out = self._finish()
            self._finish = None
        return self._out


@dataclasses.dataclass
class Group:
    """One rank's view of a process group: the world, or one line of a
    :class:`Grid` (a ``model``, ``expert`` or ``data`` axis).

    ``pg`` is None only for a group that never communicates (size-1 or
    argument-checking uses); every collective needs it.  ``peer`` is the
    :class:`PeerMemory` of a card group whose ranks map each other's
    channels, else None.  ``ranks`` are the members' world ranks in group
    order (None: the group is the world), which point-to-point calls
    address."""

    rank: int
    size: int
    device: torch.device
    pg: Any = None
    stats: Dict[str, float] = dataclasses.field(default_factory=_new_stats)
    peer: Optional[PeerMemory] = None
    ranks: Optional[Tuple[int, ...]] = None
    _permutes: int = dataclasses.field(default=0, repr=False)

    def _world(self, r: int) -> int:
        """The world rank of this group's rank ``r``."""
        return r if self.ranks is None else self.ranks[r]

    def _send(self, h: torch.Tensor, r: int, tag: int):
        self.stats["sent_bytes"] += h.numel() * h.element_size()
        return dist.isend(self._wire_view(h), dst=self._world(r),
                          group=self.pg, tag=tag)

    def _recv(self, buf: torch.Tensor, r: int, tag: int):
        return dist.irecv(self._wire_view(buf), src=self._world(r),
                          group=self.pg, tag=tag)

    # -- host staging ---------------------------------------------------------

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if t.device.type == "cpu":
            return t.detach().contiguous()
        self.stats["staged_bytes"] += t.numel() * t.element_size()
        return t.detach().to("cpu")

    def _from_host(self, h: torch.Tensor,
                   device: torch.device) -> torch.Tensor:
        if device.type == "cpu":
            return h
        self.stats["staged_bytes"] += h.numel() * h.element_size()
        return h.to(device)

    @staticmethod
    def _wire_view(h: torch.Tensor) -> torch.Tensor:
        # the wire moves bytes: 16-bit floats travel as uint8 (gloo's
        # gather has no 16-bit integer type, and not every build has bf16;
        # nor has it bool)
        if h.dtype in (torch.bfloat16, torch.float16, torch.bool):
            return h.view(torch.uint8)
        return h

    # -- point to point: the ring hop -----------------------------------------

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]],
                 into: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
        """One ring hop per entry, all in flight together: for each
        ``(t, shift)`` send ``t`` to rank ``(rank + shift) % size`` and
        receive a tensor of the same shape and dtype from rank
        ``(rank - shift) % size`` (the reference's ``lax.ppermute`` with
        ``_ring_perm(n, shift)``).  Returns the arrivals on the
        device of the tensors sent, in the order of ``sends``; with
        ``into``, each arrival is copied from its host buffer straight
        into the given tensor (a scratch slot) and those are returned."""
        t0 = _ready([t for t, _ in sends])
        reqs, bufs, devices = [], [], []
        for tag, (t, shift) in enumerate(sends):
            devices.append(t.device)
            h = self._to_host(t)
            buf = torch.empty(h.shape, dtype=h.dtype)
            reqs.append(self._send(h, (self.rank + shift) % self.size, tag))
            reqs.append(self._recv(buf, (self.rank - shift) % self.size,
                                   tag))
            bufs.append(buf)
            self.stats["hops"] += 1
        for r in reqs:
            r.wait()
        if into is None:
            out = [self._from_host(b, d) for b, d in zip(bufs, devices)]
        else:
            for dst, b in zip(into, bufs):
                if dst.device.type != "cpu":
                    self.stats["staged_bytes"] += b.numel() * b.element_size()
                dst.copy_(b)
            out = list(into)
        self.stats["wire_s"] += time.perf_counter() - t0
        return out

    # -- point to point: any static permutation --------------------------------

    def _check_perm(self, perm: Sequence[Tuple[int, int]]) -> None:
        srcs = [s for s, _ in perm]
        dsts = [d for _, d in perm]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            raise ValueError(f"permute: {list(perm)} repeats a source or a "
                             f"destination")
        if any(not 0 <= r < self.size for r in srcs + dsts):
            raise ValueError(f"permute: {list(perm)} names a rank outside "
                             f"0..{self.size - 1}")

    def permute_start(self, tensors: Sequence[torch.Tensor],
                      perm: Sequence[Tuple[int, int]]) -> Pending:
        """Start the reference's ``lax.ppermute`` of each of ``tensors``
        over the static ``(src, dst)`` list ``perm``: the rank that is a
        source sends its tensor to its destination, the rank that is a
        destination receives a tensor of the same shape and dtype from its
        source, and a rank that is no destination gets zeros.  A source or
        a destination named twice raises, as in JAX.  Every rank of the
        group calls it, in the same order (SPMD), whether it takes part
        or not.  The payloads are copied when the call is made, so the
        caller may change them at once.  Returns a :class:`Pending` whose
        ``wait()`` gives the arrivals on the tensors' devices, in order."""
        perm = [(int(s), int(d)) for s, d in perm]
        self._check_perm(perm)
        dst = next((d for s, d in perm if s == self.rank), None)
        src = next((s for s, d in perm if d == self.rank), None)
        t0 = _ready(tensors)
        tag0 = _PERMUTE_TAG0 + (self._permutes % _PERMUTE_TAGS)
        self._permutes += len(tensors)
        reqs, sent, bufs = [], [], []
        for i, t in enumerate(tensors):
            if dst is not None and dst != self.rank:
                h = self._to_host(t)
                if h.data_ptr() == t.data_ptr():
                    h = h.clone()      # the caller may write t before wait
                sent.append(h)
                reqs.append(self._send(h, dst, tag0 + i))
                self.stats["hops"] += 1
            if src is None:
                bufs.append(None)
            elif src == self.rank:
                bufs.append(t.detach().clone())
            else:
                buf = torch.empty(tuple(t.shape), dtype=t.dtype)
                reqs.append(self._recv(buf, src, tag0 + i))
                bufs.append(buf)

        def finish() -> List[torch.Tensor]:
            for r in reqs:
                r.wait()
            out = []
            for t, b in zip(tensors, bufs):
                if b is None:
                    out.append(torch.zeros_like(t))
                elif b.device == t.device:
                    out.append(b)
                else:
                    out.append(self._from_host(b, t.device))
            del sent[:]
            self.stats["wire_s"] += time.perf_counter() - t0
            return out

        return Pending(finish)

    def permute(self, t: torch.Tensor,
                perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """:meth:`permute_start` of one tensor, waited on."""
        return self.permute_start([t], perm).wait()[0]

    # -- plain collectives ------------------------------------------------------

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (the
        reference's ``lax.all_gather(..., tiled=True)``)."""
        t0 = _ready([t])
        h = self._to_host(t)
        parts = [torch.empty_like(h) for _ in range(self.size)]
        dist.all_gather([self._wire_view(p) for p in parts],
                        self._wire_view(h), group=self.pg)
        out = self._from_host(torch.cat(parts, dim=dim), t.device)
        self.stats["wire_s"] += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the group, as a new tensor on
        this rank's device.  gloo's ring computes each element's sum once
        and copies it, so every rank gets the same bits."""
        t0 = _ready([t])
        h = self._to_host(t).clone()
        dist.all_reduce(h, group=self.pg)
        out = self._from_host(h, t.device)
        self.stats["wire_s"] += time.perf_counter() - t0
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Block q of ``t`` along ``dim`` summed over the group onto rank q
        (the reference's ``lax.psum_scatter(..., tiled=True)``).  Only the
        n−1 blocks other ranks own leave the rank, each straight to its
        owner and all in flight at once, as ART's chunks travel; the owner
        adds the arrivals to its own block in rank order."""
        n, me = self.size, self.rank
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of "
                             f"{tuple(t.shape)} does not split over {n} "
                             f"ranks")
        t0 = _ready([t])
        blocks = t.detach().chunk(n, dim)
        tag = _PERMUTE_TAG0 + (self._permutes % _PERMUTE_TAGS)
        self._permutes += 1
        reqs, sent, bufs = [], [], {}
        for q in range(n):
            if q == me:
                continue
            h = self._to_host(blocks[q].contiguous())
            sent.append(h)
            reqs.append(self._send(h, q, tag))
            bufs[q] = torch.empty(tuple(blocks[me].shape), dtype=t.dtype)
            reqs.append(self._recv(bufs[q], q, tag))
        for r in reqs:
            r.wait()
        out = torch.zeros(tuple(blocks[me].shape), dtype=t.dtype,
                          device=t.device)
        for q in range(n):
            out += blocks[me] if q == me else self._from_host(bufs[q],
                                                              t.device)
        self.stats["wire_s"] += time.perf_counter() - t0
        return out

    def broadcast(self, t: torch.Tensor, root: int) -> torch.Tensor:
        """Rank ``root``'s ``t`` on every rank, as a new tensor."""
        t0 = _ready([t])
        h = self._to_host(t).clone()
        dist.broadcast(self._wire_view(h), src=self._world(root),
                       group=self.pg)
        out = self._from_host(h, t.device)
        self.stats["wire_s"] += time.perf_counter() - t0
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Tiled all-to-all over dim 0 (a multiple of the group size):
        block q of ``t`` goes to rank q, and block q of the result is what
        rank q sent here (the reference's ``lax.all_to_all(..., tiled=True)``
        with split and concat axis 0)."""
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does "
                             f"not split over {self.size} ranks")
        t0 = _ready([t])
        h = self._to_host(t).contiguous()
        out = torch.empty_like(h)
        dist.all_to_all_single(self._wire_view(out), self._wire_view(h),
                               group=self.pg)
        out = self._from_host(out, t.device)
        self.stats["wire_s"] += time.perf_counter() - t0
        return out

    def gather(self, t: torch.Tensor, dim: int,
               root: int = 0) -> Optional[torch.Tensor]:
        """Every rank's ``t`` concatenated along ``dim`` in rank order, in
        host memory on rank ``root`` (None on the others): what a
        checkpoint writer needs, without a copy on every rank."""
        t0 = _ready([t])
        h = self._to_host(t).contiguous()
        parts = ([torch.empty_like(h) for _ in range(self.size)]
                 if self.rank == root else None)
        dist.gather(self._wire_view(h),
                    None if parts is None else
                    [self._wire_view(p) for p in parts],
                    dst=self._world(root), group=self.pg)
        self.stats["wire_s"] += time.perf_counter() - t0
        return None if parts is None else torch.cat(parts, dim=dim)

    def barrier(self) -> None:
        """Every rank of the group reaches this point before any leaves."""
        dist.barrier(group=self.pg)


#: the axes a grid may stand for, and the inner one of each kind
GRID_INNER = ("model", "expert")


@dataclasses.dataclass
class Grid:
    """One rank's place in a grid of ranks ``("data", inner)``, inner the
    ``model`` axis (TP) or the ``expert`` axis (a MoE model's experts).

    The world rank is the row-major index of ``coords`` in ``shape``, the
    order ``jax.make_mesh`` gives the reference's host devices (device r
    at row-major position r of the mesh): data rank d's model line holds
    world ranks ``[d·M, (d+1)·M)``, model rank m's data line ranks ``m,
    M + m, …``.  ``lines`` holds one :class:`Group` an axis: the ranks
    that share every other coordinate, with stats of their own."""

    axes: Tuple[str, str]
    shape: Tuple[int, int]
    coords: Tuple[int, int]
    world: Group
    lines: Dict[str, Group]

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def inner_axis(self) -> str:
        return self.axes[1]

    @property
    def inner(self) -> Group:
        """The model or expert line."""
        return self.lines[self.axes[1]]

    @property
    def data(self) -> Group:
        return self.lines["data"]

    def line_stats(self) -> Dict[str, Dict[str, float]]:
        """A copy of each line's ``stats``, by axis."""
        return {a: dict(self.lines[a].stats) for a in self.axes}


def as_grid(group: Any, inner: str = "model") -> Grid:
    """A :class:`Grid` as it is, or a plain :class:`Group` as the ``1 ×
    n`` grid whose ``inner`` line is the group itself (how every caller
    that predates grids keeps working)."""
    if isinstance(group, Grid):
        return group
    if inner not in GRID_INNER:
        raise ValueError(f"inner axis {inner!r} not in {GRID_INNER}")
    solo = Group(rank=0, size=1, device=group.device)
    return Grid(axes=("data", inner), shape=(1, group.size),
                coords=(0, group.rank), world=group,
                lines={"data": solo, inner: group})


#: process groups of grid lines, by (world size, shape, axis index, line
#: index), and each card line's peer memory, by its process group: built
#: once a process, as every rank asks for the same grids in the same order
_LINE_PGS: Dict[Tuple[int, ...], Any] = {}
_LINE_PEERS: Dict[int, PeerMemory] = {}


def _line_ranks(shape: Tuple[int, int], axis: int) -> List[List[int]]:
    """The world ranks of every line along ``axis`` of a row-major
    ``shape``, lines in order of the other coordinate."""
    d, m = shape
    if axis == 0:
        return [[i * m + j for i in range(d)] for j in range(m)]
    return [[i * m + j for j in range(m)] for i in range(d)]


def grid_lines(world: Group, axes: Tuple[str, str],
               shape: Tuple[int, int]) -> Grid:
    """This rank's :class:`Grid` of ``shape`` over the world group.  A
    line of more than one rank and fewer than all gets a process group of
    its own (``torch.distributed.new_group``: every rank creates every
    line, in the same order, as torch requires); on the card, with the
    world's peer memory on, an inner line of two or more ranks gets a
    :class:`PeerMemory` of its own, so the fused ring runs inside each
    line while the other lines run theirs beside it."""
    if shape[0] * shape[1] != world.size:
        raise ValueError(f"grid {dict(zip(axes, shape))} needs "
                         f"{shape[0] * shape[1]} ranks; the world has "
                         f"{world.size}")
    coords = divmod(world.rank, shape[1])
    lines: Dict[str, Group] = {}
    for i, axis in enumerate(axes):
        n = shape[i]
        if n == 1:
            lines[axis] = Group(rank=0, size=1, device=world.device)
            continue
        if n == world.size:
            lines[axis] = dataclasses.replace(
                world, stats=_new_stats(), _permutes=0,
                peer=world.peer if i == 1 else None)
            continue
        mine = None
        for j, ranks in enumerate(_line_ranks(shape, i)):
            key = (world.size,) + tuple(shape) + (i, j)
            if key not in _LINE_PGS:
                _LINE_PGS[key] = dist.new_group(ranks)
            if world.rank in ranks:
                mine = (ranks, _LINE_PGS[key])
        ranks, pg = mine
        peer = None
        if i == 1 and world.peer is not None:
            peer = _LINE_PEERS.get(id(pg))
            if peer is None:
                peer = PeerMemory(ranks.index(world.rank), n, pg,
                                  world.device)
                _LINE_PEERS[id(pg)] = peer
        lines[axis] = Group(rank=ranks.index(world.rank), size=n,
                            device=world.device, pg=pg, peer=peer,
                            ranks=tuple(ranks))
    return Grid(axes=tuple(axes), shape=tuple(shape), coords=coords,
                world=world, lines=lines)


def init_group(rank: int, size: int, init_file: str,
               device: DeviceLike = None,
               peer_memory: bool = True) -> Group:
    """Join the gloo group of ``size`` ranks rendezvousing at
    ``init_file`` and return this rank's :class:`Group`.  ``device``
    ``None`` means ``cuda`` (every rank shares ``cuda:0`` on a one-card
    host); it raises without a GPU unless the caller asks for ``cpu``.
    On the card with ``peer_memory`` (and ≥ 2 ranks) the group gets its
    :class:`PeerMemory`, and the fused ops run the in-kernel ring; without
    it they run the emulated schedule over the wire."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    peer = None
    if peer_memory and dev.type == "cuda" and size > 1:
        peer = PeerMemory(rank, size, dist.group.WORLD, dev)
    return Group(rank=rank, size=size, device=dev, pg=dist.group.WORLD,
                 peer=peer)


def _rank_main(rank: int, size: int, init_file: str, device: str,
               peer_memory: bool, inbox, outbox) -> None:
    """Body of one spawned rank: join the group, then run tasks until the
    parent sends ``None``.  A task is ``(fn, args, kwargs)``; ``fn`` is
    called as ``fn(group, *args, **kwargs)`` and its (picklable) result is
    sent back, or the traceback if it raised."""
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        # several ranks share one card: let each allocator grow segments
        # instead of reserving fresh blocks per size (before CUDA starts)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    group = init_group(rank, size, init_file, device, peer_memory)
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                outbox.put((rank, True, fn(group, *args, **kwargs)))
            except BaseException:       # report, and keep serving
                outbox.put((rank, False, traceback.format_exc()))
            # the task's arguments go with it: a CUDA tensor the parent
            # shared through IPC stays pinned in the parent while a rank
            # holds it
            del task, fn, args, kwargs
    finally:
        # every task has synchronized
        for peer in [group.peer, *_LINE_PEERS.values()]:
            if peer is not None:
                peer.close()
        dist.destroy_process_group()


class RankPool:
    """``size`` spawned rank processes sharing one gloo group.

    ``run(fn, *args, **kwargs)`` calls ``fn(group, *args, **kwargs)`` on
    every rank (``fn`` must be importable at module level: the ``spawn``
    start method pickles it by name) and returns the per-rank results in
    rank order.  If any rank raises, the pool is shut down and the
    traceback re-raised here: its peers may be blocked in a collective.
    ``peer_memory`` is :func:`init_group`'s.  Use as a context manager, or
    call :meth:`close`."""

    def __init__(self, size: int, device: DeviceLike = None,
                 peer_memory: bool = True):
        dev = resolve_device(device)
        if dev.type == "cuda":
            from repro_torch.kernels import KERNEL_NAMES
            from repro_torch.kernels.common import build

            build(KERNEL_NAMES)
        import torch.multiprocessing as mp

        self.size = size
        self._dir = tempfile.mkdtemp(prefix="repro_torch_group_")
        ctx = mp.get_context("spawn")
        self._inboxes = [ctx.Queue() for _ in range(size)]
        self._outbox = ctx.Queue()
        init_file = os.path.join(self._dir, "rendezvous")
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, size, init_file, dev.type, peer_memory,
                              self._inboxes[r], self._outbox))
            for r in range(size)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        if self._procs is None:
            raise RuntimeError("RankPool is closed")
        for box in self._inboxes:
            box.put((fn, args, kwargs))
        results: List[Optional[Any]] = [None] * self.size
        pending = set(range(self.size))
        while pending:
            try:
                rank, ok, value = self._outbox.get(timeout=GROUP_TIMEOUT_S)
            except queue_mod.Empty:
                dead = [r for r in pending
                        if not self._procs[r].is_alive()]
                self.close()
                raise RuntimeError(
                    f"ranks {sorted(pending)} gave no result within "
                    f"{GROUP_TIMEOUT_S}s (dead: {dead})") from None
            if not ok:
                self.close()
                raise RuntimeError(f"rank {rank} raised:\n{value}")
            results[rank] = value
            pending.discard(rank)
        return results

    def close(self) -> None:
        if self._procs is None:
            return
        for box in self._inboxes:
            try:
                box.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = None
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["GRID_INNER", "GROUP_TIMEOUT_S", "Grid", "Group", "Pending",
           "RankPool", "as_grid", "grid_lines", "init_group"]
