"""The whole-ring protocol (``kernels/cc_matmul/ring.py``) on the CPU.

Every rank's :func:`ring_plan` runs in one process: each rank's stream is
a queue of its plan's operations, and a scheduler runs, one at a time,
the next operation of any rank whose wait is met, drawing the order from
a seed; in the worst case one rank runs only when no other can.  The
products are the plain hop functions (``matmul_tile_plain``,
``consume_matmul_plain``, ``consume_matmul_acc_plain``), the forwards
copies into the next rank's slot.  Held:

* no order deadlocks, and every forward finds the slot it overwrites read
  by all its readers, who have published ``done`` for it; every read finds
  the content it expects (the block, or the accumulator of the row block
  after as many hops);
* the outputs equal the emulated schedule's arithmetic bit for bit, and
  the reference's unidirectional ops (``allgather_matmul_pallas`` /
  ``matmul_reducescatter_pallas``, interpret mode under ``shard_map``; at
  8 ranks, more than the 4 host devices, its oracles under ``jax.vmap``)
  at 1e-5;
* each call leaves ``arrive`` and ``done`` where the host's bookkeeping
  (``peer.Channel``) puts the next call's bases.

Calls run back to back in both directions on the same channels and one
stream a rank, as the bidirectional composition issues them.
"""

import functools
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.kernels.cc_matmul import (
    allgather_matmul_pallas,
    matmul_reducescatter_pallas,
)
from repro.kernels.cc_matmul import ref as jax_ref
from repro_torch.kernels.cc_matmul import ring
from repro_torch.kernels.cc_matmul.ref import (
    consume_matmul_acc_plain,
    consume_matmul_plain,
    matmul_tile_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)
#: (B, b, N, K): b rows a rank gathers (AG) or keeps (RS); a ragged one
SHAPES = {"even": (2, 8, 16, 24), "ragged": (1, 7, 5, 13)}


class Deadlock(AssertionError):
    pass


class Rank:
    """One rank's channels (a direction each) and its stream."""

    def __init__(self, rank):
        self.rank = rank
        self.arrive = {1: 0, -1: 0}
        self.done = {1: 0, -1: 0}
        self.calls = {1: 0, -1: 0}        # the host's bookkeeping
        self.arrived = {1: 0, -1: 0}
        # slot contents: (tag, tensor), and reads of the content so far
        self.slots = {(d, s): None for d in (1, -1) for s in (0, 1)}
        self.reads = {(d, s): 0 for d in (1, -1) for s in (0, 1)}
        self.stream = []


class Call:
    """One ring call of one rank: its plan and its tensors."""

    def __init__(self, rank, n, op, direction, x, w, base):
        self.rank, self.n, self.op, self.dir = rank, n, op, direction
        self.x, self.w = x, w
        self.plan = ring.ring_plan(op, n, rank.rank, direction)
        self.abase, self.dbase = base
        self.res = None
        bsz, rows, _ = x.shape
        b = rows if op == "ag" else rows // n
        self.b = b
        self.out = torch.full((bsz, n * b if op == "ag" else b, w.shape[1]),
                              float("nan"))


def _enqueue(call, index):
    """Put the call's operations on its rank's stream."""
    call.rank.stream += [dict(call=call, op=o, index=(index, i))
                         for i, o in enumerate(call.plan)]


def _published(call, i):
    """The arrival number the copy at plan index ``i`` makes: the value of
    the next write to the next rank's ``arrive``."""
    return next(o.b for o in call.plan[i:]
                if o.kind == ring.WRITE and o.a == ring.NEXT_ARRIVE)


def _tag(call, hop, partials=None):
    """What a buffer holds: AG the block multiplied at ``hop`` of a call;
    RS the accumulator of the row block of ``hop`` after ``partials``."""
    if call.op == "ag":
        return ("ag", call.index, (call.rank.rank - call.dir * hop) % call.n)
    return ("rs", call.index,
            (call.rank.rank - call.dir * (hop + 1)) % call.n, partials)


def _ready(item, ranks, n):
    o, call = item["op"], item["call"]
    rk = call.rank
    if o.kind == ring.WAIT:
        if o.a == ring.ARRIVE:
            return rk.arrive[call.dir] >= call.abase + o.b
        nxt = ranks[(rk.rank + call.dir) % n]
        return nxt.done[call.dir] >= call.dbase + o.b
    return True


def _run(item, ranks, n):
    o, call = item["op"], item["call"]
    rk, d = call.rank, call.dir
    nxt = ranks[(rk.rank + d) % n]

    def read_slot(s, want):
        assert rk.slots[(d, s)] is not None, \
            f"rank {rk.rank} read its empty slot {s}"
        tag, t = rk.slots[(d, s)][:2]
        assert tag == want, f"rank {rk.rank} read {tag}, expected {want}"
        rk.reads[(d, s)] += 1
        return t

    if o.kind == ring.WRITE:
        if o.a == ring.DONE:
            assert rk.done[d] == call.dbase + o.b - 1
            rk.done[d] = call.dbase + o.b
        else:
            assert nxt.arrive[d] == call.abase + o.b - 1
            nxt.arrive[d] = call.abase + o.b
    elif o.kind == ring.GEMM and call.op == "ag":
        hop = (rk.rank - o.b) * d % n
        if o.a == ring.X:
            assert hop == 0
            y = consume_matmul_plain(call.x[None], call.w, slot=0)
        else:
            s = o.a - ring.SLOT0
            assert s == hop % 2
            t = read_slot(s, _tag(call, hop))
            y = consume_matmul_plain(torch.stack([t, t]), call.w, slot=s)
        call.out.view(call.x.shape[0], n, call.b, -1)[:, o.b] = y
    elif o.kind == ring.GEMM:
        hop = ((rk.rank - o.b) * d - 1) % n
        xb = call.x[:, o.b * call.b:(o.b + 1) * call.b]
        if o.c == ring.NONE:
            assert hop == 0
            y = matmul_tile_plain(xb, call.w)
        else:
            s = o.c - ring.SLOT0
            assert s == hop % 2
            t = read_slot(s, _tag(call, hop, hop))
            y = consume_matmul_acc_plain(torch.stack([t, t]), xb, call.w,
                                         slot=s)
        if o.d == ring.OUT:
            assert hop == n - 1
            call.out.copy_(y)
        else:
            assert call.res is None or call.res[2], \
                f"rank {rk.rank}: res overwritten before it was forwarded"
            call.res = [_tag(call, hop, hop + 1), y, False]
    elif o.kind == ring.COPY:
        arrival = _published(call, item["index"][1])
        hop = arrival - 1
        if o.a == ring.X:
            assert hop == 0
            tag, t = _tag(call, 0), call.x
        elif call.op == "ag":
            src = o.a - ring.SLOT0
            t = read_slot(src, _tag(call, hop))
            tag = _tag(call, hop)
        else:
            assert o.a == ring.RES
            tag, t, _ = call.res
            assert tag == _tag(call, hop, hop + 1)
            call.res[2] = True
        s = o.b
        assert s == arrival % 2
        prev = nxt.slots[(d, s)]
        if prev is not None:
            # every reader of the slot's content has read it, and the
            # next rank has published the done of its last read
            assert nxt.reads[(d, s)] == prev[2], (
                f"rank {rk.rank} overwrote rank {nxt.rank}'s slot {s} "
                f"after {nxt.reads[(d, s)]} of {prev[2]} reads")
            assert nxt.done[d] >= prev[3], (
                f"rank {rk.rank} overwrote rank {nxt.rank}'s slot {s} "
                f"before it published done {prev[3]}")
        # arrival a is read at the receiver's hop a: AG by its product and,
        # but at the last hop, its forward; RS by its product
        reads = 2 if call.op == "ag" and arrival < n - 1 else 1
        nxt.slots[(d, s)] = (tag, t.clone(), reads, call.dbase + arrival + 1)
        nxt.reads[(d, s)] = 0


def _simulate(n, calls, seed, last=None):
    """Run every rank's calls; ``calls[r]`` is rank r's list of ``(op,
    direction, x, w)``.  ``last``: a rank run only when no other can.
    Returns each rank's outputs."""
    ranks = [Rank(r) for r in range(n)]
    runs = []
    for r, rk in enumerate(ranks):
        mine = []
        for index, (op, d, x, w) in enumerate(calls[r]):
            base = (rk.arrived[d], rk.calls[d] * n)
            call = Call(rk, n, op, d, x, w, base)
            call.index = index
            _enqueue(call, index)
            rk.calls[d] += 1
            rk.arrived[d] += n - 1
            mine.append(call)
        runs.append(mine)
    rng = random.Random(seed)
    heads = [0] * n
    while True:
        live = [r for r in range(n) if heads[r] < len(ranks[r].stream)]
        if not live:
            break
        ready = [r for r in live
                 if _ready(ranks[r].stream[heads[r]], ranks, n)]
        if not ready:
            stuck = {r: ranks[r].stream[heads[r]]["op"] for r in live}
            raise Deadlock(f"no operation can run: {stuck}")
        if last is not None and any(r != last for r in ready):
            ready = [r for r in ready if r != last]
        r = rng.choice(ready)
        _run(ranks[r].stream[heads[r]], ranks, n)
        heads[r] += 1
    for rk in ranks:
        for d in (1, -1):
            # the counters where the host's next bases put them
            assert rk.arrive[d] == rk.arrived[d]
            assert rk.done[d] == rk.calls[d] * n
    return [[c.out for c in mine] for mine in runs]


def _inputs(op, n, shape, seed):
    bsz, b, nn, k = shape
    rng = np.random.default_rng(seed)
    rows = b if op == "ag" else n * b
    xs = rng.standard_normal((n, bsz, rows, k)).astype(np.float32)
    ws = rng.standard_normal((n, k, nn)).astype(np.float32)
    return xs, ws


def _emulated(op, n, direction, xs, ws):
    """The emulated schedule's arithmetic: AG each block's product; RS the
    accumulator of row block q through the ranks it visits, arrived +
    dot."""
    t = torch.from_numpy
    outs = []
    for q in range(n):
        w = t(ws[q])
        if op == "ag":
            outs.append(torch.cat([consume_matmul_plain(t(xs[k])[None], w,
                                                        slot=0)
                                   for k in range(n)], dim=1))
            continue
        b = xs.shape[2] // n
        acc = None
        for h in range(n):
            r = (q + direction * (h + 1)) % n
            xb = t(xs[r])[:, q * b:(q + 1) * b]
            if acc is None:
                acc = matmul_tile_plain(xb, t(ws[r]))
            else:
                acc = consume_matmul_acc_plain(torch.stack([acc, acc]), xb,
                                               t(ws[r]), slot=1)
        outs.append(acc)
    return outs


@functools.lru_cache(maxsize=None)
def _jax_reference(op, n, shape):
    """The reference's unidirectional op on every rank's inputs."""
    xs, ws = _inputs(op, n, shape, seed=n)
    if n <= len(jax.devices()):
        mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
        fn = {"ag": allgather_matmul_pallas,
              "rs": matmul_reducescatter_pallas}[op]

        def body(x, w):
            return fn(x[0], w[0], axis="x", bidirectional=False,
                      interpret=True)[None]

        run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("x"),
                                                               P("x")),
                                    out_specs=P("x"), check_vma=False))
    else:
        fn = {"ag": jax_ref.allgather_matmul_ref,
              "rs": jax_ref.matmul_reducescatter_ref}[op]
        run = jax.vmap(lambda x, w: fn(x, w, axis="x"), axis_name="x")
    return np.asarray(run(xs, ws))


def _calls(op, n, shape, directions):
    xs, ws = _inputs(op, n, shape, seed=n)
    t = torch.from_numpy
    return xs, ws, [[(op, d, t(xs[r]), t(ws[r])) for d in directions]
                    for r in range(n)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("op", ["ag", "rs"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_plan_equals_emulated_and_reference(n, op, shape):
    """Both directions, back to back on the same ranks (the bidirectional
    composition's order), in a random order of the ranks: bit for bit the
    emulated schedule's arithmetic, and the reference's op at 1e-5."""
    xs, ws, calls = _calls(op, n, SHAPES[shape], (1, -1))
    outs = _simulate(n, calls, seed=n)
    want = _jax_reference(op, n, SHAPES[shape])
    for i, d in enumerate((1, -1)):
        emu = _emulated(op, n, d, xs, ws)
        for q in range(n):
            assert torch.equal(outs[q][i], emu[q]), (q, d)
            np.testing.assert_allclose(outs[q][i].numpy(), want[q], **TOL)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("op", ["ag", "rs"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_plan_any_order_no_deadlock_no_overwrite(n, op, seed):
    """Orders drawn from a seed, and the worst case where one rank runs
    only when no other can: three calls a direction, both directions
    interleaved, finish with every slot read before it was overwritten
    and the counters at the host's bases."""
    rng = random.Random(seed)
    directions = [rng.choice((1, -1)) for _ in range(6)]
    xs, ws, calls = _calls(op, n, SHAPES["ragged"], directions)
    for last in (None, seed % n):
        outs = _simulate(n, calls, seed=seed, last=last)
        for d in (1, -1):
            emu = _emulated(op, n, d, xs, ws)
            for q in range(n):
                for i, di in enumerate(directions):
                    if di == d:
                        assert torch.equal(outs[q][i], emu[q])


@pytest.mark.parametrize("op", ["ag", "rs"])
@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_plan_counts_and_encoding(n, op):
    """n hop kernels and n − 1 forwards a call; ``arrive`` ends at n − 1
    and ``done`` at n (the host advances its bases by the same); every
    hand-off between ranks a counter wait; the launcher's rows are the
    plan's fields."""
    for rank in range(n):
        for d in (1, -1):
            plan = ring.ring_plan(op, n, rank, d)
            assert sum(o.kind == ring.GEMM for o in plan) == n
            assert sum(o.kind == ring.COPY for o in plan) == n - 1
            assert max(o.b for o in plan if o.kind == ring.WAIT
                       and o.a == ring.ARRIVE) == n - 1
            assert max(o.b for o in plan if o.kind == ring.WRITE
                       and o.a == ring.DONE) == n
            waits = [o for o in plan if o.kind == ring.WAIT]
            assert {o.a for o in waits} == {ring.ARRIVE, ring.NEXT_DONE}
            rows, count = ring.encode(op, n, rank, d)
            assert count == len(plan)
            assert list(rows) == [v for o in plan for v in o]
            blocks = sorted(o.b for o in plan if o.kind == ring.GEMM)
            assert blocks == list(range(n))


def test_ring_plan_rejects_bad_arguments():
    for args in (("ag", 1, 0, 1), ("rs", 4, 4, 1), ("ag", 4, 0, 2),
                 ("mm", 4, 0, 1)):
        with pytest.raises(ValueError):
            ring.ring_plan(*args)


def test_scheduler_catches_a_broken_plan(monkeypatch):
    """The checks bite: a plan whose forward does not wait for the next
    rank's ``done`` overwrites a slot before it is read, and one whose
    product does not wait for its arrival deadlocks or reads the wrong
    content."""
    good = ring.ring_plan.__wrapped__

    def no_done_wait(op, n, rank, direction):
        return tuple(o for o in good(op, n, rank, direction)
                     if not (o.kind == ring.WAIT and o.a == ring.NEXT_DONE))

    monkeypatch.setattr(ring, "ring_plan", no_done_wait)
    _, _, calls = _calls("ag", 4, SHAPES["ragged"], (1, 1, 1))
    with pytest.raises(AssertionError):
        _simulate(4, calls, seed=0, last=3)

    def no_arrive_wait(op, n, rank, direction):
        return tuple(o for o in good(op, n, rank, direction)
                     if not (o.kind == ring.WAIT and o.a == ring.ARRIVE))

    monkeypatch.setattr(ring, "ring_plan", no_arrive_wait)
    _, _, calls = _calls("rs", 4, SHAPES["ragged"], (1,))
    with pytest.raises(AssertionError):
        _simulate(4, calls, seed=0, last=0)
