"""The port's PGAS substrate against the reference's.

* the symmetric heap, block and heartbeat segments: the same offsets and
  the same errors as ``repro.core.pgas``;
* ``Group.permute`` against ``lax.ppermute`` for arbitrary permutations;
* one-sided programs at 2 and 4 gloo ranks — ``put`` (a single pair, a
  ring, a clamped offset, and a ring PUT of a slice of the sender's own
  heap: the snapshot rule), ``get``, ``put_ring``, the
  ``GlobalAddressSpace`` closures, ``gasnet_put``/``gasnet_get`` and the
  short, medium and long AM classes (with an opcode outside the table,
  which ``lax.switch`` clamps) — against the same program under
  ``shard_map`` on the host devices, op by op.  Heaps and delivered
  chunks must be bit-identical in fp32: every operation is a copy, one
  multiply by an integer or one add, in the same order on both sides;
* the quickstart's ``SCALE`` handler and its run on 4 ranks; the opcode
  table; what is not ported raises.

One gloo world per size is spawned for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.core import am as ref_am
from repro.core import art as ref_art
from repro.core import pgas as ref_pgas
from repro_torch.core import am, pgas
from repro_torch.dist import rank_tasks
from repro_torch.dist.group import Group, RankPool


@pytest.fixture(scope="module")
def pools():
    """One gloo world of CPU ranks per size, spawned together."""
    worlds = {n: RankPool(n, device="cpu") for n in (2, 4)}
    yield worlds
    for pool in worlds.values():
        pool.close()


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


# ---------------------------------------------------------------------------
# layout (no communication)
# ---------------------------------------------------------------------------


def test_heap_layout_matches_reference():
    ours, ref = pgas.SymmetricHeap(64), ref_pgas.SymmetricHeap(64)
    for name, words in [("a", 8), ("b", 16), ("c", 1), ("d", 39)]:
        a, b = ours.alloc(name, words), ref.alloc(name, words)
        assert (a.name, a.offset, a.size) == (b.name, b.offset, b.size)
        assert ours.addr(name) == ref.addr(name)
    for heap in (ours, ref):
        with pytest.raises(MemoryError):
            heap.alloc("e", 1)
        with pytest.raises(ValueError):
            heap.alloc("a", 1)
    z = ours.zeros_local("cpu")
    assert z.shape == (64,) and z.dtype == torch.float32 and not z.any()


@pytest.mark.parametrize("n", [2, 4])
def test_segments_match_reference(n):
    ours_heap, ref_heap = pgas.SymmetricHeap(128), ref_pgas.SymmetricHeap(128)
    for heap in (ours_heap, ref_heap):
        heap.alloc("pad", 5)
        heap.alloc("kv", 96)
    ours = pgas.GlobalAddressSpace(
        Group(rank=0, size=n, device=torch.device("cpu")), ours_heap)
    ref = ref_pgas.GlobalAddressSpace(_mesh(n), "x", ref_heap)
    for bw in (8, 12, 32):
        a, b = ours.block_segment("kv", bw), ref.block_segment("kv", bw)
        assert (a.n_blocks, a.blocks_per_rank) == (b.n_blocks,
                                                   b.blocks_per_rank)
        for bid in range(a.n_blocks):
            assert a.addr(bid) == b.addr(bid)
            assert tuple(int(v) for v in a.addr(torch.tensor(bid))) == \
                b.addr(bid)
    for seg in (ours, ref):
        with pytest.raises(ValueError):
            seg.block_segment("kv", 7)
    ha, hb = ours.heartbeat_segment(), ref.heartbeat_segment()
    assert ha.words == hb.words == 2 * n
    assert [ha.lease_offset(r) for r in range(n)] == \
        [hb.lease_offset(r) for r in range(n)]
    assert [ha.join_offset(r) for r in range(n)] == \
        [hb.join_offset(r) for r in range(n)]
    assert ours.heartbeat_segment().symbol == ha.symbol    # idempotent


# ---------------------------------------------------------------------------
# Group.permute vs lax.ppermute
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,perm", [
    (2, [(0, 1)]), (2, [(0, 1), (1, 0)]), (4, [(0, 2), (3, 1)]),
    (4, [(1, 1), (2, 0)]), (4, [(i, (i + 3) % 4) for i in range(4)]),
])
def test_permute_matches_ppermute(pools, n, perm):
    xs = np.random.default_rng(n).standard_normal((n, 3, 5)) \
        .astype(np.float32)
    want = jax.jit(jax.shard_map(
        lambda x: lax.ppermute(x, "x", perm), mesh=_mesh(n),
        in_specs=P("x"), out_specs=P("x")))(jnp.asarray(xs))
    got = pools[n].run(rank_tasks.permute_op, xs, perm)
    np.testing.assert_array_equal(np.stack(got), np.asarray(want))


def test_permute_rejects_repeats():
    g = Group(rank=0, size=4, device=torch.device("cpu"))
    for perm in ([(0, 1), (0, 2)], [(0, 1), (2, 1)], [(0, 4)]):
        with pytest.raises(ValueError):
            g.permute(torch.zeros(2), perm)


# ---------------------------------------------------------------------------
# one-sided programs vs the reference under shard_map
# ---------------------------------------------------------------------------


def _ref_scale(h, args, payload):
    inbox = lax.dynamic_slice(h, (args[0],), (16,))
    h = lax.dynamic_update_slice(h, inbox * args[1].astype(h.dtype),
                                 (args[2],))
    return h, jnp.int32(0), ref_am.make_args(), jnp.zeros_like(payload)


def _ref_accum(h, args, payload):
    cur = lax.dynamic_slice(h, (args[0],), payload.shape)
    h = lax.dynamic_update_slice(h, cur + payload.astype(h.dtype),
                                 (args[0],))
    return h, jnp.int32(0), ref_am.make_args(), jnp.zeros_like(payload)


def _ref_registry():
    reg = ref_am.HandlerRegistry()
    reg.register_request("SCALE", _ref_scale)
    reg.register_request("ACCUM", _ref_accum)
    return reg


def _ref_program(n, size, symbols, ops, init):
    """The port's ``pgas_program`` op list, each op one jitted shard_map
    of the reference over the global heap."""
    heap = ref_pgas.SymmetricHeap(size)
    for name, words in symbols:
        heap.alloc(name, words)
    mesh = _mesh(n)
    gas = ref_pgas.GlobalAddressSpace(mesh, "x", heap)
    g = jax.device_put(jnp.asarray(init.reshape(-1)),
                       NamedSharding(mesh, P("x")))
    reg = _ref_registry()
    outs = []

    def glob(p):
        return jnp.asarray(p.reshape(-1))

    def with_payload(fn, payloads):
        return gas.run(fn, extra_in_specs=(P("x"),))(g, glob(payloads))

    def with_output(fn):
        h, out = gas.run(lambda h: fn(h), extra_out_specs=P("x"))(g)
        outs.append(np.asarray(out).reshape(n, -1))
        return h

    for op in ops:
        kind, rest = op[0], op[1:]
        if kind == "put":
            payloads, off, perm = rest
            g = with_payload(lambda h, p: ref_pgas.put(
                h, p, off, axis="x", perm=perm), payloads)
        elif kind == "put_slice":
            src, length, off, perm = rest
            g = gas.run(lambda h: ref_pgas.put(
                h, lax.dynamic_slice(h, (src,), (length,)), off, axis="x",
                perm=perm))(g)
        elif kind == "put_ring":
            payloads, off, shift = rest
            g = with_payload(lambda h, p: ref_pgas.put_ring(
                h, p, off, axis="x", shift=shift), payloads)
        elif kind == "get":
            off, size_, perm = rest
            g = with_output(lambda h: (h, ref_pgas.get(
                h, off, size_, axis="x", perm=perm)))
        elif kind == "write_symbol":
            name, payloads, perm = rest
            g = gas.write_symbol(name, perm=perm)(g, glob(payloads))
        elif kind == "write_block":
            name, bw, payloads, bid, perm = rest
            g = gas.write_block(name, bw, perm=perm)(g, glob(payloads),
                                                     jnp.int32(bid))
        elif kind == "read_symbol":
            name, perm = rest
            g, out = gas.read_symbol(name, perm=perm)(g)
            outs.append(np.asarray(out).reshape(n, -1))
        elif kind == "gasnet_put":
            payloads, off, perm = rest
            g = with_payload(lambda h, p: ref_am.gasnet_put(
                reg, h, p, off, axis="x", perm=perm), payloads)
        elif kind == "gasnet_get":
            src, dst, size_, perm = rest
            g = gas.run(lambda h: ref_am.gasnet_get(
                reg, h, src, dst, size_, axis="x", perm=perm))(g)
        elif kind == "am":
            opcode, args, payloads, perm = rest
            g = with_payload(lambda h, p: ref_am.am_request(
                reg, h, opcode, ref_am.make_args(*args), p, axis="x",
                perm=perm), payloads)
        elif kind == "am_short":
            name, args, perm = rest
            g = gas.run(lambda h: ref_am.am_request_short(
                reg, h, reg.request_opcode(name), ref_am.make_args(*args),
                axis="x", perm=perm))(g)
        elif kind == "am_medium":
            name, args, payloads, perm = rest
            g, out = gas.run(lambda h, p: ref_am.am_request_medium(
                reg, h, reg.request_opcode(name), ref_am.make_args(*args),
                p, axis="x", perm=perm), extra_in_specs=(P("x"),),
                extra_out_specs=P("x"))(g, glob(payloads))
            outs.append(np.asarray(out).reshape(n, -1))
        elif kind == "am_long":
            name, args, payloads, off, perm = rest
            g = with_payload(lambda h, p: ref_am.am_request_long(
                reg, h, reg.request_opcode(name), ref_am.make_args(*args),
                p, off, axis="x", perm=perm), payloads)
        else:
            raise ValueError(kind)
    return np.asarray(g).reshape(n, size), outs


def _program(n):
    rng = np.random.default_rng(100 + n)

    def pay(words):
        return rng.standard_normal((n, words)).astype(np.float32)

    ring = [(i, (i + 1) % n) for i in range(n)]
    last = n - 1
    size = 96
    symbols = [("inbox", 16), ("blocks", 32), ("hb", 8)]
    ops = [
        ("put", pay(16), 5, [(0, last)]),
        ("put_ring", pay(16), 30, 1),
        ("put_ring", pay(16), 90, n - 1),              # clamped to 80
        ("put_slice", 30, 16, 34, ring),               # the snapshot rule
        ("get", 34, 16, [(1, 0)] + ([(2, 3)] if n > 2 else [])),
        ("get", 5, 24, ring),
        ("write_symbol", "inbox", pay(16), [(last, 0)]),
        ("write_block", "blocks", 8, pay(8), 5, [(0, 1)]),   # owner 1
        ("read_symbol", "blocks", [(0, 1)]),
        ("gasnet_put", pay(8), 70, [(1, last)] if n > 2 else [(1, 0)]),
        ("gasnet_get", 70, 0, 8, [(0, 1)]),
        ("am_short", "SCALE", (0, 3, 50), [(1, 0)]),
        ("am_medium", "ACCUM", (10,), pay(16), [(0, 1), (1, 0)]),
        ("am_long", "SCALE", (0, 2, 60), pay(16), 20, [(last, 0)]),
        ("am", 17, (40,), pay(16), [(1, 0)]),          # clamps to ACCUM
        ("am", -5, (44,), pay(16), [(0, 1)]),          # clamps to PUT
    ]
    init = rng.standard_normal((n, size)).astype(np.float32)
    return size, symbols, ops, init


@pytest.mark.parametrize("n", [2, 4])
def test_one_sided_program_matches_reference(pools, n):
    size, symbols, ops, init = _program(n)
    res = pools[n].run(rank_tasks.pgas_program, size, symbols, ops, init)
    want_heap, want_outs = _ref_program(n, size, symbols, ops, init)
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["heap"], want_heap[r])
        assert len(got["outputs"]) == len(want_outs)
        for o, w in zip(got["outputs"], want_outs):
            np.testing.assert_array_equal(o, w[r])


def test_ring_put_of_a_heap_slice_reads_the_old_slice(pools):
    """Every source sends its slice as it was before the call, though the
    ring's stores land in the same words of every heap."""
    n = 4
    init = np.arange(n * 32, dtype=np.float32).reshape(n, 32)
    ring = [(i, (i + 1) % n) for i in range(n)]
    res = pools[n].run(rank_tasks.pgas_program, 32, [],
                       [("put_slice", 0, 16, 8, ring)], init)
    for r, got in enumerate(res):
        want = init[r].copy()
        want[8:24] = init[(r - 1) % n][:16]
        np.testing.assert_array_equal(got["heap"], want)


def test_heaps_one_after_another(pools):
    """Program after program on one pool, each heap dropped at its end:
    every ring PUT reads back (on the card each heap's partition is freed
    by the next mapping; ``test_torch_gpu.py`` counts them there)."""
    for r in pools[2].run(rank_tasks.heap_churn, 3, 64):
        assert r == {"partitions": [], "read_back": True}


# ---------------------------------------------------------------------------
# Active Messages
# ---------------------------------------------------------------------------


def test_opcode_table_matches_reference():
    ours, ref = rank_tasks.am_registry(), _ref_registry()
    for name in ("PUT", "GET", "SCALE", "ACCUM"):
        assert ours.request_opcode(name) == ref.request_opcode(name)
    for name in ("NOP_REPLY", "PUT_REPLY"):
        assert ours.reply_opcode(name) == ref.reply_opcode(name)
    assert (ours.request_opcode("PUT"), ours.request_opcode("GET")) == (0, 1)
    with pytest.raises(KeyError):
        ours.request_opcode("NOPE")
    args = am.make_args(3, -2, 7)
    assert args.dtype == torch.int32 and args.shape == (am.MAX_ARGS,)
    np.testing.assert_array_equal(args.numpy(),
                                  np.asarray(ref_am.make_args(3, -2, 7)))


def test_scale_handler_matches_reference():
    rng = np.random.default_rng(1)
    h = rng.standard_normal(64).astype(np.float32)
    args = (16, 10, 32)
    got = rank_tasks.scale_handler(torch.from_numpy(h.copy()),
                                   am.make_args(*args), torch.zeros(1))
    want = _ref_scale(jnp.asarray(h), ref_am.make_args(*args),
                      jnp.zeros((1,)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1] == int(want[1]) and got[3].shape == want[3].shape


def test_unported_and_malformed_raise():
    g = Group(rank=0, size=2, device=torch.device("cpu"))
    h = torch.zeros(8)
    reg = am.HandlerRegistry()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        am.am_request_short(reg, h, 0, am.make_args(), group=g,
                            perm=[(0, 1)], epoch=3)
    bad = reg.register_request(
        "BAD", lambda h, a, p: (h, 0, am.make_args(), torch.zeros(2)))
    with pytest.raises(ValueError, match="shape"):
        reg.dispatch_request(bad, h, am.make_args(), torch.zeros(3))
    with pytest.raises(ValueError):
        am.make_args(*range(am.MAX_ARGS + 1))


# ---------------------------------------------------------------------------
# the quickstart on 4 ranks
# ---------------------------------------------------------------------------


def _ref_quickstart():
    """examples/quickstart.py's three steps under shard_map on 4 host
    devices, with the port's ART operands."""
    mesh = _mesh(4)
    heap = ref_pgas.SymmetricHeap(64)
    heap.alloc("inbox", 16)
    heap.alloc("result", 16)
    gas = ref_pgas.GlobalAddressSpace(mesh, "x", heap)
    g = gas.zeros_global()

    def ring_put(h):
        my = lax.axis_index("x").astype(jnp.float32)
        return ref_pgas.put(h, jnp.full((16,), my + 1.0), heap.addr("inbox"),
                            axis="x", perm=[(i, (i + 1) % 4)
                                            for i in range(4)])

    g = gas.run(ring_put)(g)
    after_put = np.asarray(g).reshape(4, 64)
    reg = ref_am.HandlerRegistry()
    scale = reg.register_request("SCALE", _ref_scale)

    def send_compute(h):
        args = ref_am.make_args(heap.addr("inbox"), 10, heap.addr("result"))
        return ref_am.am_request_short(reg, h, scale, args, axis="x",
                                       perm=[(0, 2)])

    g = gas.run(send_compute)(g)
    m, n = rank_tasks.quickstart_inputs(0)
    f = jax.jit(jax.shard_map(
        lambda a, b: ref_art.art_matmul_reducescatter(a, b, axis="x",
                                                      n_chunks=4),
        mesh=mesh, in_specs=(P(None, "x"), P("x", None)),
        out_specs=P(None, "x")))
    art = np.asarray(f(jnp.asarray(m), jnp.asarray(n)))
    return after_put, np.asarray(g).reshape(4, 64), art


def test_quickstart_matches_reference(pools):
    res = pools[4].run(rank_tasks.quickstart, device="cpu")
    after_put, heaps, art = _ref_quickstart()
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["heap_after_put"], after_put[r])
        np.testing.assert_array_equal(got["heap"], heaps[r])
        np.testing.assert_allclose(got["art"], art[:, r * 16:(r + 1) * 16],
                                   rtol=1e-5, atol=1e-5)
        assert got["art_err"] < 2e-4 and not got["peer"]
    assert res[2]["heap"][16] == 10.0 * 2      # rank 1 put 2.0s, × 10
