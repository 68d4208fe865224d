"""The port's fused collective matmuls against the reference's.

* the three hop functions' plain versions against the Pallas kernels of
  ``repro.kernels.cc_matmul.kernel`` (interpret mode);
* ``allgather_matmul_fused`` / ``matmul_reducescatter_fused`` over gloo
  groups of 2, 3 and 4 ranks, uni- and bidirectional, 2-D and 3-D
  inputs, against ``allgather_matmul_pallas`` /
  ``matmul_reducescatter_pallas`` under ``shard_map`` on the 4 host
  devices — outputs, and their ``dx``/``dw`` against ``jax.grad``;
* the whole-ring wrappers ``ag_matmul_ring`` / ``rs_matmul_ring`` (here
  their plain versions, the CPU path) against the reference's
  unidirectional ops, both ring directions;
* ``Conduit.matmul_bidirectional`` against the reference's decision;
  every transport of the reference resolved, ``auto`` among them;
* the conduit's ring all_gather / reduce_scatter wire and its gradient.

Every rank gets its own inputs (stacked on a leading rank axis, the
``shard_map`` in/out spec ``P("x")``), so per-rank outputs and gradients
compare one to one.  Tolerance: fp32 1e-5 (the two sides sum in other
orders).  One gloo world per size is spawned for the module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.core.conduit import Conduit as RefConduit
from repro.core.conduit import transports as ref_transports
from repro.kernels.cc_matmul import kernel as ref_kernel
from repro.kernels.cc_matmul import (
    allgather_matmul_pallas,
    matmul_reducescatter_pallas,
)
from repro_torch.core.conduit import Conduit, transports
from repro_torch.dist import rank_tasks
from repro_torch.dist.group import Group, RankPool
from repro_torch.kernels.cc_matmul import (
    PLAIN_CALLS,
    consume_matmul,
    consume_matmul_acc,
    consume_matmul_acc_plain,
    consume_matmul_plain,
    matmul_tile,
    matmul_tile_plain,
)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pools():
    """One gloo world of CPU ranks per size, spawned together."""
    worlds = {n: RankPool(n, device="cpu") for n in (2, 3, 4)}
    yield worlds
    for pool in worlds.values():
        pool.close()


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the hop kernels' plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,k,n", [(8, 16, 32), (5, 24, 7), (1, 3, 130)])
def test_plain_hop_versions_match_pallas_kernels(b, k, n):
    rng = np.random.default_rng(b * 100 + k)
    x, w = _rand(rng, b, k), _rand(rng, k, n)
    scr_x, scr_acc = _rand(rng, 2, b, k), _rand(rng, 2, b, n)
    before = dict(PLAIN_CALLS)
    t = torch.from_numpy
    got = {
        "tile": matmul_tile(t(x), t(w)),
        "consume": [consume_matmul(t(scr_x), t(w), slot=s) for s in (0, 1)],
        "acc": [consume_matmul_acc(t(scr_acc), t(x), t(w), slot=s)
                for s in (0, 1)],
    }
    assert PLAIN_CALLS["matmul_tile"] == before["matmul_tile"] + 1
    assert PLAIN_CALLS["consume_matmul"] == before["consume_matmul"] + 2
    assert PLAIN_CALLS["consume_matmul_acc"] == \
        before["consume_matmul_acc"] + 2
    want_tile = ref_kernel.matmul_tile(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True)
    np.testing.assert_allclose(got["tile"].numpy(), want_tile, **TOL)
    for s in (0, 1):
        want = ref_kernel.consume_matmul(jnp.asarray(scr_x), jnp.asarray(w),
                                         slot=s, interpret=True)
        np.testing.assert_allclose(got["consume"][s].numpy(), want, **TOL)
        want = ref_kernel.consume_matmul_acc(
            jnp.asarray(scr_acc), jnp.asarray(x), jnp.asarray(w), slot=s,
            interpret=True)
        np.testing.assert_allclose(got["acc"][s].numpy(), want, **TOL)


def test_plain_hop_versions_batch_dim():
    """A leading batch dim is the reference's vmap, written out."""
    rng = np.random.default_rng(7)
    x, w = _rand(rng, 3, 6, 16), _rand(rng, 16, 10)
    scr_x, scr_acc = _rand(rng, 2, 3, 6, 16), _rand(rng, 2, 3, 6, 10)
    t = torch.from_numpy
    for bb in range(3):
        np.testing.assert_allclose(
            matmul_tile_plain(t(x), t(w))[bb].numpy(),
            matmul_tile_plain(t(x[bb]), t(w)).numpy(), **TOL)
        np.testing.assert_allclose(
            consume_matmul_plain(t(scr_x), t(w), slot=1)[bb].numpy(),
            consume_matmul_plain(t(scr_x[:, bb]), t(w), slot=1).numpy(),
            **TOL)
        np.testing.assert_allclose(
            consume_matmul_acc_plain(t(scr_acc), t(x), t(w), slot=0)[bb]
            .numpy(),
            consume_matmul_acc_plain(t(scr_acc[:, bb]), t(x[bb]), t(w),
                                     slot=0).numpy(), **TOL)


def test_wrappers_reject_other_devices():
    x = torch.zeros(4, 8, device="meta")
    w = torch.zeros(8, 6, device="meta")
    with pytest.raises(ValueError, match="device"):
        matmul_tile(x, w)


# ---------------------------------------------------------------------------
# fused ops vs the reference, forward and backward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _case(n, bidir, batched):
    """Per-rank inputs of both ops, and the reference's per-rank out, dx
    and dw under one jitted shard_map (AG and RS traced together)."""
    rng = np.random.default_rng(n * 10 + bidir + 2 * batched)
    lead = (2,) if batched else ()
    b_loc, k, m = 6, 12, 10
    inputs = {
        "ag": (_rand(rng, n, *lead, b_loc, k), _rand(rng, n, k, m),
               _rand(rng, n, *lead, n * b_loc, m)),
        "rs": (_rand(rng, n, *lead, n * b_loc, k), _rand(rng, n, k, m),
               _rand(rng, n, *lead, b_loc, m)),
    }
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))

    def sharded(fn):
        def body(x, w):
            return fn(x[0], w[0], axis="x", bidirectional=bidir,
                      interpret=True)[None]
        return jax.shard_map(body, mesh=mesh, in_specs=(P("x"), P("x")),
                             out_specs=P("x"), check_vma=False)

    fns = {"ag": sharded(allgather_matmul_pallas),
           "rs": sharded(matmul_reducescatter_pallas)}

    @jax.jit
    def both(args):
        outs = {}
        for op, (x, w, g) in args.items():
            out, vjp = jax.vjp(fns[op], x, w)
            outs[op] = (out,) + vjp(g)
        return outs

    got = both({op: tuple(map(jnp.asarray, a)) for op, a in inputs.items()})
    ref = {op: tuple(np.asarray(t) for t in v) for op, v in got.items()}
    return inputs, ref


@pytest.mark.parametrize("op", ["ag", "rs"])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_fused_op_and_grads_match_reference(pools, op, n, bidir, batched):
    inputs, ref = _case(n, bidir, batched)
    xs, ws, gs = inputs[op]
    out, dx, dw = ref[op]
    res = pools[n].run(rank_tasks.fused_op, op, xs, ws, gs, bidir)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["out"], out[r], **TOL)
        np.testing.assert_allclose(got["dx"], dx[r], **TOL)
        np.testing.assert_allclose(got["dw"], dw[r], **TOL)
        assert sum(got["launches"].values()) == 0      # CPU: plain versions


def test_fused_op_hop_counts(pools):
    """The schedule's hop-function calls: bidirectional AG at n = 4 is
    2 + 2·3 consumes forward and an RS (2 tiles + 2·3 acc) backward."""
    rng = np.random.default_rng(0)
    n = 4
    xs, ws = _rand(rng, n, 8, 12), _rand(rng, n, 12, 10)
    gs = _rand(rng, n, n * 8, 10)
    res = pools[n].run(rank_tasks.fused_op, "ag", xs, ws, gs, True)
    for got in res:
        assert got["plain"] == {"consume_matmul": 8, "matmul_tile": 2,
                                "consume_matmul_acc": 6,
                                "ag_matmul_ring": 0, "rs_matmul_ring": 0}


@pytest.mark.parametrize("op", ["ag", "rs"])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("direction", [1, -1])
def test_ring_wrappers_match_reference(pools, op, n, direction):
    """The whole-ring wrappers on CPU tensors run their plain versions
    (the unfused compositions); either ring direction gives the
    reference's unidirectional fused op, batched (3-D) inputs."""
    inputs, ref = _case(n, False, True)
    xs, ws, _ = inputs[op]
    res = pools[n].run(rank_tasks.ring_op, op, xs, ws, direction)
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["out"], ref[op][0][r], **TOL)
        assert sum(got["launches"].values()) == 0
        assert got["plain"][f"{op}_matmul_ring"] == 1


# ---------------------------------------------------------------------------
# conduit: schedule decision, ring wire
# ---------------------------------------------------------------------------


def test_transport_names_match_reference():
    for op in ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
               "broadcast", "barrier"):
        assert transports(op) == ref_transports(op)


@pytest.mark.parametrize("transport", ["fused", "ring", "bidir"])
@pytest.mark.parametrize("link", ["qsfp", "ici"])
def test_matmul_bidirectional_matches_reference(transport, link):
    sizes = [1, 64, 1000, 4096, 1 << 14, 1 << 17, 1 << 20, 12_345_678,
             1 << 28]
    for n in (1, 2, 3, 4, 8):
        ref = RefConduit(axis="x", transport=transport, link=link)
        got = Conduit(axis=Group(rank=0, size=n, device=torch.device("cpu")),
                      transport=transport, link=link)
        decided = {}

        def probe(x, ref=ref, decided=decided):
            for s in sizes:
                decided[s] = ref.matmul_bidirectional(s)
            return x

        jax.vmap(probe, axis_name="x")(jnp.zeros((n,)))
        for s in sizes:
            assert got.matmul_bidirectional(s) == decided[s], (n, s)


def test_bidir_and_auto_transports_resolve():
    """Every transport the reference registers runs in the port: each
    name of ``transports(op)`` resolves to a callable, ``auto`` resolves
    a call to the reference's ``auto_select`` choice, ``matmul_schedule``
    prices the families under ``auto`` and passes ``fused`` through; a
    group of one returns its input on ``bidir``."""
    from repro.core.conduit import auto_select as ref_auto_select
    from repro_torch.core.conduit import resolve

    group = Group(rank=0, size=2, device=torch.device("cpu"))
    for op in ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
               "broadcast", "barrier"):
        for name in transports(op):
            assert callable(resolve(op, name))
    auto = Conduit(axis=group, transport="auto")
    for size in (48, 1 << 20):
        assert auto._resolve("all_gather", size) == ref_auto_select(
            "all_gather", size_bytes=size, axis_size=2)
    assert auto.matmul_schedule("all_gather", 1 << 20, 1e-4) in (
        "ring", "bidir", "fused")
    assert Conduit(axis=group, transport="fused").matmul_schedule(
        "all_gather", 1 << 20) == "fused"
    x = torch.arange(12.0).reshape(4, 3)
    solo = Group(rank=0, size=1, device=torch.device("cpu"))
    assert torch.equal(Conduit(axis=solo, transport="bidir").all_gather(x),
                       x)


@pytest.mark.parametrize("chunk_bytes", [None, 40])
def test_ring_wire_gather_scatter_and_grad(pools, chunk_bytes):
    """The bare ``fused`` collectives ride the ring wire: gather is the
    rank-ordered concatenation, its gradient the reduce-scatter."""
    n = 3
    rng = np.random.default_rng(5)
    xs = _rand(rng, n, 2, 4, 6)
    gs = _rand(rng, n, 2, 4 * n, 6)
    res = pools[n].run(rank_tasks.ring_collectives, xs, gs, chunk_bytes)
    full = np.concatenate(list(xs), axis=1)
    total = gs.sum(axis=0)
    for r, (out, dx, rs) in enumerate(res):
        np.testing.assert_array_equal(out, full)
        np.testing.assert_allclose(dx, total[:, r * 4:(r + 1) * 4], **TOL)
        np.testing.assert_allclose(rs, total[:, r * 4:(r + 1) * 4], **TOL)
