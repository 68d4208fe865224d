"""The port's ART, pipeline, collectives and conduit ops against the
reference's.

* ``core/pipeline.py``: the chunk cuts, and the call order of
  ``chunk_pipeline``, ``chunk_pipeline_carried`` and ``streamed`` (the
  transfer of chunk k−1 issued before the compute of chunk k, and waited
  on only after it) against the reference's unrolled loops;
* ``art_send``, ``art_matmul_reducescatter`` (2 and 4 ranks, 1/4/8
  chunks), ``bulk_matmul_reducescatter`` and ``split_conv_allgather`` at 2
  and 4 gloo ranks against the reference under ``shard_map``;
* the conduit's ``ring`` and ``xla`` transports of all six ops (and the
  ``collectives`` wrappers, which bind ``ring``) at 2, 3 and 4 ranks, bulk
  and ART-chunked, and ``Conduit.streamed``;
* the two examples, run with ``--device cpu``.

Tolerance: fp32 1e-5 (the two sides sum in other orders); collectives
that only move data are exact.  One gloo world per size is spawned for
the module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from repro.core import art as ref_art
from repro.core import collectives as ref_col
from repro.core import pipeline as ref_pl
from repro.core.conduit import Conduit as RefConduit
from repro_torch.core import pipeline as pl
from repro_torch.core.conduit import Conduit
from repro_torch.dist import rank_tasks
from repro_torch.dist.group import Group, Pending, RankPool
from repro_torch.examples import pgas_matmul_2node, quickstart

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pools():
    """One gloo world of CPU ranks per size, spawned together."""
    worlds = {n: RankPool(n, device="cpu") for n in (2, 3, 4)}
    yield worlds
    for pool in worlds.values():
        pool.close()


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("x",))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# pipeline: cuts and call order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,n", [(10, 3), (7, 7), (3, 5), (1, 1),
                                     (100, 8), (0, 2)])
def test_chunk_cuts_match_reference(total, n):
    assert pl.chunk_slices(total, n) == ref_pl.chunk_slices(total, n)
    for cb in (None, 0, 1, 7, 1000):
        assert pl.n_chunks(total * 4, cb, max(1, total)) == \
            ref_pl.n_chunks(total * 4, cb, max(1, total))
    x = np.arange(max(total, 1) * 3).reshape(-1, 3)
    got = pl.split(torch.from_numpy(x), n, axis=0)
    want = ref_pl.split(jnp.asarray(x), n, axis=0)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _logged(log, tag, value=None):
    log.append(tag)
    return value


def _run_order(mod, kind, n, pending=False):
    """The sequence of compute / transfer / wait / consume events of one
    pipeline run of module ``mod`` (the port's or the reference's)."""
    log = []

    def compute(k, *carry):
        out = _logged(log, f"compute{k}", k * 10)
        return (out, (carry[0] + 1,)) if carry else out

    def transfer(k, payload):
        log.append(f"transfer{k}")
        if pending:
            return Pending(lambda: _logged(log, f"wait{k}", payload + 1))
        return payload + 1

    def consume(state, k, arrived):
        log.append(f"consume{k}")
        return state + [arrived]

    if kind == "chunk":
        out = mod.chunk_pipeline(n, compute, transfer, consume, init=[])
    elif kind == "carried":
        out = mod.chunk_pipeline_carried(
            n, lambda k, c: compute(k, *c), transfer, consume, carry=(0,),
            init=[])
    else:
        out = mod.streamed(n, lambda k: transfer(k, compute(k)),
                           lambda k, a: _logged(log, f"consume{k}", a))
    return log, out


@pytest.mark.parametrize("kind", ["chunk", "carried", "streamed"])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_pipeline_order_matches_reference(kind, n):
    want_log, want = _run_order(ref_pl, kind, n)
    got_log, got = _run_order(pl, kind, n)
    assert got_log == want_log and got == want
    # with transfers in flight: chunk k−1's arrival is waited on only
    # after chunk k's compute was issued
    log, got = _run_order(pl, kind, n, pending=True)
    assert got == want
    assert [e for e in log if not e.startswith("wait")] == want_log
    for k in range(n - 1):
        assert log.index(f"wait{k}") > log.index(f"compute{k + 1}")


# ---------------------------------------------------------------------------
# ART entry points vs the reference under shard_map
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _matmul_case(n, n_chunks):
    rng = np.random.default_rng(10 * n + n_chunks)
    m, nn = _rand(rng, 32, 24), _rand(rng, 24, 16)
    k, c = 24 // n, 16 // n
    a = np.stack([m[:, r * k:(r + 1) * k] for r in range(n)])
    b = np.stack([nn[r * k:(r + 1) * k] for r in range(n)])
    mesh = _mesh(n)
    specs = dict(mesh=mesh, in_specs=(P(None, "x"), P("x", None)),
                 out_specs=P(None, "x"))
    art = jax.jit(jax.shard_map(functools.partial(
        ref_art.art_matmul_reducescatter, axis="x", n_chunks=n_chunks),
        **specs))(jnp.asarray(m), jnp.asarray(nn))
    bulk = jax.jit(jax.shard_map(functools.partial(
        ref_art.bulk_matmul_reducescatter, axis="x"), **specs))(
        jnp.asarray(m), jnp.asarray(nn))
    blocks = lambda y: [np.asarray(y)[:, r * c:(r + 1) * c] for r in range(n)]
    return a, b, blocks(art), blocks(bulk)


@pytest.mark.parametrize("n_chunks", [1, 4, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_art_matmul_matches_reference(pools, n, n_chunks):
    a, b, want, _ = _matmul_case(n, n_chunks)
    got = pools[n].run(rank_tasks.art_op, "art", a, b, n_chunks)
    for r in range(n):
        np.testing.assert_allclose(got[r], want[r], **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_bulk_matmul_matches_reference(pools, n):
    a, b, _, want = _matmul_case(n, 1)
    got = pools[n].run(rank_tasks.art_op, "bulk", a, b)
    for r in range(n):
        np.testing.assert_allclose(got[r], want[r], **TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_split_conv_matches_reference(pools, n):
    rng = np.random.default_rng(n)
    imgs, kern = _rand(rng, 2, 9, 8, 3), _rand(rng, 3, 2, 3, 4 * n)
    want = jax.jit(jax.shard_map(
        functools.partial(ref_art.split_conv_allgather, axis="x"),
        mesh=_mesh(n), in_specs=(P(), P(None, None, None, "x")),
        out_specs=P(), check_vma=False))(jnp.asarray(imgs),
                                         jnp.asarray(kern))
    c = 4
    a = np.stack([imgs] * n)
    b = np.stack([kern[..., r * c:(r + 1) * c] for r in range(n)])
    got = pools[n].run(rank_tasks.art_op, "conv", a, b)
    for r in range(n):
        assert got[r].shape == (2, 7, 7, 4 * n)
        np.testing.assert_allclose(got[r], np.asarray(want), **TOL)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("n,shift", [(2, 1), (4, 1), (4, 3)])
def test_art_send_matches_reference(pools, n, shift, accumulate):
    chunks = _rand(np.random.default_rng(n + shift), n, 5, 3, 4)

    def body(c):
        run = ref_art.art_send(
            lambda k: lax.dynamic_index_in_dim(c[0], k, 0, keepdims=False),
            5, axis="x", shift=shift, accumulate=accumulate)
        return run()[None]

    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=_mesh(n), in_specs=P("x"), out_specs=P("x")))(
        jnp.asarray(chunks)))
    got = pools[n].run(rank_tasks.art_send_op, chunks, shift, accumulate)
    for r in range(n):
        np.testing.assert_allclose(got[r], want[r], **TOL)


# ---------------------------------------------------------------------------
# conduit ring / xla ops and the collectives wrappers
# ---------------------------------------------------------------------------

_SHAPES = {"all_gather": (3, 5), "reduce_scatter": None, "all_reduce": (5, 7),
           "all_to_all": None, "broadcast": (4, 6)}


def _ref_op(n, transport, op, xs, chunk_bytes, root):
    c = RefConduit(axis="x", transport=transport, chunk_bytes=chunk_bytes)

    def body(x):
        if op == "barrier":
            return c.barrier()[None]
        if op == "broadcast":
            return c.broadcast(x[0], root)[None]
        return getattr(c, op)(x[0])[None]

    if xs is None:                          # barrier: nothing to send
        xs = np.zeros((n, 1), np.float32)
    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=_mesh(n), in_specs=P("x"), out_specs=P("x"),
        check_vma=False))(jnp.asarray(xs)))


def _inputs(n, op, seed):
    shape = _SHAPES[op] or (2 * n, 5)
    return _rand(np.random.default_rng(seed), n, *shape)


@pytest.mark.parametrize("transport,chunk_bytes", [
    ("ring", None), ("ring", 24), ("xla", None)])
@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter", "all_reduce",
                                "all_to_all", "broadcast", "barrier"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_conduit_op_matches_reference(pools, n, op, transport, chunk_bytes):
    xs = None if op == "barrier" else _inputs(n, op, 7 * n)
    root = n - 1
    got = pools[n].run(rank_tasks.collective_op, transport, op, xs,
                       chunk_bytes, root)
    want = _ref_op(n, transport, op, xs, chunk_bytes, root)
    for r in range(n):
        np.testing.assert_allclose(got[r], want[r], **TOL)
        if op in ("all_gather", "all_to_all", "broadcast", "barrier"):
            np.testing.assert_array_equal(got[r], want[r])


@pytest.mark.parametrize("op", ["all_reduce", "all_to_all"])
@pytest.mark.parametrize("transport", ["ring", "xla"])
def test_conduit_streamed_matches_reference(pools, transport, op):
    n = 4
    xs = _rand(np.random.default_rng(3), n, n, 9)
    got = pools[n].run(rank_tasks.collective_op, transport, op, xs,
                       streamed=3, dim=1)
    c = RefConduit(axis="x", transport=transport)

    def body(x):
        outs = c.streamed(op, ref_pl.split(x[0], 3, axis=1))
        return tuple(o[None] for o in outs)

    want = jax.jit(jax.shard_map(body, mesh=_mesh(n), in_specs=P("x"),
                                 out_specs=P("x"), check_vma=False))(
        jnp.asarray(xs))
    for r in range(n):
        assert len(got[r]) == len(want) == 3
        for a, b in zip(got[r], want):
            np.testing.assert_allclose(a, np.asarray(b)[r], **TOL)


def test_collectives_wrappers_bind_the_ring():
    """``core/collectives.py`` binds the ``ring`` transport, as the
    reference's does, and forwards its arguments."""
    from repro_torch.core import collectives as col

    calls = []

    class Spy(Conduit):
        def _call(self, op, x, **kw):
            calls.append((self.transport, self.chunk_bytes, op, kw))
            return x

    import repro_torch.core.collectives as mod
    orig = mod.Conduit
    mod.Conduit = Spy
    try:
        g = Group(rank=0, size=2, device=torch.device("cpu"))
        x = torch.zeros(4, 2)
        col.broadcast(x, 1, group=g)
        col.ring_all_gather(x, group=g, chunk_bytes=8)
        col.ring_reduce_scatter(x, group=g)
        col.ring_all_reduce(x, group=g, chunk_bytes=16)
        col.all_to_all_chunked(x, group=g)
    finally:
        mod.Conduit = orig
    assert [c[:3] for c in calls] == [
        ("ring", None, "broadcast"), ("ring", 8, "all_gather"),
        ("ring", None, "reduce_scatter"), ("ring", 16, "all_reduce"),
        ("ring", None, "all_to_all")]
    assert calls[0][3] == {"root": 1}
    assert ref_col.broadcast.__doc__ and col.barrier.__doc__


# ---------------------------------------------------------------------------
# the examples on CPU ranks
# ---------------------------------------------------------------------------


def test_quickstart_example_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rank2 result after AM compute: [20. 20. 20. 20.]" in out
    assert out.strip().endswith("quickstart OK")


def test_case_study_example_on_cpu(capsys):
    assert pgas_matmul_2node.main(["--device", "cpu", "--sizes", "64", "128",
                                   "--fmap", "12", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count(" OK |") == 5
    assert out.strip().endswith("pgas_matmul_2node OK")
