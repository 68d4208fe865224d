"""The conduit's whole transport menu and the overlap schedules against
the reference's.

* ``core/overlap.py``: ``allgather_matmul`` / ``matmul_reducescatter``,
  ring and bidir, n ∈ {2, 3, 4}, 2-D and batched, odd b and odd N_loc,
  over gloo groups of CPU ranks, against ``repro.core.overlap`` under
  ``shard_map`` on the 4 host devices (a batched case under ``jax.vmap``,
  as the reference's ``artblock`` runs it): outputs, and dx / dw against
  ``jax.vjp``, at fp32 1e-5; and bit for bit against the port's fused op
  on the same inputs (both compute the same block products in the same
  order on the CPU: the fused op's plain hop products);
* the six ``bidir`` transports at n ∈ {2, 3, 4}, bulk and ART-chunked,
  and ``Conduit(transport="auto")`` on every op, against the reference's
  under ``shard_map``: bit for bit (data movement, and sums added in the
  reference's order; a sum ``auto`` sends to ``xla`` within 1e-6, gloo
  and XLA adding in their own orders); the gradients of all_gather, reduce_scatter and
  all_to_all under ``bidir`` and ``auto`` against ``jax.vjp`` at 1e-6;
* the cost model — ``estimate_time`` for every (op, transport),
  ``matmul_edge_estimate``, ``auto_select`` (with and without
  ``compute_time``, with a pinned chunk), ``pipeline_estimate``,
  ``crossover_bytes``, ``auto_select_pipeline`` and the netmodel's
  pipeline algebra — on a grid of sizes × n ∈ {1, 2, 3, 4, 8} × both
  links: exactly the reference's floats and choices;
  ``Conduit.matmul_schedule`` at given (bytes, compute time) the
  reference's choice;
* ``grad_sync.cross_pod_all_reduce`` and ``bucketed_cross_pod_all_reduce``
  with ``transport="auto"`` (exact and int8) against the reference's on
  ``("pod", "data")`` meshes of 2 and 4 pods.

One gloo world per size is spawned for the module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from repro.core import conduit as ref_conduit
from repro.core import netmodel as ref_nm
from repro.core import overlap as ref_overlap
from repro.dist import grad_sync as ref_grad_sync
from repro_torch.core import conduit, netmodel
from repro_torch.dist import rank_tasks
from repro_torch.dist.group import Group, RankPool

TOL = dict(rtol=1e-5, atol=1e-5)
OPS = ("all_gather", "reduce_scatter", "all_reduce", "all_to_all",
       "broadcast", "barrier")


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


def _sharded(body, n):
    return jax.jit(jax.shard_map(body, mesh=_mesh(n), in_specs=P("x"),
                                 out_specs=P("x"), check_vma=False))


# ---------------------------------------------------------------------------
# the overlap schedules
# ---------------------------------------------------------------------------

B_LOC, K, N_LOC = 5, 6, 7          # odd rows a rank, odd output columns


@functools.lru_cache(maxsize=None)
def _overlap_case(n, bidir, batched):
    """Per-rank inputs of both ops and the reference's per-rank out, dx
    and dw (``jax.vjp`` under one jitted ``shard_map``)."""
    rng = np.random.default_rng(100 + 10 * n + 2 * bidir + batched)
    lead = (2,) if batched else ()
    inputs = {
        "ag": (_rand(rng, n, *lead, B_LOC, K), _rand(rng, n, K, N_LOC),
               _rand(rng, n, *lead, n * B_LOC, N_LOC)),
        "rs": (_rand(rng, n, *lead, n * B_LOC, K), _rand(rng, n, K, N_LOC),
               _rand(rng, n, *lead, B_LOC, N_LOC)),
    }
    fns = {"ag": ref_overlap.allgather_matmul,
           "rs": ref_overlap.matmul_reducescatter}

    def one(op):
        def f(x, w):
            call = functools.partial(fns[op], axis="x", bidirectional=bidir)
            if batched:
                return jax.vmap(lambda xb: call(xb, w))(x)
            return call(x, w)

        def body(x, w, g):
            out, vjp = jax.vjp(f, x[0], w[0])
            dx, dw = vjp(g[0])
            return out[None], dx[None], dw[None]
        return jax.jit(jax.shard_map(body, mesh=_mesh(n), in_specs=P("x"),
                                     out_specs=P("x"), check_vma=False))

    ref = {op: tuple(np.asarray(t) for t in one(op)(
        *map(jnp.asarray, inputs[op]))) for op in fns}
    return inputs, ref


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("op", ["ag", "rs"])
def test_overlap_op_and_grads_match_reference(pools, op, n, bidir, batched):
    inputs, ref = _overlap_case(n, bidir, batched)
    xs, ws, gs = inputs[op]
    out, dx, dw = ref[op]
    res = pools[n].run(rank_tasks.overlap_op, op, xs, ws, gs, bidir)
    directions = 2 if bidir and n > 2 else 1
    for r, got in enumerate(res):
        np.testing.assert_allclose(got["out"], out[r], **TOL)
        np.testing.assert_allclose(got["dx"], dx[r], **TOL)
        np.testing.assert_allclose(got["dw"], dw[r], **TOL)
        # the fused op's plain hop products, in the same order: bitwise
        for key in ("out", "dx", "dw"):
            np.testing.assert_array_equal(got[key], got["fused"][key])
        # n − 1 permutes a direction, forward and backward
        assert got["hops"] == 2 * directions * (n - 1)


def test_overlap_takes_a_conduit_or_an_axis():
    """``conduit=`` decides the direction by the conduit's cost model on
    the edge's payload, as the reference's ``_schedule``; one of the two
    is needed."""
    from repro_torch.core import overlap

    x, w = torch.zeros(4, 3), torch.zeros(3, 2)
    with pytest.raises(ValueError, match="conduit= or axis="):
        overlap.allgather_matmul(x, w)
    g1 = Group(rank=0, size=1, device=torch.device("cpu"))
    for transport in ("ring", "bidir", "auto", "xla", "fused"):
        c = conduit.Conduit(axis=g1, transport=transport)
        got = overlap.allgather_matmul(x, w, conduit=c)
        assert got.shape == (4, 2) and got.dtype == torch.float32
        assert overlap.matmul_reducescatter(
            x, w, conduit=c).shape == (4, 2)
    assert overlap.payload_bytes("all_gather", torch.zeros(2, 5, 3),
                                 w, 4) == 5 * 3 * 4 * 4
    assert overlap.payload_bytes("reduce_scatter",
                                 torch.zeros(2, 8, 3).bfloat16(), w,
                                 4) == 8 * 2 * 4


# ---------------------------------------------------------------------------
# the bidir transports and the auto policy, against the reference
# ---------------------------------------------------------------------------

_SHAPES = {"all_gather": (6, 5), "reduce_scatter": None, "all_reduce": (5, 7),
           "all_to_all": None, "broadcast": (4, 6)}


def _inputs(n, op, seed):
    shape = _SHAPES[op] or (4 * n, 5)
    return _rand(np.random.default_rng(seed), n, *shape)


def _ref_op(n, transport, op, xs, chunk_bytes, root):
    c = ref_conduit.Conduit(axis="x", transport=transport,
                            chunk_bytes=chunk_bytes)

    def body(x):
        if op == "barrier":
            return c.barrier()[None]
        if op == "broadcast":
            return c.broadcast(x[0], root)[None]
        return getattr(c, op)(x[0])[None]

    if xs is None:                          # barrier: nothing to send
        xs = np.zeros((n, 1), np.float32)
    return np.asarray(_sharded(body, n)(jnp.asarray(xs)))


@pytest.mark.parametrize("transport,chunk_bytes", [
    ("bidir", None), ("bidir", 24), ("auto", None), ("auto", 24)])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_conduit_op_matches_reference(pools, n, op, transport, chunk_bytes):
    """Bit for bit: data movement, and the sums of reduce_scatter and
    all_reduce added in the reference's order on the rings (``arrived +
    block``).  Where ``auto`` picks ``xla`` for a sum, gloo's all-reduce
    and XLA's psum add in their own orders: 1e-6 (measured: 4.8e-7)."""
    xs = None if op == "barrier" else _inputs(n, op, 11 * n)
    root = n - 1
    got = pools[n].run(rank_tasks.collective_op, transport, op, xs,
                       chunk_bytes, root)
    want = _ref_op(n, transport, op, xs, chunk_bytes, root)
    name = transport
    if transport == "auto" and xs is not None:
        size = xs[0].nbytes * (n if op == "all_gather" else 1)
        name, _ = conduit.auto_select(op, size_bytes=size, axis_size=n,
                                      chunk_bytes=chunk_bytes)
    for r in range(n):
        if name == "xla" and op in ("reduce_scatter", "all_reduce"):
            np.testing.assert_allclose(got[r], want[r], rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got[r], want[r])


def _ref_grad(n, transport, op, xs, gs, dim):
    c = ref_conduit.Conduit(axis="x", transport=transport)

    def body(x, g):
        def f(v):
            if op == "all_to_all":
                return c.all_to_all(v)
            # the reference gathers/scatters dim 0: move ``dim`` there
            return jnp.moveaxis(getattr(c, op)(jnp.moveaxis(v, dim, 0)),
                                0, dim)
        y, vjp = jax.vjp(f, x[0])
        return y[None], vjp(g[0])[0][None]

    y, dx = jax.jit(jax.shard_map(body, mesh=_mesh(n), in_specs=P("x"),
                                  out_specs=P("x"), check_vma=False))(
        jnp.asarray(xs), jnp.asarray(gs))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("transport", ["bidir", "auto"])
@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter", "all_to_all"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_differentiable_transports_match_reference(pools, n, op, transport):
    """all_gather and reduce_scatter along dim 1 (a batch of 2 ahead of
    the blocks, as the K/V gather and the vocab embedding run them), and
    all_to_all: outputs bit for bit, the gradients of x at 1e-6."""
    rng = np.random.default_rng(7 * n + len(op))
    rows = {"all_gather": 5, "reduce_scatter": 6 * n, "all_to_all": 2 * n}
    out_rows = {"all_gather": 5 * n, "reduce_scatter": 6,
                "all_to_all": 2 * n}
    dim = 0 if op == "all_to_all" else 1
    lead = () if op == "all_to_all" else (2,)
    xs = _rand(rng, n, *lead, rows[op], 3)
    gs = _rand(rng, n, *lead, out_rows[op], 3)
    got = pools[n].run(rank_tasks.collective_grad, transport, op, xs, gs,
                       None, dim)
    y, dx = _ref_grad(n, transport, op, xs, gs, dim)
    for r in range(n):
        np.testing.assert_array_equal(got[r]["y"], y[r])
        np.testing.assert_allclose(got[r]["dx"], dx[r], rtol=1e-6,
                                   atol=1e-6)


def test_every_transport_of_every_op_runs():
    """For every op, each name ``transports(op)`` returns, and ``auto``,
    resolve to a callable (the registry holds the reference's menu); an
    unknown name is a ``KeyError``."""
    for op in OPS:
        assert conduit.transports(op) == ref_conduit.transports(op)
        for name in conduit.transports(op):
            assert callable(conduit.resolve(op, name))
    with pytest.raises(KeyError, match="registered"):
        conduit.resolve("all_gather", "nccl")
    assert conduit.bidir_shifts(5) == (1, 4, 2, 3)
    assert conduit.bidir_shifts(4) == (1, 3, 2)
    assert sorted(conduit.bidir_shifts(8)) == list(range(1, 8))


# ---------------------------------------------------------------------------
# the cost model: exactly the reference's
# ---------------------------------------------------------------------------

SIZES = (0, 1, 4, 100, 1000, 4096, 65536, 1 << 20, 12_345_678, 1 << 28)
NS = (1, 2, 3, 4, 8)
LINKS = ("qsfp", "ici")
CHUNKS = (None, 256, 4096, 262144)


@pytest.mark.parametrize("link", LINKS)
def test_estimate_time_matches_reference_exactly(link):
    lk, rlk = conduit.LINKS[link], ref_conduit.LINKS[link]
    for op in OPS:
        for name in ref_conduit.transports(op):
            for n in NS:
                for s in SIZES:
                    for chunk in CHUNKS:
                        kw = dict(size_bytes=s, axis_size=n,
                                  chunk_bytes=chunk)
                        assert conduit.estimate_time(
                            op, name, link=lk, **kw) == \
                            ref_conduit.estimate_time(op, name, link=rlk,
                                                      **kw), (op, name, kw)
    with pytest.raises(ValueError):
        conduit.estimate_time("all_gather", "nccl", size_bytes=8,
                              axis_size=2)


@pytest.mark.parametrize("link", LINKS)
def test_edge_estimate_and_auto_select_match_reference(link):
    lk, rlk = conduit.LINKS[link], ref_conduit.LINKS[link]
    for op in ("all_gather", "reduce_scatter"):
        for name in ("xla", "ring", "bidir", "fused"):
            for n in NS:
                for s in SIZES:
                    for tc in (0.0, 1e-6, 3.3e-5, 1e-3):
                        kw = dict(size_bytes=s, axis_size=n,
                                  compute_time=tc)
                        assert conduit.matmul_edge_estimate(
                            op, name, link=lk, **kw) == \
                            ref_conduit.matmul_edge_estimate(
                                op, name, link=rlk, **kw), (op, name, kw)
    with pytest.raises(ValueError):
        conduit.matmul_edge_estimate("all_reduce", "ring", size_bytes=8,
                                     axis_size=2, compute_time=0.0)
    for op in OPS:
        for n in NS:
            for s in SIZES:
                for chunk in (None, 1024):
                    for tc in ((None, 2e-5) if op in ("all_gather",
                                                      "reduce_scatter")
                               else (None,)):
                        kw = dict(size_bytes=s, axis_size=n,
                                  chunk_bytes=chunk, compute_time=tc)
                        assert conduit.auto_select(op, link=lk, **kw) == \
                            ref_conduit.auto_select(op, link=rlk, **kw), \
                            (op, kw)


@pytest.mark.parametrize("link", LINKS)
def test_pipeline_estimators_match_reference(link):
    lk, rlk = conduit.LINKS[link], ref_conduit.LINKS[link]
    assert conduit.CHUNK_CANDIDATES == ref_conduit.CHUNK_CANDIDATES
    assert conduit.PIPELINE_CHUNKS == ref_conduit.PIPELINE_CHUNKS
    for op in ("all_reduce", "all_to_all", "all_gather"):
        for n in NS:
            for s in (1, 4096, 1 << 20, 12_345_678):
                for tc in (0.0, 1e-4):
                    for c in (1, 3, 8):
                        kw = dict(size_bytes=s, axis_size=n, n_chunks=c,
                                  compute_time=tc)
                        assert conduit.pipeline_estimate(
                            op, "ring", link=lk, **kw) == \
                            ref_conduit.pipeline_estimate(
                                op, "ring", link=rlk, **kw)
                    kw = dict(size_bytes=s, axis_size=n, compute_time=tc)
                    assert conduit.auto_select_pipeline(
                        op, link=lk, **kw) == \
                        ref_conduit.auto_select_pipeline(op, link=rlk, **kw)
                    assert conduit.auto_select_pipeline(
                        op, link=lk, chunk_bytes=4096, **kw) == \
                        ref_conduit.auto_select_pipeline(
                            op, link=rlk, chunk_bytes=4096, **kw)
            assert conduit.crossover_bytes(op, axis_size=n, link=lk) == \
                ref_conduit.crossover_bytes(op, axis_size=n, link=rlk)
            assert conduit.crossover_bytes(op, axis_size=n, link=lk, lo=8,
                                           hi=1 << 12) == \
                ref_conduit.crossover_bytes(op, axis_size=n, link=rlk,
                                            lo=8, hi=1 << 12)


def test_netmodel_pipeline_algebra_matches_reference():
    assert netmodel.HBM_BYTES_PER_S == ref_nm.HBM_BYTES_PER_S
    # the one rate that is the card's own, not the reference's figure
    assert netmodel.DENSE_BF16_FLOPS == 989e12 != ref_nm.MXU_BF16_FLOPS
    rng = np.random.default_rng(3)
    for k in (1, 2, 5, 9):
        tcs = [float(v) for v in rng.random(k) * 1e-4]
        txs = [float(v) for v in rng.random(k) * 1e-4]
        assert netmodel.pipeline_time(tcs, txs) == \
            ref_nm.pipeline_time(tcs, txs)
        assert netmodel.fused_pipeline_time(
            tcs, txs, launch_overhead=2e-6) == ref_nm.fused_pipeline_time(
                tcs, txs, launch_overhead=2e-6)
    assert netmodel.bulk_time(1e-3, 2e-3, 3e-6) == \
        ref_nm.bulk_time(1e-3, 2e-3, 3e-6)
    for link in LINKS:
        for hop in (0, 1, 1000, 1 << 20):
            assert netmodel.hop_launch_overhead(
                conduit.LINKS[link], hop) == ref_nm.hop_launch_overhead(
                    ref_conduit.LINKS[link], hop)


@pytest.mark.parametrize("transport", ["auto", "xla", "ring", "bidir",
                                       "fused"])
@pytest.mark.parametrize("link", LINKS)
def test_matmul_schedule_matches_reference(transport, link):
    cases = [(op, s, tc) for op in ("all_gather", "reduce_scatter")
             for s in (64, 4096, 1 << 17, 1 << 20, 10_485_760, 1 << 28)
             for tc in (None, 0.0, 1e-6, 1.36e-5, 1e-3)]
    for n in NS:
        ref = ref_conduit.Conduit(axis="x", transport=transport, link=link)
        got = conduit.Conduit(axis=Group(rank=0, size=n,
                                         device=torch.device("cpu")),
                              transport=transport, link=link)
        decided = {}

        def probe(x, ref=ref, decided=decided):
            for case in cases:
                decided[case] = ref.matmul_schedule(*case)
            return x

        jax.vmap(probe, axis_name="x")(jnp.zeros((n,)))
        for case in cases:
            assert got.matmul_schedule(*case) == decided[case], (n, case)


# ---------------------------------------------------------------------------
# the data axis's gradient sync under auto
# ---------------------------------------------------------------------------


def _pods(n_pod):
    rng = np.random.default_rng(17 + n_pod)
    return {"a": _rand(rng, n_pod, 1, 300), "b": _rand(rng, n_pod, 7, 100),
            "c": _rand(rng, n_pod, 1, 130)}


def _ref_sync(fn, pods, n_pod, **kw):
    mesh = jax.make_mesh((n_pod, 4 // n_pod), ("pod", "data"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cat = {k: jnp.asarray(v.reshape((-1,) + v.shape[2:]))
           for k, v in pods.items()}
    synced, res = jax.jit(functools.partial(fn, mesh=mesh, axis="pod",
                                            **kw))(cat)
    return ({k: np.asarray(v).reshape(pods[k].shape)
             for k, v in synced.items()},
            {k: np.asarray(v).reshape(pods[k].shape)
             for k, v in res.items()})


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("n_pod", [2, 4])
def test_cross_pod_auto_matches_reference(pools, n_pod, compressed,
                                          bucketed):
    """A world of ``n_pod`` ranks is the data line: each rank passes its
    pod's gradients; the reference's pods are an ``("pod", "data")`` mesh
    of its 4 devices.  Within 1e-6 (the reference sums its pods in XLA's
    order)."""
    pods = _pods(n_pod)
    kw = dict(compressed=compressed, transport="auto")
    fn = ref_grad_sync.cross_pod_all_reduce
    port_kw = dict(kw)
    if bucketed:
        fn = ref_grad_sync.bucketed_cross_pod_all_reduce
        kw["bucket_bytes"] = port_kw["bucket_bytes"] = 2048
    want = _ref_sync(fn, pods, n_pod, **kw)
    got = pools[n_pod].run(rank_tasks.cross_pod_op, pods, data=n_pod,
                           model=1, **port_kw)
    for r in got:
        p = r["coords"][0]
        for k in pods:
            np.testing.assert_allclose(r["synced"][k], want[0][k][p],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(r["ef"][k], want[1][k][p],
                                       rtol=0, atol=1e-6)
        assert r["sent_bytes"] > 0
