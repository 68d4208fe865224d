"""The port's data-axis gradient sync against the reference's.

* ``optim/compress.py``: ``compress_8bit``'s int8 payload and scales
  bitwise equal to the reference's on seeded inputs (a padded tail, an
  all-zero block, ties at .5), ``decompress_8bit`` and
  ``ef_compress_update`` bitwise, ``compressed_bytes``;
* ``dist/bucketing.span_scaled_target`` and ``grad_sync``'s byte
  accounting against the reference's;
* ``cross_pod_all_reduce`` and ``bucketed_cross_pod_all_reduce`` on the
  outer line of a 2 × 2 gloo world of CPU ranks (``make_host_mesh(2,
  2)``), against the reference's on a ``("pod", "data")`` 2 × 2 host
  mesh: uncompressed within 1e-6, compressed within 1e-6 of the
  reference's and inside the reference test's bound (|mean error| ≤ 2 ×
  scale, |residual| ≤ scale, scale = max|g| / 127), bucketed streamed ≡
  bulk bit for bit, an outstanding residual flushed into the lossless
  path, and the bytes each rank sent on the ring: int8 payloads plus
  scales against fp32, exactly as ``bucket_wire_bytes`` reckons.

One 4-rank gloo world for the module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import bucketing as ref_bucketing
from repro.dist import grad_sync as ref_grad_sync
from repro.optim import compress as ref_compress
from repro_torch.bridge import to_tensor
from repro_torch.dist import bucketing, grad_sync, rank_tasks
from repro_torch.dist.group import RankPool
from repro_torch.optim import compress

N_POD = 2
BUCKET = 2048


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, device="cpu") as p:
        yield p


def _seeded(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,block", [((1000,), 256), ((7, 100), 256),
                                         ((3, 5), 4), ((512,), 128)])
def test_compress_8bit_bitwise(shape, block):
    x = _seeded(shape, 1)
    x.reshape(-1)[:block] = 0.0                 # an all-zero block
    x.reshape(-1)[block:block + 3] = [127.0, 63.5, -0.5]  # ties at .5
    q, s = compress.compress_8bit(to_tensor(x), block)
    rq, rs = ref_compress.compress_8bit(jnp.asarray(x), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        compress.decompress_8bit(q, s, shape, block).numpy(),
        np.asarray(ref_compress.decompress_8bit(rq, rs, shape, block)))
    n = int(np.prod(shape))
    assert compress.compressed_bytes(n, block) == \
        ref_compress.compressed_bytes(n, block)


def test_ef_compress_update_bitwise():
    gs = [_seeded((300,), 2), _seeded((7, 40), 3)]
    es = [_seeded((300,), 4) * 1e-3, _seeded((7, 40), 5) * 1e-3]
    out, res = compress.ef_compress_update(
        [to_tensor(g) for g in gs], [to_tensor(e) for e in es], block=64)
    r_out, r_res = ref_compress.ef_compress_update(
        [jnp.asarray(g) for g in gs], [jnp.asarray(e) for e in es],
        block=64)
    for a, b in zip(out + res, list(r_out) + list(r_res)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    zeros = compress.ef_init([to_tensor(g) for g in gs])
    assert all(z.dtype == torch.float32 and z.shape == g.shape
               and not z.any() for z, g in zip(zeros, gs))


@pytest.mark.parametrize("target,old,new", [(4 << 20, 4, 2), (4 << 20, 2, 4),
                                            (1000, 3, 2), (5, 8, 1),
                                            (1, 4, 1)])
def test_span_scaled_target(target, old, new):
    assert bucketing.span_scaled_target(target, old, new) == \
        ref_bucketing.span_scaled_target(target, old, new)
    with pytest.raises(ValueError):
        bucketing.span_scaled_target(target, 0, new)


def test_wire_bytes_match_reference():
    elems = (1, 255, 256, 257, 100_000)
    for comp in (False, True):
        assert grad_sync.bucket_wire_bytes(elems, compressed=comp) == \
            ref_grad_sync.bucket_wire_bytes(elems, compressed=comp)
        assert grad_sync.wire_bytes(1 << 20, compressed=comp) == \
            ref_grad_sync.wire_bytes(1 << 20, compressed=comp)


# ---------------------------------------------------------------------------
# the sync over a line of the grid, against the reference's pod axis
# ---------------------------------------------------------------------------


def _pods():
    """Per-pod gradients: leaf k is (N_POD, rows, ...), pod p's part
    ``[p]``; the reference's input is the parts stacked on dim 0."""
    return {"a": _seeded((N_POD, 1, 300), 7),
            "b": _seeded((N_POD, 7, 100), 8),
            "c": _seeded((N_POD, 1, 130), 9)}


def _podmesh():
    return jax.make_mesh((N_POD, 2), ("pod", "data"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _reference(fn, pods, ef=None, **kw):
    """The reference's (synced, ef) as pod parts: leaf k (N_POD, ...),
    jitted, on its ``xla`` transport (which the reference holds equal in
    value to ``ring``)."""
    def cat(tree):
        return {k: jnp.asarray(v.reshape((-1,) + v.shape[2:]))
                for k, v in tree.items()}

    kw["transport"] = "xla"
    bound = functools.partial(fn, mesh=_podmesh(), axis="pod", **kw)
    if ef is None:
        synced, res = jax.jit(bound)(cat(pods))
    else:
        synced, res = jax.jit(lambda g, e: bound(g, ef=e))(cat(pods),
                                                          cat(ef))
    return ({k: np.asarray(v).reshape(pods[k].shape)
             for k, v in synced.items()},
            {k: np.asarray(v).reshape(pods[k].shape)
             for k, v in res.items()})


def _port(pool, pods, **kw):
    res = pool.run(rank_tasks.cross_pod_op, pods, data=N_POD, model=2, **kw)
    # world rank r at row-major (r // 2, r % 2), as jax.make_mesh lays out
    # the reference's devices
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    return res


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("compressed", [False, True])
def test_cross_pod_all_reduce_matches_reference(pool, compressed, bucketed):
    pods = _pods()
    kw = dict(compressed=compressed, transport="ring")
    if bucketed:
        want = _reference(ref_grad_sync.bucketed_cross_pod_all_reduce, pods,
                          bucket_bytes=BUCKET, **kw)
        got = _port(pool, pods, bucket_bytes=BUCKET, **kw)
    else:
        want = _reference(ref_grad_sync.cross_pod_all_reduce, pods, **kw)
        got = _port(pool, pods, **kw)
    mean = {k: v.mean(0) for k, v in pods.items()}
    for r in got:
        p = r["coords"][0]
        for k in pods:
            np.testing.assert_allclose(r["synced"][k], want[0][k][p],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(r["ef"][k], want[1][k][p],
                                       rtol=0, atol=1e-6)
            if compressed:
                scale = np.abs(pods[k]).max() / 127
                assert np.abs(r["synced"][k] - mean[k]).max() <= \
                    2 * scale + 1e-6
                assert np.abs(r["ef"][k]).max() <= scale + 1e-6
            else:
                np.testing.assert_allclose(r["synced"][k], mean[k],
                                           rtol=1e-6, atol=1e-6)
                assert not r["ef"][k].any()


def test_bucketed_streamed_equals_bulk_and_flushes(pool):
    pods = _pods()
    ef = {k: _seeded(v.shape, 11) * 1e-2 for k, v in pods.items()}
    runs = {}
    for compressed in (False, True):
        runs[compressed] = [
            _port(pool, pods, compressed=compressed, bucket_bytes=BUCKET,
                  streamed=streamed, ef=ef) for streamed in (True, False)]
        for a, b in zip(*runs[compressed]):
            for k in pods:
                np.testing.assert_array_equal(a["synced"][k], b["synced"][k])
                np.testing.assert_array_equal(a["ef"][k], b["ef"][k])
    # the uncompressed path flushes the residual into the exact mean
    want = {k: (pods[k] + ef[k]).mean(0) for k in pods}
    for r in runs[False][0]:
        for k in pods:
            np.testing.assert_allclose(r["synced"][k], want[k], rtol=1e-6,
                                       atol=1e-6)
            assert not r["ef"][k].any()
    ref = _reference(ref_grad_sync.bucketed_cross_pod_all_reduce, pods, ef,
                     bucket_bytes=BUCKET, compressed=True, transport="ring")
    for r in runs[True][0]:
        for k in pods:
            np.testing.assert_allclose(r["synced"][k],
                                       ref[0][k][r["coords"][0]], atol=1e-6)


def test_int8_on_the_wire(pool):
    """The ring's hops carry int8 payloads and fp32 scales: what each rank
    sends is ``bucket_wire_bytes`` of the plan's buckets, compressed or
    not (an all-gather of n = 2 sends each payload once; a ring
    all-reduce half of it twice)."""
    pods = _pods()
    plan = bucketing.bucket_plan(
        {k: to_tensor(v[0]) for k, v in pods.items()}, target_bytes=BUCKET)
    elems = plan.bucket_elements()
    assert all(n % N_POD == 0 for n in elems)
    sent = {}
    for compressed in (False, True):
        res = _port(pool, pods, compressed=compressed, bucket_bytes=BUCKET)
        sent[compressed] = {r["sent_bytes"] for r in res}
        assert sent[compressed] == {sum(grad_sync.bucket_wire_bytes(
            elems, compressed=compressed))}
    ratio = sent[True].pop() / sent[False].pop()
    want = (sum(ref_grad_sync.bucket_wire_bytes(elems, compressed=True))
            / sum(ref_grad_sync.bucket_wire_bytes(elems)))
    assert ratio == want < 0.5


def test_one_rank_returns_its_input():
    from repro_torch.dist.group import Group

    g = {"w": to_tensor(_seeded((4, 3), 12))}
    solo = Group(rank=0, size=1, device=torch.device("cpu"))
    for fn in (grad_sync.cross_pod_all_reduce,
               grad_sync.bucketed_cross_pod_all_reduce):
        synced, ef = fn(g, solo, compressed=True)
        assert synced is g and not ef["w"].any()
