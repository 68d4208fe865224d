"""Gradient sync over the data axis (``repro.dist.grad_sync``), through a
selectable conduit transport.

The reference reduces per-pod gradients over its ``pod`` mesh axis inside
a ``shard_map``; the port has no ``shard_map``, so each function here
takes the line's :class:`~repro_torch.dist.group.Group` (a grid's data
line, ``launch/mesh.py``) where the reference takes ``(mesh, axis,
specs)``, and each rank passes its own gradients.  The contract is the
reference's: per-rank gradients in, ``(mean over the line, error-feedback
residuals)`` out, on every rank of the line.

* uncompressed — the train step's exact path, :func:`mean_leaves` or
  :func:`mean_buckets`: ``conduit.all_reduce`` (``ring`` by default: ring
  reduce-scatter then ring all-gather, ``core/conduit.py``; ``bidir``;
  ``xla``, gloo's own; or ``auto``, priced a call), then a division by n.  An outstanding residual is flushed
  into this lossless reduction, and the residuals come back zero;
* compressed — :class:`Int8Conduit`: each rank quantizes its
  (error-feedback-corrected) gradient to int8 with per-block fp32 scales
  (``optim/compress.py``), the int8 payloads and the scales ride the base
  conduit's all-gather, and every rank dequantizes and averages what
  arrived.  ``Group.stats["sent_bytes"]`` counts the int8 payloads on the
  ring's hops, ~1/4 of the fp32 bytes (:func:`bucket_wire_bytes`).

:func:`bucketed_cross_pod_all_reduce` packs the leaves into size-targeted
buckets (``dist/bucketing.py``) and reduces a bucket at a time; with
``streamed=True`` on ``core/pipeline.streamed`` (bucket k issued while
bucket k−1 is consumed), with ``streamed=False`` bulk-synchronously:
the same calls in the same order per element, so the same bits.

The train step (``dist/steps.py``) calls the exact path directly:
:func:`mean_leaves`, or :func:`mean_buckets` on the step's own buckets,
its gradients already fp32 and no residual to flush.  The step does not compress, as the reference's does not (its
scope note: per-pod gradients inside its GSPMD step need a
partial-manual ``shard_map`` its toolchain rejects); compression is the
standalone functions'.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import pipeline as pl
from repro_torch.core.conduit import Conduit
from repro_torch.dist import bucketing
from repro_torch.dist.sharding import leaves, map_leaves
from repro_torch.optim.compress import (
    compress_8bit,
    compressed_bytes,
    decompress_8bit,
)


def bucket_wire_bytes(bucket_elements: Sequence[int], *,
                      compressed: bool = False,
                      block: int = 256) -> Tuple[int, ...]:
    """Wire bytes of each bucket (per hop direction): fp32, or int8 plus
    fp32 per-``block`` scales when compressed.  Padding and scales accrue
    per bucket, since each bucket is quantized as one tensor."""
    if not compressed:
        return tuple(4 * int(n) for n in bucket_elements)
    return tuple(compressed_bytes(int(n), block) for n in bucket_elements)


def wire_bytes(n_elements: int, *, compressed: bool = False,
               block: int = 256) -> int:
    """:func:`bucket_wire_bytes` of one tensor."""
    return bucket_wire_bytes((n_elements,), compressed=compressed,
                             block=block)[0]


@dataclasses.dataclass(frozen=True)
class Int8Conduit:
    """A conduit with error-feedback int8 on the wire: quantize locally,
    all-gather the int8 payloads and scales over ``base``, dequantize and
    average at every receiver."""

    base: Conduit
    block: int = 256

    def all_reduce_mean_ef(self, g: torch.Tensor, e: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean over the line of Q(g + e), the new residual)."""
        n = self.base.axis.size
        corrected = g.float() + e
        q, scale = compress_8bit(corrected, self.block)
        q_all = self.base.all_gather(q[None])          # (n, padded)
        s_all = self.base.all_gather(scale[None])      # (n, n_blocks)
        synced = _dequant_mean(q_all, s_all, g.shape, self.block, n)
        ef_new = corrected - decompress_8bit(q, scale, g.shape, self.block)
        return synced.to(g.dtype), ef_new


def _dequant_mean(q_all, s_all, shape, block: int, n: int) -> torch.Tensor:
    acc = torch.zeros(tuple(shape), dtype=torch.float32,
                      device=q_all.device)
    for i in range(n):
        acc = acc + decompress_8bit(q_all[i], s_all[i], shape, block)
    return acc / n


def _mean_exact(x: torch.Tensor, conduit: Conduit, n: int) -> torch.Tensor:
    """The exact fp32 mean of ``x`` over the line (a new tensor)."""
    out = conduit.all_reduce(x)
    if out.data_ptr() == x.data_ptr():
        out = out.clone()
    return out.div_(n)


def _zeros_like_tree(tree: Any) -> Any:
    return map_leaves(lambda _, g: torch.zeros(
        g.shape, dtype=torch.float32, device=g.device), tree)


def _by_path(tree: Any) -> Dict[Tuple, torch.Tensor]:
    return dict(leaves(tree))


def cross_pod_all_reduce(grads: Any, group, *, compressed: bool = False,
                         transport: str = "ring",
                         chunk_bytes: Optional[int] = None, ef: Any = None,
                         block: int = 256) -> Tuple[Any, Any]:
    """All-reduce-mean a tree of this rank's gradients over ``group``
    leaf by leaf through the ``transport`` conduit.  Returns ``(synced,
    residuals)``, trees shaped like ``grads``.  ``compressed`` wraps the
    conduit in :class:`Int8Conduit`; ``ef`` is the previous residuals
    (zeros when None).  A group of one returns its input."""
    if ef is None:
        ef = _zeros_like_tree(grads)
    n = group.size
    if n == 1:
        return grads, ef
    e_by = _by_path(ef)
    if not compressed:
        return _leaf_uncompressed(grads, e_by, group, transport=transport,
                                  chunk_bytes=chunk_bytes)
    int8 = Int8Conduit(Conduit(axis=group, transport=transport,
                               chunk_bytes=chunk_bytes), block=block)
    out = {path: int8.all_reduce_mean_ef(g, e_by[path])
           for path, g in leaves(grads)}
    return (map_leaves(lambda p, _: out[p][0], grads),
            map_leaves(lambda p, _: out[p][1], grads))


def _leaf_uncompressed(grads: Any, e_by: Dict[Tuple, torch.Tensor], group,
                       **conduit_kw) -> Tuple[Any, Any]:
    """Exact means over the line through :func:`mean_leaves`, each
    outstanding residual flushed into its leaf first (a compressed →
    uncompressed switch drops no gradient mass); the residuals come back
    zero."""
    paths, gs = zip(*leaves(grads))
    means = mean_leaves([g.float() + e_by[p] for p, g in zip(paths, gs)],
                        group, **conduit_kw)
    synced = {p: m.to(g.dtype) for p, g, m in zip(paths, gs, means)}
    return (map_leaves(lambda p, _: synced[p], grads),
            _zeros_like_tree(grads))


def mean_leaves(grads: List[torch.Tensor], group, *,
                transport: str = "ring",
                chunk_bytes: Optional[int] = None) -> List[torch.Tensor]:
    """The train step's exact sync, leaf by leaf: each fp32 leaf of
    ``grads`` replaced by its mean over ``group`` (no residual; each
    input leaf is released as soon as its mean is made)."""
    conduit = Conduit(axis=group, transport=transport,
                      chunk_bytes=chunk_bytes)
    for i, g in enumerate(grads):
        grads[i] = _mean_exact(g, conduit, group.size)
    return grads


def _bucket_schedule(bufs: List[Any], conduit: Conduit, n: int, *,
                     compressed: bool, block: int, streamed: bool
                     ) -> List[Any]:
    """Reduce each flat fp32 bucket of ``bufs`` over the conduit's line:
    ``(mean, residual)`` a bucket when compressed, else the mean (each
    bucket dropped from ``bufs`` once it is on the wire)."""
    if compressed:
        def issue(k):
            # quantize bucket k (compute) feeds its gathers (wire)
            q, scale = compress_8bit(bufs[k], block)
            return (q, scale, conduit.all_gather(q[None]),
                    conduit.all_gather(scale[None]))

        def consume(k, arrived):
            q, scale, q_all, s_all = arrived
            shape = bufs[k].shape
            mean = _dequant_mean(q_all, s_all, shape, block, n)
            return mean, bufs[k] - decompress_8bit(q, scale, shape, block)
    else:
        def issue(k):
            out = conduit.all_reduce(bufs[k])
            if out.data_ptr() == bufs[k].data_ptr():
                out = out.clone()
            bufs[k] = None
            return out

        def consume(k, arrived):
            return arrived.div_(n)

    if streamed:
        return pl.streamed(len(bufs), issue, consume)
    return [consume(k, issue(k)) for k in range(len(bufs))]


def mean_buckets(bufs: List[torch.Tensor], group, *,
                 transport: str = "ring", chunk_bytes: Optional[int] = None,
                 streamed: bool = True) -> List[torch.Tensor]:
    """The train step's exact sync of its flat fp32 buckets: each
    bucket's mean over ``group``, a bucket at a time (each input bucket
    is dropped from ``bufs`` once it is on the wire)."""
    conduit = Conduit(axis=group, transport=transport,
                      chunk_bytes=chunk_bytes)
    return _bucket_schedule(bufs, conduit, group.size, compressed=False,
                            block=0, streamed=streamed)


def bucketed_cross_pod_all_reduce(
        grads: Any, group, *,
        bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES,
        compressed: bool = False, transport: str = "ring",
        chunk_bytes: Optional[int] = None, ef: Any = None, block: int = 256,
        streamed: bool = True) -> Tuple[Any, Any]:
    """:func:`cross_pod_all_reduce` in size-targeted buckets: the leaves
    (each plus its residual, in fp32) packed into ``bucket_bytes``
    buckets, each bucket reduced as one tensor (compressed: quantized as
    one tensor, so the wire carries ``bucket_wire_bytes(plan.
    bucket_elements(), compressed=True)``).  ``streamed`` runs the
    buckets on ``pipeline.streamed``; either schedule gives the same
    bits.  Returns ``(synced, residuals)`` as the leaf-by-leaf form."""
    if ef is None:
        ef = _zeros_like_tree(grads)
    n = group.size
    if n == 1:
        return grads, ef
    plan = bucketing.bucket_plan(grads, target_bytes=bucket_bytes)
    e_by = _by_path(ef)
    corrected = [g.float() + e_by[p] for p, g in leaves(grads)]
    bufs = bucketing.pack(corrected, plan)
    del corrected
    if not compressed:
        # the residuals flushed into the step's exact path
        synced = _by_path(bucketing.unpack(mean_buckets(
            bufs, group, transport=transport, chunk_bytes=chunk_bytes,
            streamed=streamed), plan))
        return (map_leaves(lambda p, _: synced[p], grads),
                _zeros_like_tree(grads))
    outs = _bucket_schedule(
        bufs, Conduit(axis=group, transport=transport,
                      chunk_bytes=chunk_bytes),
        n, compressed=True, block=block, streamed=streamed)
    synced = _by_path(bucketing.unpack([o[0] for o in outs], plan))
    res = _by_path(bucketing.unpack([o[1] for o in outs], plan,
                                    torch.float32))
    return (map_leaves(lambda p, _: synced[p], grads),
            map_leaves(lambda p, _: res[p], grads))


__all__ = ["Int8Conduit", "bucket_wire_bytes", "bucketed_cross_pod_all_reduce",
           "cross_pod_all_reduce", "mean_buckets", "mean_leaves",
           "wire_bytes"]
