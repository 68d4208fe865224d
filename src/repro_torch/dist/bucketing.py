"""Size-targeted gradient buckets (``repro.dist.bucketing``): the layout
the microbatch accumulation of ``dist/steps.py`` sums into and the data
axis's bucketed sync (``dist/grad_sync.py``) ships.

A plan puts whole leaves, in flatten order (``dist.sharding.leaves``:
dict keys sorted, lists in order, the reference's pytree order), into
buckets of at most ``target_bytes`` measured at ``itemsize`` bytes an
element.  A leaf is never split, and a bucket is a contiguous run of
leaves, so pack → elementwise op → unpack touches every element once:
accumulating into the buckets gives the bits of accumulating leaf by
leaf.  The bucketed sync over a data axis (``dist/grad_sync.py``) is
ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import dtype_of
from repro_torch.dist.sharding import Path, leaves

#: the reference's default bucket target
DEFAULT_BUCKET_BYTES = 4 << 20


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """A static partition of a tree's leaves into size-targeted buckets:
    shapes and dtypes only, no tensors.  ``paths`` are the leaves' tree
    paths in flatten order (what :func:`unpack` rebuilds the tree from);
    ``leaf_dtypes`` are dtype names as the reference writes them
    (``"float32"``, ``"bfloat16"``)."""

    paths: Tuple[Path, ...]
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[str, ...]
    buckets: Tuple[Tuple[int, ...], ...]   # leaf indices per bucket

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    def leaf_elements(self, i: int) -> int:
        """Element count of leaf ``i`` (flatten order)."""
        return math.prod(self.leaf_shapes[i])

    def bucket_elements(self) -> Tuple[int, ...]:
        """Per-bucket element counts: the sizes of :func:`pack`'s buffers."""
        return tuple(sum(self.leaf_elements(i) for i in b)
                     for b in self.buckets)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def bucket_plan(tree: Any, *, target_bytes: int = DEFAULT_BUCKET_BYTES,
                itemsize: int = 4) -> BucketPlan:
    """Greedy-fill whole leaves (flatten order) into buckets of at most
    ``target_bytes``; a leaf larger than the target gets a bucket of its
    own.  Only the leaves' shapes and dtypes are read.  ``itemsize`` is
    the element size the target is measured in (4: the fp32 accumulation,
    whatever each leaf's own dtype)."""
    flat = list(leaves(tree))
    if not flat:
        return BucketPlan((), (), (), ())
    buckets: List[Tuple[int, ...]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, (_, leaf) in enumerate(flat):
        nbytes = math.prod(leaf.shape) * itemsize
        if cur and cur_bytes + nbytes > target_bytes:
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    buckets.append(tuple(cur))
    return BucketPlan(
        tuple(p for p, _ in flat),
        tuple(tuple(leaf.shape) for _, leaf in flat),
        tuple(_dtype_name(leaf.dtype) for _, leaf in flat),
        tuple(buckets))


def span_scaled_target(target_bytes: int, old_span: int,
                       new_span: int) -> int:
    """The bucket target re-fitted to a changed sync span: a ring
    all-reduce of a ``target_bytes`` bucket over ``n`` ranks puts
    ``target/n`` bytes on each hop, so holding the per-hop message when the
    data axis goes from ``old_span`` to ``new_span`` ranks scales the
    target by ``new_span / old_span`` (floored, at least 1)."""
    if old_span < 1 or new_span < 1:
        raise ValueError(f"spans must be >= 1 ({old_span} -> {new_span})")
    return max(1, int(target_bytes) * int(new_span) // int(old_span))


def pack(tree: Any, plan: BucketPlan,
         dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """``tree``'s leaves in the plan's buckets: one 1-D ``dtype`` buffer a
    bucket, the leaves raveled and concatenated in flatten order."""
    flat = [t for _, t in leaves(tree)]
    if len(flat) != len(plan.paths):
        raise ValueError(f"tree has {len(flat)} leaves, the plan "
                         f"{len(plan.paths)}")
    return [torch.cat([flat[i].to(dtype).reshape(-1) for i in bucket])
            for bucket in plan.buckets]


def _unflatten(paths: Sequence[Path], values: Sequence[Any]) -> Any:
    """The tree whose leaves at ``paths`` are ``values``: a string key
    makes a dict, an index a list."""
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    groups: dict = {}
    for path, v in zip(paths, values):
        groups.setdefault(path[0], []).append((path[1:], v))
    sub = {k: _unflatten([p for p, _ in g], [v for _, v in g])
           for k, g in groups.items()}
    if all(isinstance(k, int) for k in sub):
        return [sub[i] for i in range(len(sub))]
    return sub


def unpack(buffers: Sequence[torch.Tensor], plan: BucketPlan,
           dtype: Optional[torch.dtype] = None) -> Any:
    """Invert :func:`pack`: slice each buffer back into its leaves (views,
    reshaped) and rebuild the tree.  ``dtype`` casts every leaf; ``None``
    restores each leaf's recorded dtype."""
    out: List[Any] = [None] * len(plan.paths)
    for buf, bucket in zip(buffers, plan.buckets):
        off = 0
        for i in bucket:
            n = plan.leaf_elements(i)
            leaf = buf[off:off + n].view(plan.leaf_shapes[i])
            out[i] = leaf.to(dtype or dtype_of(plan.leaf_dtypes[i]))
            off += n
    return _unflatten(plan.paths, out)


__all__ = ["DEFAULT_BUCKET_BYTES", "BucketPlan", "bucket_plan", "pack",
           "span_scaled_target", "unpack"]
