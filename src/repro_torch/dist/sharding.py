"""Placement of the parameters over a group: the dense block's TP split
(the ``model``-axis part of ``repro.dist.sharding``'s rule table, for this
port's TP path) and the expert split of a MoE model.

  column shards (output dim split over the group):  ``wq``, ``w_up``,
                                                     ``w_gate``
  row shards (input dim split):                      ``wo``, ``w_down``
  replicated:                                        everything else —
      ``embed``, ``lm_head``, ``wk``/``wv``, all norms

The reference makes the embedding and LM head vocab-parallel and shards
``wk``/``wv`` by column under GSPMD; here they are whole on every rank
(K/V are projected on the local rows and ring-gathered, as the reference's
ART block does).  A replicated leaf's gradient is summed over the group
before clipping; a sharded leaf's is complete already, from the fused
ops' weight gradient.

The ``expert`` axis (a MoE model's group, ``models/moe_ep.py``) has a
rule of its own, the reference's ``_EXPERT_PARALLEL`` on an expert mesh
(``repro/dist/sharding.py:101-131``): the routed experts' ``w_up``,
``w_gate`` and ``w_down`` (a leaf whose parent is ``moe``) shard their
leading E dim, and everything else is replicated — the router, the shared
expert (``moe.shared.*``, the same names under ``shared``), attention,
norms, embed and head.  The rule reads the path, since ``w_up`` under
the ``model`` axis is a column shard wherever it sits.  The expert
shards' gradients are complete from the exchange's backward; the
replicated leaves' are summed over the group.

:func:`unshard_tree` is :func:`shard_tree`'s inverse: it gathers the
ranks' parts of every leaf over the line back into the logical leaf, as
the reference's checkpoints store them.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Tuple

import torch

COL_PARALLEL = frozenset({"wq", "w_up", "w_gate"})
ROW_PARALLEL = frozenset({"wo", "w_down"})
#: the routed experts' stacked (E, ·, ·) weights, directly under ``moe``
EXPERT_PARALLEL = frozenset({"w_up", "w_gate", "w_down"})
AXES = ("model", "expert")

Path = Tuple[Any, ...]


def placement(path: Path, axis: str = "model") -> str:
    """The leaf at ``path``'s placement over the group: on the ``model``
    axis ``"col"``, ``"row"`` or ``"rep"``; on the ``expert`` axis
    ``"expert"`` (dim 0 split) or ``"rep"``."""
    if axis not in AXES:
        raise ValueError(f"axis {axis!r} not in {AXES}")
    name = path[-1]
    if axis == "expert":
        return ("expert" if name in EXPERT_PARALLEL and len(path) >= 2
                and path[-2] == "moe" else "rep")
    if name in COL_PARALLEL:
        return "col"
    if name in ROW_PARALLEL:
        return "row"
    return "rep"


def split_dim(place: str) -> Optional[int]:
    """The dim a placement splits (None: replicated)."""
    if place == "rep":
        return None
    return 1 if place == "col" else 0


def shard_leaf(t: torch.Tensor, place: str, rank: int,
               size: int) -> torch.Tensor:
    """This rank's part of a full leaf, as its own contiguous tensor."""
    dim = split_dim(place)
    if dim is None:
        return t
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {size} ranks")
    step = n // size
    # a copy, never a view: a view would keep the whole leaf alive
    return t.narrow(dim, rank * step, step).clone(
        memory_format=torch.contiguous_format)


def leaves(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def map_leaves(fn: Callable[[Path, torch.Tensor], torch.Tensor], tree: Any,
               path: Path = ()) -> Any:
    """The tree with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_tree(tree: Any, rank: int, size: int,
               axis: str = "model") -> Any:
    """Every leaf of a full parameter tree replaced by this rank's part
    under ``axis``'s placement.  A subtree (one layer's dict) is placed
    by the path inside it, which ends as the full tree's does."""
    return map_leaves(
        lambda p, t: shard_leaf(t, placement(p, axis), rank, size), tree)


def unshard_tree(tree: Any, group, axis: str = "model", root: int = 0,
                 place_of: Optional[Callable[[Path], str]] = None) -> Any:
    """The inverse of :func:`shard_tree`: every leaf of this rank's part
    of a tree gathered over ``group`` (the model or expert line, every
    rank of it calling) into the logical leaf, in host memory on rank
    ``root`` of the line; the other ranks get None.  ``place_of(path)``
    names a leaf's placement (default :func:`placement` on ``axis``; an
    optimizer state's leaves take their parameter's).  A number leaf
    comes back as it is."""
    place_of = place_of or (lambda p: placement(p, axis))

    def gather(path, t):
        if not isinstance(t, torch.Tensor):
            return t if group.rank == root else None
        dim = split_dim(place_of(path))
        if dim is None or group.size == 1:
            return t.detach().cpu() if group.rank == root else None
        return group.gather(t, dim, root)

    out = map_leaves(gather, tree)
    return out if group.rank == root else None


__all__ = ["AXES", "COL_PARALLEL", "EXPERT_PARALLEL", "ROW_PARALLEL",
           "leaves", "map_leaves", "placement", "shard_leaf", "shard_tree",
           "split_dim", "unshard_tree"]
