"""Placement of the parameters over a group: the reference's rule table
(``repro/dist/sharding.py`` ``_param_rule``) on the ``model`` axis, and
the expert split of a MoE model.

The table, by leaf name (a leaf's shape right-aligned against its rule,
as the reference aligns it against the ``lax.scan``-stacked leaf; the
port's layers are one dict each, so no leading layer axis):

  column (``(data, model)``: the last dim on ``model``):
      ``wq``, ``wk``, ``wv``, ``w_up``, ``w_gate``, ``in_proj`` and MLA's
      ``w_dq``, ``w_dkv``, ``w_uq``, ``w_uk``, ``w_uv``
  row (``(model, data)``: the second-to-last dim on ``model``):
      ``wo``, ``w_down``, ``out_proj``
  ``embed`` (V, D) ``(model, data)``: its vocab rows; ``lm_head`` (D, V)
      ``(data, model)``: its vocab columns
  ``conv_w`` (K, C) ``(None, model)``: its channels
  ``router`` ``(data, None)``, ``dec_pos`` and ``frontend_proj``
      ``(None, data)``: nothing on ``model``
  replicated: ``scale``, ``bias``, ``dt_bias``, ``a_log``, ``d_skip``,
      ``conv_b``, ``step``, scalars, and every other name
  routed experts (``w_up``/``w_gate``/``w_down`` under ``moe``, (E, ·,
      ·)): ``expert`` ahead of the pair, so the pair's ``model`` entry
      lands on dim 2 (``w_up``, ``w_gate``) or dim 1 (``w_down``)

Every entry goes through :func:`fit_axis`, the reference's
drop-don't-fail rule: an axis whose extent does not divide the dim is
dropped, and the leaf stays whole on it.  Only the ``model`` entries are
ported: the data axis keeps whole copies (DDP), where the reference
shards over it (ZeRO; ROADMAP queue 1 item 7.5c), so :func:`param_spec`
names ``model`` alone (a routed expert's leading ``expert`` entry is
left out with the ``data`` ones).

Which TP path runs changes a placement, so it is an explicit argument,
``scheme``, of every model-axis placement (:data:`SCHEMES`): ``"xla"``
is the table as it stands (the reference's GSPMD path,
``models/tp_block.py``); ``"art"`` is the table with ``wk``/``wv``
whole on every rank (the ART block, ``models/artblock.py``, projects
K/V on its local rows and ring-gathers them, as the reference's ART
runner does).  A placement is ``"col"`` (the last dim split), ``"row"``
(the second-to-last), ``"expert"`` (dim 0, the expert axis) or ``"rep"``
(whole): :func:`split_dim` gives the dim.  On a line of one rank every
leaf is whole.

The ``expert`` axis (a MoE model's group, ``models/moe_ep.py``) has a
rule of its own, the reference's ``_EXPERT_PARALLEL`` on an expert mesh:
the routed experts' ``w_up``, ``w_gate`` and ``w_down`` (a leaf whose
parent is ``moe``) shard their leading E dim, and everything else is
replicated — the router, the shared expert (``moe.shared.*``, the same
names under ``shared``), attention, norms, embed and head.  The expert
shards' gradients are complete from the exchange's backward; the
replicated leaves' are summed over the group.

:func:`shard_tree` cuts a logical tree, so it reads each leaf's shape
from the leaf; :func:`unshard_tree` is its inverse: it gathers the
ranks' parts of every leaf over the line back into the logical leaf, as
the reference's checkpoints store them, by the placement its caller
names (a shard does not say how its leaf was split).  A checkpoint holds
the logical tree, so one written under either scheme restores under the
other.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Iterator, Mapping, Optional, Tuple,
                    Union)

import torch

AxisEntry = Union[str, Tuple[str, ...], None]

COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "w_up", "w_gate", "in_proj",
    "w_dq", "w_dkv", "w_uq", "w_uk", "w_uv",
})
ROW_PARALLEL = frozenset({"wo", "w_down", "out_proj"})
REPLICATED = frozenset({
    "scale", "bias", "dt_bias", "a_log", "d_skip", "conv_b", "step",
})
#: the routed experts' stacked (E, ·, ·) weights, directly under ``moe``
EXPERT_PARALLEL = frozenset({"w_up", "w_gate", "w_down"})
#: the vocab-parallel leaves and the dim of each that holds the vocab
VOCAB_PARALLEL = {"embed": 0, "lm_head": 1}
#: the leaves the ART block keeps whole on the model axis
ART_WHOLE = frozenset({"wk", "wv"})
AXES = ("model", "expert")
#: the TP paths a model-axis placement follows
SCHEMES = ("xla", "art")

Path = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical roles of the axes (``repro.dist.sharding.MeshAxes``):
    ``data`` the data-parallel axes, ``model`` tensor parallelism,
    ``expert`` expert parallelism."""

    data: AxisEntry = "data"
    model: AxisEntry = "model"
    expert: AxisEntry = "expert"

    @staticmethod
    def names(entry: AxisEntry) -> Tuple[str, ...]:
        """An entry as a flat tuple of axis names (None → empty)."""
        if entry is None:
            return ()
        return (entry,) if isinstance(entry, str) else tuple(entry)


def fit_axis(extents: Mapping[str, int], entry: AxisEntry,
             dim: int) -> AxisEntry:
    """``entry`` if every axis it names is in ``extents`` (name → the
    axis's extent) and their product divides ``dim``; otherwise None, the
    leaf whole on it (the reference's ``fit_axis``)."""
    size = 1
    for name in MeshAxes.names(entry):
        if name not in extents:
            return None
        size *= extents[name]
    return entry if (entry is not None and size > 0
                     and dim % size == 0) else None


#: the axes' roles as the reference names them; the port places on
#: ``ROLES.model`` alone
ROLES = MeshAxes()


def param_spec(name: str, shape: Tuple[int, ...],
               size: int) -> Tuple[AxisEntry, ...]:
    """The ``model`` entries of the reference's ``_param_rule``: an entry
    a dim of a leaf named ``name`` of ``shape`` on a line of ``size``
    ranks, ``ROLES.model`` where the table splits that dim and
    :func:`fit_axis` keeps the split, else None.  The rule's ``data`` and
    ``expert`` entries are not ported (module docstring)."""
    m = ROLES.model
    if name in REPLICATED or len(shape) == 0:
        return (None,) * len(shape)
    if name == "embed" or name in ROW_PARALLEL:
        base: Tuple[AxisEntry, ...] = (m, None)
    elif name in ("lm_head", "conv_w") or name in COL_PARALLEL:
        base = (None, m)
    else:       # router, dec_pos, frontend_proj: nothing on model
        return (None,) * len(shape)
    k = min(len(base), len(shape))
    base, tail = base[len(base) - k:], shape[len(shape) - k:]
    return ((None,) * (len(shape) - k)
            + tuple(fit_axis({m: size}, e, n) for e, n in zip(base, tail)))


def placement(path: Path, axis: str = "model",
              shape: Optional[Tuple[int, ...]] = None,
              size: Optional[int] = None, *,
              scheme: Optional[str] = None) -> str:
    """The leaf at ``path``'s placement over the group: on the ``model``
    axis the table's (module docstring) for the logical leaf's ``shape``
    on a line of ``size`` ranks under the TP path ``scheme``, all three
    required; on the ``expert`` axis ``"expert"`` (dim 0 split) or
    ``"rep"``, from the path alone."""
    if axis not in AXES:
        raise ValueError(f"axis {axis!r} not in {AXES}")
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    if axis == "expert":
        return ("expert" if name in EXPERT_PARALLEL and parent == "moe"
                else "rep")
    if shape is None or size is None:
        raise ValueError(f"the placement of {name!r} needs the logical "
                         f"leaf's shape and the line's extent (the "
                         f"divisibility fallback)")
    if scheme not in SCHEMES:
        raise ValueError(f"the placement of {name!r} needs the TP path's "
                         f"scheme, one of {SCHEMES} (got {scheme!r})")
    if size == 1 or (scheme == "art" and name in ART_WHOLE):
        return "rep"
    spec = param_spec(str(name), tuple(shape), size)
    dims = [i for i, e in enumerate(spec) if e is not None]
    if not dims:
        return "rep"
    if dims[0] == len(shape) - 1:
        return "col"
    if dims[0] == len(shape) - 2:
        return "row"
    raise ValueError(f"{name!r} {tuple(shape)}: model on dim {dims[0]}")


def split_dim(place: str) -> Optional[int]:
    """The dim a placement splits (None: replicated): ``col`` the last,
    ``row`` the second-to-last, ``expert`` the first."""
    return {"rep": None, "col": -1, "row": -2, "expert": 0}[place]


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


def shard_tree(tree: Any, rank: int, size: int, axis: str = "model", *,
               scheme: Optional[str] = None) -> Any:
    """Every leaf of a full parameter tree replaced by this rank's part
    under ``axis``'s placement (on the ``model`` axis under ``scheme``'s
    TP path).  A subtree (one layer's dict) is placed by the path inside
    it, which ends as the full tree's does."""
    return map_leaves(
        lambda p, t: shard_leaf(t, placement(p, axis, tuple(t.shape), size,
                                             scheme=scheme), rank, size),
        tree)


def unshard_tree(tree: Any, group, axis: str = "model", root: int = 0,
                 place_of: Optional[Callable[[Path], str]] = None) -> Any:
    """The inverse of :func:`shard_tree`: every leaf of this rank's part
    of a tree gathered over ``group`` (the model or expert line, every
    rank of it calling) into the logical leaf, in host memory on rank
    ``root`` of the line; the other ranks get None.  ``place_of(path)``
    names a leaf's placement (default :func:`placement` on ``axis``, which
    raises for the vocab leaves: a tree that holds them needs the
    placement of its logical leaves, ``dist.steps.param_places``; an
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


__all__ = ["ART_WHOLE", "AXES", "COL_PARALLEL", "EXPERT_PARALLEL",
           "MeshAxes", "REPLICATED", "ROLES", "ROW_PARALLEL", "SCHEMES",
           "VOCAB_PARALLEL", "fit_axis", "leaves", "map_leaves",
           "param_spec", "placement", "shard_leaf", "shard_tree",
           "split_dim", "unshard_tree"]
