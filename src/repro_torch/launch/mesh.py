"""Grids of rank processes (``repro.launch.mesh``).

The reference lays its host devices out as a ``jax.make_mesh`` of axes
``("data", "model")``, or with ``expert`` > 1 ``("data", "model",
"expert")``.  The port's ranks are processes of a
:class:`~repro_torch.dist.group.RankPool`, one gloo world, and a grid is
each rank's :class:`~repro_torch.dist.group.Grid` over it: its
coordinates, the world, and one process group for each axis line it lies
on.  Axis semantics are the reference's:

  ``data``   — data parallelism: each line holds whole copies of the
               parameters and the optimizer state, and sums its ranks'
               gradients (``dist/grad_sync.py``)
  ``model``  — TP: the dense blocks' weights split over the line, the
               fused ring at their edges (``models/artblock.py``)
  ``expert`` — a MoE model's experts split over the line, its tokens
               through the conduit all-to-all (``models/moe_ep.py``)
"""

from __future__ import annotations

from repro_torch.dist.group import Grid, Group, grid_lines


def check_axes(data: int = 1, model: int = 1, expert: int = 1) -> None:
    """Raise unless the port takes a grid of these extents.  A grid with
    both a model and an expert axis raises: the reference runs its EP
    region over the whole mesh and regathers the experts from their data
    × model placement, which is ROADMAP queue 1 item 7.5 (sharding
    rules)."""
    if min(data, model, expert) < 1:
        raise ValueError(f"axis extents must be >= 1: data {data}, model "
                         f"{model}, expert {expert}")
    if model > 1 and expert > 1:
        raise NotImplementedError(
            f"a grid with model {model} and expert {expert} > 1 is not "
            f"ported: ROADMAP queue 1 item 7.5 (sharding rules)")


def make_host_mesh(world: Group, data: int = 1, model: int = 1,
                   expert: int = 1) -> Grid:
    """This rank's grid of ``data × model`` (or ``data × expert``) ranks
    over ``world`` (every rank of the world calls it, in the same order;
    :func:`check_axes` first)."""
    check_axes(data, model, expert)
    if expert > 1:
        return grid_lines(world, ("data", "expert"), (data, expert))
    return grid_lines(world, ("data", "model"), (data, model))


__all__ = ["check_axes", "make_host_mesh"]
