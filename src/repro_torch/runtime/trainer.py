"""The training loop of the port (``repro.runtime.trainer``) on a grid
of ranks.

Fault tolerance lives around the step, as in the reference:

  preemption (SIGTERM) -> the handler asks for a checkpoint at the next
                          step boundary; the loop writes it and returns
  straggler            -> a per-step wall-clock watchdog: a step slower
                          than ``straggler_factor`` × the median of the
                          trailing steps is a strike, and
                          ``straggler_patience`` strikes in a row exhaust
                          the budget (logged: re-meshing is elastic work)
  periodic             -> an atomic checkpoint every ``ckpt_interval``
                          steps and at the end (``checkpoint/``)
  restart              -> restore the latest committed checkpoint, or
                          init from ``seed`` when there is none

The data pipeline is stateless (a batch is a function of the step), so a
restored step needs nothing else.  The step is ``dist.steps``'s on the
grid (``launch/mesh.py``; a plain group is the ``1 × n`` grid, one rank
on ``cuda`` by default), so the Trainer trains every family the port
serves at tp 1: dense, MLA, MoE (every expert on the one device), ssm and
the hybrid from ``SyntheticLM`` tokens, and the VLM and the
encoder-decoder from a data source whose batches carry their
``frontend_embeds``; and a dense model over a ``data × model`` grid, a
MoE model over ``data × expert``.

Over a grid every rank runs the loop in lockstep, and every decision is
the world's: each step the ranks all-gather their step times and
preemption flags, so the watchdog sees the slowest rank's time and a
SIGTERM on any rank checkpoints and stops every rank at the same
boundary.  A checkpoint holds the logical (whole) arrays, the reference's
format: the ranks of data coordinate 0 gather their shards over their
model or expert line (``dist.sharding.unshard_tree``), world rank 0 alone
writes and commits, and a world barrier follows.  On restore every rank
reads the logical leaves and cuts its own part into the state
``build_init`` made, so a checkpoint restores onto another grid (the
one-rank run included), and either package reads what the other wrote.
The reference's elastic paths (re-meshing after a device loss, scaling
out) are ROADMAP queue 1 item 8 and raise here.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist import sharding
from repro_torch.dist.group import Group
from repro_torch.dist.steps import (
    StepConfig,
    build_init,
    build_train_step,
    group_axis,
    param_places,
    step_grid,
    tp_scheme,
)

ROADMAP_ELASTIC = ("ROADMAP queue 1 item 8 (the elastic runtime: "
                   "re-meshing after a failure, scaling out)")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 300
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_interval: int = 100
    keep_last: int = 3
    log_interval: int = 10
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    seed: int = 0


class Trainer:
    """Trains ``cfg`` on ``data`` with ``build_train_step`` over ``group``,
    a :class:`~repro_torch.dist.group.Grid` or a plain group (default: one
    rank on ``device``, ``cuda`` unless asked otherwise).  ``clock`` times
    the steps for the watchdog and the history (the checkpoints' ``ckpt_seconds`` holds
    ``(step, seconds)`` of each checkpoint written, ``restore_seconds``
    the time the last restore took (None: nothing restored), both on the
    host's clock)."""

    def __init__(self, cfg: ModelConfig, scfg: StepConfig,
                 tcfg: TrainerConfig, data: SyntheticLM,
                 group: Optional[Group] = None, *,
                 device: DeviceLike = None,
                 log_fn: Callable[[str], None] = print,
                 clock: Callable[[], float] = time.perf_counter):
        if group is None:
            group = Group(rank=0, size=1, device=resolve_device(device))
        self.grid = step_grid(cfg, group)
        self.cfg, self.scfg, self.tcfg = cfg, scfg, tcfg
        self.data = data
        self.group = self.grid.world
        self.log = log_fn
        self.ckpt_seconds: List[Tuple[int, float]] = []
        self.restore_seconds: Optional[float] = None
        self.clock = clock
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, tcfg.ckpt_interval,
                                      tcfg.keep_last)
        self._preempted = False
        self._step_times: List[float] = []
        self._straggler_strikes = 0
        self.history: List[Dict[str, float]] = []

    # -- preemption -----------------------------------------------------------

    def install_signal_handler(self):
        """SIGTERM asks for a checkpoint at the next step boundary; returns
        the handler it replaced."""
        def _handler(signum, frame):
            self._preempted = True
        return signal.signal(signal.SIGTERM, _handler)

    # -- build / restore ------------------------------------------------------

    def _places(self, params) -> Dict[Tuple, str]:
        """Each leaf of the checkpoint tree ``(params, opt)`` by its
        placement on the inner line: an optimizer leaf (``mu``, ``nu``,
        ``master``: one a parameter, in ``sharding.leaves`` order) takes
        its parameter's, AdamW's ``step`` is replicated.  The placements
        are the step's TP path's (``dist.steps.tp_scheme``); the
        checkpoint holds the logical leaves whichever it is."""
        size = self.grid.inner.size
        logical = param_places(self.cfg, size, group_axis(self.cfg),
                               tp_scheme(self.cfg, self.scfg, size))
        paths = [p for p, _ in sharding.leaves(params)]
        places = {(0,) + p: logical[p] for p in paths}
        for key in ("mu", "nu", "master"):
            for k, p in enumerate(paths):
                places[(1, key, k)] = places[(0,) + p]
        return places

    def _cut(self, places: Dict[Tuple, str]):
        """The checkpoint reader's ``cut``: this rank's part of a stored
        logical array (a copy; the whole array for a replicated leaf)."""
        inner = self.grid.inner

        def cut(path, arr):
            dim = sharding.split_dim(places.get(tuple(path), "rep"))
            if dim is None or inner.size == 1:
                return arr
            step = arr.shape[dim] // inner.size
            idx = [slice(None)] * arr.ndim
            idx[dim] = slice(inner.rank * step, (inner.rank + 1) * step)
            return arr[tuple(idx)]

        return cut

    def _restore_or_init(self):
        self.step_fn = build_train_step(self.cfg, self.grid, self.scfg)
        params, opt = build_init(self.cfg, self.grid, self.scfg)(
            self.tcfg.seed)
        t0 = time.perf_counter()
        got = self.ckpt.restore_or_none(
            (params, opt), cut=self._cut(self._places(params)), into=True)
        if got is None:
            return params, opt, 0
        (params, opt), manifest = got
        if self.grid.device.type == "cuda":
            torch.cuda.synchronize(self.grid.device)
        self.restore_seconds = time.perf_counter() - t0
        start = manifest["step"]
        self.log(f"[trainer] restored step {start} from "
                 f"{self.ckpt.directory}")
        return params, opt, start

    def _save(self, step: int, params, opt, extra) -> str:
        """Write the logical checkpoint of ``(params, opt)`` at ``step``:
        the ranks of data coordinate 0 gather it over their inner line,
        world rank 0 writes and commits it (and returns its path; the
        other ranks None), a world barrier follows."""
        world, inner = self.grid.world, self.grid.inner
        path = None
        t0 = time.perf_counter()
        tree = None
        if inner.size == 1:
            tree = (params, opt)
        elif self.grid.coords[0] == 0:
            tree = sharding.unshard_tree(
                (params, opt), inner,
                place_of=self._places(params).__getitem__)
        if world.rank == 0:
            path = self.ckpt.save(step, tree, extra=extra)
        del tree
        if world.size > 1:
            world.barrier()
        self.ckpt_seconds.append((step, time.perf_counter() - t0))
        return path

    def _agree(self, dt: float) -> Tuple[float, bool]:
        """(The slowest rank's step time, whether any rank was asked to
        stop): every rank's decisions are the world's."""
        world = self.grid.world
        if world.size == 1:
            return dt, self._preempted
        mine = torch.tensor([[dt, float(self._preempted)]],
                            dtype=torch.float64)
        every = world.all_gather(mine, 0)
        return float(every[:, 0].max()), bool(every[:, 1].max() > 0)

    # -- straggler watchdog ---------------------------------------------------

    def _watch_step_time(self, dt: float) -> bool:
        """True when the straggler budget is exhausted."""
        self._step_times.append(dt)
        window = self._step_times[-50:]
        if len(window) < 5:
            return False
        med = statistics.median(window[:-1])
        if dt > self.tcfg.straggler_factor * med:
            self._straggler_strikes += 1
            self.log(f"[watchdog] slow step {dt*1e3:.1f} ms vs median "
                     f"{med*1e3:.1f} ms (strike {self._straggler_strikes})")
        else:
            self._straggler_strikes = 0
        return self._straggler_strikes >= self.tcfg.straggler_patience

    # -- main loop ------------------------------------------------------------

    def train(self, on_step: Optional[Callable[[int, Dict[str, float]],
                                               None]] = None):
        """Run to ``total_steps`` from the latest checkpoint (or step 0);
        returns (params, opt, step).  ``on_step(step, metrics)`` runs after
        each step, before the ranks agree on its time (``step_time_s`` is
        this rank's until then) and on stopping, and before its
        checkpoint."""
        params, opt, step = self._restore_or_init()
        dev = self.grid.device
        while step < self.tcfg.total_steps:
            batch = self.data.global_batch(step)
            t0 = self.clock()
            params, opt, metrics = self.step_fn(params, opt, batch, step)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)     # the whole step, AdamW too
            dt = self.clock() - t0

            step += 1
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["step_time_s"] = dt
            self.history.append(m)
            if on_step:
                on_step(step, m)
            # after on_step: a SIGTERM that arrived by now stops every rank
            # here, one that arrives later at the next boundary
            dt, preempted = self._agree(dt)
            m["step_time_s"] = dt
            if step % self.tcfg.log_interval == 0:
                self.log(f"[trainer] step {step} loss {m['loss']:.4f} "
                         f"ce {m['ce']:.4f} gnorm {m['grad_norm']:.2f} "
                         f"lr {m['lr']:.2e} {dt*1e3:.0f} ms")

            if self._watch_step_time(dt):
                self.log("[watchdog] straggler budget exhausted — would "
                         "trigger elastic re-mesh on a real deployment")
                self._straggler_strikes = 0

            if self.ckpt.should_save(step) or preempted:
                path = self._save(step, params, opt, {"loss": m["loss"]})
                self.log(f"[trainer] checkpoint -> {path}")
                if preempted:
                    self.log("[trainer] preemption checkpoint complete; "
                             "exiting")
                    return params, opt, step

        self._save(step, params, opt,
                   {"loss": self.history[-1]["loss"] if self.history
                    else None})
        return params, opt, step

    def _recover_mesh(self, *args, **kwargs):
        raise NotImplementedError(
            f"recovery after a failure is not ported: {ROADMAP_ELASTIC}")

    def _scale_out(self, *args, **kwargs):
        raise NotImplementedError(
            f"scaling out is not ported: {ROADMAP_ELASTIC}")


__all__ = ["ROADMAP_ELASTIC", "Trainer", "TrainerConfig"]
