"""The training loop of the port (``repro.runtime.trainer``) on one group.

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
restored step needs nothing else.  The step is ``dist.steps``'s, so the
Trainer trains every family the port serves at tp 1: dense, MLA, MoE
(every expert on the one device), ssm and the hybrid from ``SyntheticLM``
tokens, and the VLM and the encoder-decoder from a data source whose
batches carry their ``frontend_embeds``.  The reference's elastic paths
(re-meshing after a device loss, scaling out) are ROADMAP queue 1 item 8
and raise here.  The group stands in for the reference's mesh: one rank
on ``cuda`` by default; a TP group's checkpoints (one shard a rank) are
item 7.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.group import Group
from repro_torch.dist.steps import StepConfig, build_init, build_train_step

ROADMAP_ELASTIC = ("ROADMAP queue 1 item 8 (the elastic runtime: "
                   "re-meshing after a failure, scaling out)")
ROADMAP_TP_CKPT = ("ROADMAP queue 1 item 7 (distributed steps: a TP "
                   "group's sharded checkpoints)")


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
    """Trains ``cfg`` on ``data`` with ``build_train_step`` over ``group``
    (default: one rank on ``device``, ``cuda`` unless asked otherwise).
    ``clock`` times the steps for the watchdog and the history."""

    def __init__(self, cfg: ModelConfig, scfg: StepConfig,
                 tcfg: TrainerConfig, data: SyntheticLM,
                 group: Optional[Group] = None, *,
                 device: DeviceLike = None,
                 log_fn: Callable[[str], None] = print,
                 clock: Callable[[], float] = time.perf_counter):
        if group is None:
            group = Group(rank=0, size=1, device=resolve_device(device))
        if group.size != 1:
            raise NotImplementedError(
                f"the Trainer over a group of {group.size} ranks is not "
                f"ported: {ROADMAP_TP_CKPT}")
        self.cfg, self.scfg, self.tcfg = cfg, scfg, tcfg
        self.data = data
        self.group = group
        self.log = log_fn
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

    def _restore_or_init(self):
        self.step_fn = build_train_step(self.cfg, self.group, self.scfg)
        params, opt = build_init(self.cfg, self.group, self.scfg)(
            self.tcfg.seed)
        got = self.ckpt.restore_or_none((params, opt),
                                        device=self.group.device)
        if got is None:
            return params, opt, 0
        (params, opt), manifest = got
        start = manifest["step"]
        self.log(f"[trainer] restored step {start} from "
                 f"{self.ckpt.directory}")
        return params, opt, start

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
        each step, before its checkpoint."""
        params, opt, step = self._restore_or_init()
        dev = self.group.device
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
            if step % self.tcfg.log_interval == 0:
                self.log(f"[trainer] step {step} loss {m['loss']:.4f} "
                         f"ce {m['ce']:.4f} gnorm {m['grad_norm']:.2f} "
                         f"lr {m['lr']:.2e} {dt*1e3:.0f} ms")

            if self._watch_step_time(dt):
                self.log("[watchdog] straggler budget exhausted — would "
                         "trigger elastic re-mesh on a real deployment")
                self._straggler_strikes = 0

            if self.ckpt.should_save(step) or self._preempted:
                path = self.ckpt.save(step, (params, opt),
                                      extra={"loss": m["loss"]})
                self.log(f"[trainer] checkpoint -> {path}")
                if self._preempted:
                    self.log("[trainer] preemption checkpoint complete; "
                             "exiting")
                    return params, opt, step

        self.ckpt.save(step, (params, opt),
                       extra={"loss": self.history[-1]["loss"]
                              if self.history else None})
        return params, opt, step

    def _recover_mesh(self, *args, **kwargs):
        raise NotImplementedError(
            f"recovery after a failure is not ported: {ROADMAP_ELASTIC}")

    def _scale_out(self, *args, **kwargs):
        raise NotImplementedError(
            f"scaling out is not ported: {ROADMAP_ELASTIC}")


__all__ = ["ROADMAP_ELASTIC", "Trainer", "TrainerConfig"]
