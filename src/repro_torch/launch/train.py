"""Training launcher of the port: ``python -m repro_torch.launch.train``.

Trains one model on one device through :class:`~repro_torch.runtime.
trainer.Trainer` with checkpoints, preemption handling and the straggler
watchdog.  ``--arch`` takes ``smollm-360m``, ``h2o-danube-1.8b``,
``mamba2-2.7b`` (its SSD scan trains through the kernel and its
backward on the card) or ``zamba2-7b`` (the hybrid: its Mamba-2 layers
as mamba2's, its shared attention blocks through blockwise attention).
The default is the arch's ``reduced()`` config, as in the reference
launcher; ``--full`` trains the full-width config (bf16 parameters, fp32
AdamW state), which for zamba2-7b raises on its ``remat="dots"``
(ROADMAP queue 1 item 7).
``--device cpu`` runs on the CPU; without it the launcher needs a CUDA
device and fails if there is none.  ``--data-axis`` and ``--model-axis``
stay 1: a data axis and TP through this launcher are item 7 (the TP step
runs in rank processes, ``dist/rank_tasks.py::train``).
"""

from __future__ import annotations

import argparse
import os
import tempfile

ROADMAP_AXES = ("ROADMAP queue 1 item 7 (distributed steps: a data axis, "
                "and TP from the launcher)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--global-batch", type=int, default=16)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--data-axis", type=int, default=1)
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--grad-bucket-kb", type=int, default=0,
                   help="accumulate microbatch grads in size-targeted "
                        "buckets of this many KiB (0: leaf by leaf; the "
                        "same bits)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    p.add_argument("--ckpt-interval", type=int, default=50)
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; required to exist)")
    args = p.parse_args(argv)
    if args.data_axis != 1 or args.model_axis != 1:
        raise NotImplementedError(
            f"--data-axis {args.data_axis} --model-axis {args.model_axis}: "
            f"only one device is ported here: {ROADMAP_AXES}")

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.steps import StepConfig
    from repro_torch.models.model import check_remat
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    check_remat(cfg)           # before a full-width model is built
    scfg = StepConfig(
        microbatches=args.microbatches, peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 5), total_steps=args.steps,
        seq_chunk=min(2048, args.seq_len),
        grad_bucket_bytes=(args.grad_bucket_kb << 10) or None)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len + 1,
        global_batch=args.global_batch))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_interval=args.ckpt_interval)
    trainer = Trainer(cfg, scfg, tcfg, data, device=args.device)
    trainer.install_signal_handler()
    params, opt, step = trainer.train()
    if trainer.history:
        print(f"[train] {cfg.name} on {trainer.group.device}: finished at "
              f"step {step}; final loss {trainer.history[-1]['loss']:.4f}")
    else:
        print(f"[train] {cfg.name}: already at step {step} in "
              f"{args.ckpt_dir}")
    return trainer


if __name__ == "__main__":
    main()
