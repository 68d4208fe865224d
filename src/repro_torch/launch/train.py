"""Training launcher of the port: ``python -m repro_torch.launch.train``.

Trains one model on one device through :class:`~repro_torch.runtime.
trainer.Trainer` with checkpoints, preemption handling and the straggler
watchdog.  ``--arch`` takes every text-only family the port serves:
``smollm-360m`` and ``h2o-danube-1.8b`` (dense), ``minicpm3-4b`` (MLA),
``mamba2-2.7b`` (its SSD scan trains through the kernel and its backward
on the card), ``zamba2-7b`` (the hybrid: its Mamba-2 layers as mamba2's,
its shared attention blocks through blockwise attention, under the
config's ``remat="dots"`` at full width), and the MoE archs
``llama4-scout-17b-a16e`` and ``grok-1-314b`` (every expert on this one
device, as the reference's ``TransportPolicy.moe="xla"``; split over a
group of rank processes they train by expert parallelism through
``dist.steps.build_train_step``, ``dist/rank_tasks.py::train``, but not
through this launcher: ``--expert-axis`` needs the ``Trainer`` over a
group, ``ROADMAP_TP_CKPT``).  Its data is
``SyntheticLM`` tokens, so ``internvl2-2b`` and ``whisper-tiny`` raise:
their step takes ``batch["frontend_embeds"]`` too, and trains through
``dist.steps.build_train_step`` with embeddings the caller draws.
The default is the arch's ``reduced()`` config, as in the reference
launcher; ``--full`` trains the full-width config (bf16 parameters), and
refuses, before it draws a parameter, a config whose training state
(parameters, AdamW state, fp32 gradient sums and the gradients of one
backward) exceeds the card.  ``--layers N`` cuts the depth and keeps
every width: ``--arch zamba2-7b --full --layers 24`` (2.51 B parameters,
~50 GB of state) fits one card where the published 81 layers (~139 GB)
do not.  The optimizer state follows the reference's ``step_config``
rule on the published config: bf16 moments and no fp32 master for an
arch of 100 B parameters or more (llama4-scout, grok-1, nemotron, at any
depth cut), fp32 masters and moments otherwise.
``--device cpu`` runs on the CPU; without it the launcher needs a CUDA
device and fails if there is none.  ``--data-axis`` and ``--model-axis``
stay 1: a data axis and TP through this launcher are item 7 (the TP step
runs in rank processes, ``dist/rank_tasks.py::train``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

ROADMAP_AXES = ("ROADMAP queue 1 item 7 (distributed steps: a data axis, "
                "and TP from the launcher)")

#: parameters from which the reference's ``step_config`` keeps bf16
#: moments and no fp32 master
BIG_PARAMS = 100e9


def optimizer_state(published) -> dict:
    """``StepConfig`` fields of the AdamW state, by the reference's
    ``launch/specs.py`` ``step_config`` rule on the published config."""
    from repro_torch.models.model import count_params_analytic

    big = count_params_analytic(published) >= BIG_PARAMS
    return dict(moment_dtype="bfloat16" if big else "float32",
                master_fp32=not big)


def train_state_bytes(cfg, moment_dtype: str, master_fp32: bool) -> int:
    """Bytes a training step holds before activations: each parameter in
    its dtype, its AdamW moments (and fp32 master), its fp32 gradient sum
    and its gradient in the parameter dtype while backward runs."""
    from repro_torch.device import dtype_of
    from repro_torch.models.model import count_params_analytic

    per = (2 * dtype_of(cfg.param_dtype).itemsize
           + 2 * dtype_of(moment_dtype).itemsize
           + (4 if master_fp32 else 0) + 4)
    return count_params_analytic(cfg) * per


def check_fits(cfg, device, moment_dtype: str, master_fp32: bool) -> None:
    """Raise unless ``cfg``'s training state fits the card
    (``launch.serve.card_bytes``), before a parameter is drawn."""
    from repro_torch.launch.serve import card_bytes

    need = train_state_bytes(cfg, moment_dtype, master_fp32)
    have = card_bytes(device)
    if need > have:
        raise SystemExit(
            f"{cfg.name} at {cfg.n_layers} layers needs {need / 1e9:.1f} GB "
            f"of training state ({cfg.param_dtype} parameters, "
            f"{moment_dtype} AdamW moments"
            f"{', fp32 masters' if master_fp32 else ''}, fp32 gradient sums "
            f"and one backward's gradients) before activations; the card "
            f"holds {have / 1e9:.1f} GB. Cut the depth with --layers (every "
            f"width kept), or train across more cards (ROADMAP queue 1 "
            f"item 7)")


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
    p.add_argument("--layers", type=int, default=0,
                   help="cut the depth to N layers (0: the config's own)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; required to exist)")
    args = p.parse_args(argv)
    if args.data_axis != 1 or args.model_axis != 1:
        raise NotImplementedError(
            f"--data-axis {args.data_axis} --model-axis {args.model_axis}: "
            f"only one device is ported here: {ROADMAP_AXES}")

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.dist.steps import StepConfig
    from repro_torch.models.model import check_remat
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    published = get_config(args.arch)
    cfg = published.reduced() if args.reduced else published
    if cfg.frontend:
        raise ValueError(
            f"{cfg.name}: its train step takes batch['frontend_embeds'] "
            f"({cfg.frontend_tokens} x {cfg.frontend_dim} a row), which this "
            f"launcher's SyntheticLM data does not make; train it through "
            f"dist.steps.build_train_step with embeddings of your own")
    if args.layers:
        print(f"[train] {cfg.name}: depth cut, n_layers {cfg.n_layers} → "
              f"{args.layers} (every width kept)")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    check_remat(cfg)           # before a full-width model is built
    opt_state = optimizer_state(published)
    device = resolve_device(args.device)
    if not args.reduced:
        check_fits(cfg, device, **opt_state)
    scfg = StepConfig(
        microbatches=args.microbatches, peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 5), total_steps=args.steps,
        seq_chunk=min(2048, args.seq_len),
        grad_bucket_bytes=(args.grad_bucket_kb << 10) or None, **opt_state)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len + 1,
        global_batch=args.global_batch))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_interval=args.ckpt_interval)
    trainer = Trainer(cfg, scfg, tcfg, data, device=device)
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
