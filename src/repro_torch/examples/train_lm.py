"""End to end on one device: train a ~100M-parameter SmolLM-family (or,
with ``--arch mamba2-2.7b``, Mamba-2-family) model for a few hundred steps
with checkpoints, preemption handling and fp32 microbatch accumulation
(the reference's ``examples/train_lm.py``, whose DP × TP mesh is one
device here).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
on a CUDA device (~100M parameters, fp32: smollm-360m at 16 layers / 768
wide, or mamba2-2.7b at 24 layers / 768 wide with 24 SSD heads);
``--small --device cpu`` runs the reduced config on the CPU.  ``--resume``
continues from ``--ckpt-dir`` instead of starting fresh.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="smollm-360m",
                   choices=("smollm-360m", "mamba2-2.7b"))
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--small", action="store_true",
                   help="reduced width, fewer steps (CPU-sized)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --ckpt-dir instead of starting fresh")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; required to exist)")
    args = p.parse_args(argv)
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.steps import StepConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    base = get_config(args.arch)
    if args.small:
        cfg = base.reduced()
        seq, gb, steps = 64, 8, min(args.steps, 60)
    else:
        wide = (dict(n_layers=24, d_model=768, ssm_heads=24)
                if base.family == "ssm" else
                dict(n_layers=16, d_model=768, n_heads=12, n_kv_heads=4,
                     d_ff=2048, head_dim=64, attn_q_chunk=256,
                     attn_kv_chunk=256))
        cfg = dataclasses.replace(base, param_dtype="float32",
                                  compute_dtype="float32", remat="none",
                                  **wide)
        seq, gb, steps = 256, 16, args.steps

    scfg = StepConfig(microbatches=2, seq_chunk=min(256, seq), peak_lr=1e-3,
                      warmup_steps=max(steps // 10, 5), total_steps=steps)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq + 1, global_batch=gb, seed=1))
    tcfg = TrainerConfig(total_steps=steps, ckpt_dir=args.ckpt_dir,
                         ckpt_interval=max(steps // 3, 20), log_interval=10)
    trainer = Trainer(cfg, scfg, tcfg, data, device=args.device)
    trainer.install_signal_handler()
    params, opt, step = trainer.train()

    if not trainer.history:
        print(f"\ntrain_lm: already at step {step} (use a fresh run or "
              f"--steps > {step} with --resume)")
    else:
        first = trainer.history[0]["loss"]
        last = trainer.history[-1]["loss"]
        print(f"\ntrain_lm: {step} steps, loss {first:.3f} -> {last:.3f} "
              f"({(first - last) / first * 100:.1f}% reduction)")
        if not last < first:
            raise RuntimeError("train_lm: the loss did not decrease")
    print("train_lm OK")
    return trainer


if __name__ == "__main__":
    main()
