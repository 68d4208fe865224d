"""Training launcher of the port: ``python -m repro_torch.launch.train``.

Trains one model through :class:`~repro_torch.runtime.trainer.Trainer`
with checkpoints, preemption handling and the straggler watchdog, on one
device or on a grid of rank processes.  ``--arch`` takes every text-only
family the port serves: ``smollm-360m`` and ``h2o-danube-1.8b`` (dense),
``minicpm3-4b`` (MLA), ``mamba2-2.7b`` (its SSD scan trains through the
kernel and its backward on the card), ``zamba2-7b`` (the hybrid: its
Mamba-2 layers as mamba2's, its shared attention blocks through
blockwise attention, under the config's ``remat="dots"`` at full width),
and the MoE archs ``llama4-scout-17b-a16e`` and ``grok-1-314b`` (every
expert on the device, as the reference's ``TransportPolicy.moe="xla"``,
or split over an expert axis).  Its data is ``SyntheticLM`` tokens, so
``internvl2-2b`` and ``whisper-tiny`` raise: their step takes
``batch["frontend_embeds"]`` too, and trains through
``dist.steps.build_train_step`` with embeddings the caller draws.

The grid: ``--data-axis``, ``--model-axis`` and ``--expert-axis`` (the
reference's flags, ``launch.mesh.make_host_mesh``'s order).  When their
product is above 1 the launcher spawns that many rank processes (a
``RankPool``: on the one card, or on the CPU with ``--device cpu``), and
each runs the Trainer on its place in the grid
(``dist/rank_tasks.py::train_grid``): a dense model's TP edges on the
fused ring inside each model line, a MoE model's experts split over its
expert line with ``--moe-transport`` (``ring``/``xla``) in
``--moe-stream-chunks`` chunks, and the gradients averaged over each
data line (``--grad-bucket-kb`` sets the buckets that sync ships).  The
axes default to 1, where the reference's launcher takes a 2 × 2 host
mesh: its four host devices are free, while four rank processes here
time-slice the one card (or the CPU's cores), so a grid is asked for.

The default is the arch's ``reduced()`` config, as in the reference
launcher; ``--full`` trains the full-width config (bf16 parameters), and
refuses, before it draws a parameter, a config whose training state
(parameters, AdamW state, fp32 gradient sums and the gradients of one
backward), one rank's share times the ranks that share the card, exceeds
the card.  ``--layers N`` cuts the depth and keeps every width:
``--arch zamba2-7b --full --layers 24`` (2.51 B parameters, ~50 GB of
state) fits one card where the published 81 layers (~139 GB) do not.
The optimizer state follows the reference's ``step_config`` rule on the
published config: bf16 moments and no fp32 master for an arch of 100 B
parameters or more (llama4-scout, grok-1, nemotron, at any depth cut),
fp32 masters and moments otherwise.  ``--device cpu`` runs on the CPU;
without it the launcher needs a CUDA device and fails if there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

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


def rank_params(cfg, axis: str = "model", n: int = 1) -> int:
    """Parameters one rank holds when an inner line of ``n`` ranks splits
    ``cfg`` on ``axis``: rank 0's part under ``dist/sharding.py``'s
    placement of ``init_params``' leaves on the ``meta`` device (shapes
    alone, nothing drawn or allocated); every data rank holds the same.
    With nothing split (``n == 1``) it is the model's count."""
    from repro_torch.dist import sharding
    from repro_torch.models.model import count_params_analytic, init_params

    if n == 1:
        return count_params_analytic(cfg)
    part = sharding.shard_tree(init_params(cfg, 0, "meta"), 0, n, axis)
    return sum(t.numel() for _, t in sharding.leaves(part))


def train_state_bytes(cfg, moment_dtype: str, master_fp32: bool,
                      params: int = None) -> int:
    """Bytes a training step holds before activations: each parameter in
    its dtype, its AdamW moments (and fp32 master), its fp32 gradient sum
    and its gradient in the parameter dtype while backward runs
    (``params``: one rank's count, default the whole model's)."""
    from repro_torch.device import dtype_of
    from repro_torch.models.model import count_params_analytic

    per = (2 * dtype_of(cfg.param_dtype).itemsize
           + 2 * dtype_of(moment_dtype).itemsize
           + (4 if master_fp32 else 0) + 4)
    return (count_params_analytic(cfg) if params is None else params) * per


def check_fits(cfg, device, moment_dtype: str, master_fp32: bool, *,
               axis: str = "model", inner: int = 1, ranks: int = 1) -> None:
    """Raise unless the training state of ``ranks`` rank processes on the
    card, each holding one rank's share of ``cfg`` (an inner line of
    ``inner`` ranks on ``axis``), fits it (``launch.serve.card_bytes``),
    before a parameter is drawn."""
    from repro_torch.launch.serve import card_bytes

    one = train_state_bytes(cfg, moment_dtype, master_fp32,
                            rank_params(cfg, axis, inner))
    need, have = ranks * one, card_bytes(device)
    if need > have:
        share = (f"{ranks} ranks of {one / 1e9:.1f} GB each, "
                 if ranks > 1 else "")
        raise SystemExit(
            f"{cfg.name} at {cfg.n_layers} layers needs {need / 1e9:.1f} GB "
            f"of training state ({share}{cfg.param_dtype} parameters, "
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
    p.add_argument("--expert-axis", type=int, default=1,
                   help="expert axis extent (> 1 splits a MoE arch's "
                        "experts; no model axis beside it)")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--grad-bucket-kb", type=int, default=0,
                   help="accumulate microbatch grads in size-targeted "
                        "buckets of this many KiB, the layout the data "
                        "axis's sync ships (0: leaf by leaf; the same bits)")
    p.add_argument("--moe-transport", default="xla",
                   help="TransportPolicy.moe over the expert axis: xla|ring "
                        "(auto and bidir raise)")
    p.add_argument("--moe-stream-chunks", type=int, default=0,
                   help="stream the EP exchange in this many ART chunks "
                        "(0: bulk)")
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

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.dist.steps import StepConfig, TransportPolicy, group_axis
    from repro_torch.launch.mesh import check_axes
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
    axes = dict(data=args.data_axis, model=args.model_axis,
                expert=args.expert_axis)
    check_axes(**axes)
    ranks = args.data_axis * args.model_axis * args.expert_axis
    axis = group_axis(cfg)
    inner = axes[axis]
    if max(axes["model"], axes["expert"]) > inner:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) splits over the {axis} axis; "
            f"{'--expert-axis' if axis == 'model' else '--model-axis'} > 1 "
            f"is not ported: ROADMAP queue 1 item 7.5 (sharding rules)")
    if not args.reduced:
        check_fits(cfg, device, **opt_state, axis=axis, inner=inner,
                   ranks=ranks)
    step_kw = dict(
        microbatches=args.microbatches, peak_lr=args.lr,
        warmup_steps=max(args.steps // 20, 5), total_steps=args.steps,
        seq_chunk=min(2048, args.seq_len), **opt_state)
    dataset = dict(seq_len=args.seq_len + 1, global_batch=args.global_batch)
    if ranks > 1:
        return _train_grid(args, cfg, axes, device, step_kw, dataset)
    scfg = StepConfig(
        grad_bucket_bytes=(args.grad_bucket_kb << 10) or None,
        transport=TransportPolicy(
            moe=args.moe_transport,
            moe_stream_chunks=args.moe_stream_chunks or None), **step_kw)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, **dataset))
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


def _train_grid(args, cfg, axes, device, step_kw, dataset) -> dict:
    """Run the Trainer in a ``RankPool`` of the grid's ranks; returns
    world rank 0's ``rank_tasks.train_grid`` result."""
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    ranks = axes["data"] * axes["model"] * axes["expert"]
    print(f"[train] {cfg.name}: data {axes['data']} x "
          f"{'expert' if axes['expert'] > 1 else 'model'} "
          f"{max(axes['model'], axes['expert'])}, {ranks} rank processes "
          f"on {device.type}")
    with RankPool(ranks, device=device.type) as pool:
        res = pool.run(
            rank_tasks.train_grid, cfg.name, steps=args.steps,
            ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
            cfg_overrides=dataclasses.asdict(cfg), step_overrides=step_kw,
            grad_bucket_kb=args.grad_bucket_kb,
            moe_transport=args.moe_transport,
            moe_stream_chunks=args.moe_stream_chunks or None,
            dataset=dataset, **axes)
    out = res[0]
    if out["history"]:
        print(f"[train] {cfg.name} on {ranks} ranks: finished at step "
              f"{int(out['history'][-1]['step'])}; final loss "
              f"{out['history'][-1]['loss']:.4f}")
    else:
        print(f"[train] {cfg.name}: already at the last step in "
              f"{args.ckpt_dir}")
    return out


if __name__ == "__main__":
    main()
