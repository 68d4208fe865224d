"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Continuous batching with chunked streamed prefill on one GPU, random
weights from seed 0.  ``--arch`` takes ``smollm-360m``,
``h2o-danube-1.8b``, ``nemotron-4-340b`` (at ``reduced()`` only: it does
not fit one card), ``minicpm3-4b`` (multi-head latent attention: its
cache is the latent and a shared rope key, attended at q/k head dim 96
and v head dim 64), ``mamba2-2.7b``, ``zamba2-7b`` (the hybrid: Mamba-2
layers with shared attention blocks), ``internvl2-2b`` (the VLM: each
request carries ``frontend_tokens`` patch embeddings, prefilled before its
text), ``whisper-tiny`` (the encoder-decoder: each request carries its
frame embeddings, and its decoder prompt is capped at
``decoder_max_seq``), or the MoE archs ``llama4-scout-17b-a16e`` (16
experts, top-1, a shared expert) and ``grok-1-314b`` (8 experts, top-2).
A frontend arch's embeddings are drawn per request from the seeded
generator, as the reference launcher draws them.  The default is the
arch's ``reduced()`` config, as in the reference launcher; ``--full``
serves the full-width config in bf16, and refuses, before it draws a
parameter, a config whose weights exceed the card's memory (the MoE
archs and nemotron at their published depth).  ``--layers N`` cuts the
depth and keeps every width: ``--arch llama4-scout-17b-a16e --full
--layers 8`` (19.69 B parameters, 39.4 GB) fits one card; the published
depth needs its experts split over cards.  Expert parallelism is ported
(``models/moe_ep.py``: bulk prefill and decode on a rank's rows,
``dist/rank_tasks.py::ep_serve``), but the ``Server`` over an expert
group and ``--expert-axis`` are not (ROADMAP queue 1 item 7.6).
``--prefill-chunk 0`` admits with bulk per-request prefill; ``--paged``
needs an arch with a paged KV layout (not minicpm3, whose cache is its
latent rows, nor mamba2, whose cache is its constant-size state, nor
zamba2, whose cache is that state beside one K/V ring a shared
application, nor whisper, whose cross K/V stay contiguous).  A VLM's
``--max-seq`` must hold its patch rows as well as the prompt.
``--device cpu`` runs on the CPU (with the kernels' plain versions);
without it the launcher needs a CUDA device and fails if there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

#: bytes of device memory of one H100, the card ``--full`` is sized for
#: when the launcher runs on the CPU
CARD_BYTES = 80e9


def card_bytes(device) -> int:
    """The card's memory: its own on a CUDA device, :data:`CARD_BYTES`
    otherwise."""
    import torch

    return (torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else CARD_BYTES)


def check_fits(cfg, device) -> None:
    """Raise unless ``cfg``'s weights fit the card (:func:`card_bytes`),
    before a parameter is drawn."""
    import torch

    from repro_torch.models.model import count_params_analytic

    itemsize = torch.empty((), dtype=getattr(torch, cfg.param_dtype)
                           ).element_size()
    need = count_params_analytic(cfg) * itemsize
    have = card_bytes(device)
    if need > have:
        raise SystemExit(
            f"{cfg.name} at {cfg.n_layers} layers needs {need / 1e9:.1f} GB "
            f"of {cfg.param_dtype} weights; the card holds {have / 1e9:.1f} "
            f"GB. Cut the depth with --layers (every width kept), or serve "
            f"its experts split over cards (the Server over an expert "
            f"group: ROADMAP queue 1 item 7.6)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--full", action="store_true",
                   help="serve the full-width config (default: reduced())")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the depth to N layers (0: the config's own)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; required to exist)")
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-new", type=int, default=24)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=256)
    p.add_argument("--prefill-chunk", type=int, default=8,
                   help="tokens per admitted prefill chunk (0: bulk "
                        "per-request admission)")
    p.add_argument("--arrive-every", type=int, default=0,
                   help="submit one request every N scheduler steps "
                        "(0: all up front)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV block pool + prefix cache")
    p.add_argument("--block-size", type=int, default=16,
                   help="KV positions per pool block (--paged only)")
    p.add_argument("--dump-tokens", default=None, metavar="PATH",
                   help="write {rid: out_tokens} JSON")
    args = p.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params
    from repro_torch.runtime.server import Server, ServerConfig, drive_arrivals

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.full:
        check_fits(cfg, device)
    params = init_params(cfg, seed=0, device=device)
    srv = Server(cfg, params, ServerConfig(
        max_batch=args.max_batch, max_seq=args.max_seq,
        max_new_tokens=args.max_new,
        prefill_chunk=args.prefill_chunk or None,
        paged=args.paged, block_size=args.block_size), device=device)
    rng = np.random.default_rng(0)
    plen = args.prompt_len
    if cfg.family == "encdec":
        plen = min(plen, cfg.decoder_max_seq)
    prompts = [rng.integers(0, cfg.vocab_size, size=plen)
               for _ in range(args.requests)]
    if cfg.frontend:
        # the vision or audio tower's output the request carries
        prompts = [(pr, rng.standard_normal(
            (cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32))
            for pr in prompts]
    if args.arrive_every:
        steps = drive_arrivals(srv, prompts, args.arrive_every)
    else:
        for pr in prompts:
            srv.submit(*pr) if isinstance(pr, tuple) else srv.submit(pr)
        steps = srv.run()

    stats = srv.stats()
    mode = str(stats["admission_mode"])
    if args.paged:
        mode += f"+paged(blk{args.block_size})"
    print(f"[serve:{mode}] {cfg.name} on {device}: {stats['requests']} "
          f"requests, {stats['tokens']} tokens in {steps} steps; "
          f"{stats['throughput_tok_s']:.1f} tok/s, "
          f"prefill {stats['prefill_tok_s']:.1f} tok/s, "
          f"decode {stats['decode_tok_s']:.1f} tok/s, "
          f"ttft {stats['mean_ttft_s']*1e3:.1f} ms, "
          f"itl {stats['mean_itl_s']*1e3:.2f} ms")
    if args.paged:
        print(f"[serve:{mode}] prefix hits {stats['prefix_hits']:.0f} / "
              f"misses {stats['prefix_misses']:.0f}, "
              f"pool evictions {stats['pool_evictions']:.0f}, "
              f"free blocks {stats['pool_free_blocks']:.0f}")
    if args.dump_tokens:
        with open(args.dump_tokens, "w") as f:
            json.dump({str(r.rid): r.out_tokens for r in srv.done}, f,
                      sort_keys=True)
    return srv


if __name__ == "__main__":
    main()
