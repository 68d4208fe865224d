#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Drives the port's main path on one CUDA card and fails loudly if any phase
fails.  It imports nothing of JAX or of the JAX package ``repro``.

1. Build every CUDA kernel from the sources in this checkout (``nvcc`` for
   ``sm_90a`` into ``build/``), all sources in parallel.
2. Hold each kernel to its plain PyTorch version on the card at the main
   path's shapes (smollm-360m heads 15/5 at D 64, h2o-danube-1.8b heads
   32/8 at D 80; bf16 and fp32; bulk S = 1000 and 2048, a 128-row chunk at
   q_offset 1024 of 2048, a 256 window at 2048).  Tolerances: max abs
   error 2e-4 in fp32 (TF32 off), 3e-2 in bf16.  Time the kernel, the plain
   version and ``scaled_dot_product_attention`` (the library yardstick;
   the port never calls it) at the bulk smollm shape.
3. Serve full-width smollm-360m in bf16 (random weights from a seed): 8
   requests with prompts of 256–1024 tokens, 32 new tokens each, batch 4,
   max_seq 2048, prefill chunks of 128, one arrival every 2 steps —
   contiguous, then paged with 128-token blocks.  The two must emit the
   same tokens, and the flash kernel must have launched n_layers times per
   prefill chunk.
4. The reduced configs in fp32: prefill logits through the kernel on the
   card against the plain version on the CPU.

Prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Exits nonzero, printing
no result, when there is no CUDA device or the port cannot be imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bandwidth
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(q, k, causal, window, q_offset):
    """Least time for the attention call: the larger of its visible
    operations at the bf16 peak and its bytes (q, k, v in, out once) at the
    memory rate.  Visible (row, col) pairs are counted for these inputs."""
    import torch

    b, hq, sq, d = q.shape
    skv = k.shape[2]
    rows = q_offset + torch.arange(sq, dtype=torch.int64)
    hi = torch.minimum(rows + 1, torch.tensor(skv)) if causal \
        else torch.full_like(rows, skv)
    lo = (rows - window + 1).clamp_min(0) if window else torch.zeros_like(rows)
    pairs = int((hi - lo).clamp_min(0).sum())
    flops = 4.0 * d * pairs * hq * b
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_build():
    from repro_torch.kernels import KERNEL_NAMES
    from repro_torch.kernels.common import build

    t0 = time.perf_counter()
    secs = build(KERNEL_NAMES)
    print(f"[build] {', '.join(f'{n} {s:.1f}s' for n, s in secs.items())}; "
          f"total {time.perf_counter() - t0:.1f}s", flush=True)


def phase_kernels():
    """Kernel vs plain on the card; returns the main-path case's numbers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        FLASH,
        attention_plain,
        flash_attention,
    )

    for line in FLASH.ptxas_report().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    heads = {"smollm-360m": (15, 5, 64), "h2o-danube-1.8b": (32, 8, 80)}
    cases = [("bulk-1000", 1000, 1000, None, None),
             ("bulk-2048", 2048, 2048, None, None),
             ("chunk-128@1024", 128, 2048, 1024, None),
             ("window-256", 2048, 2048, None, 256)]
    main = None
    for arch, (hq, hkv, d) in heads.items():
        for dtype in (torch.bfloat16, torch.float32):
            for label, sq, skv, q_offset, window in cases:
                q = torch.randn(1, hq, sq, d, generator=gen, device=dev)
                k = torch.randn(1, hkv, skv, d, generator=gen, device=dev)
                v = torch.randn(1, hkv, skv, d, generator=gen, device=dev)
                q, k, v = (t.to(dtype) for t in (q, k, v))
                kw = dict(causal=True, window=window, q_offset=q_offset)
                got = flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                want = attention_plain(q, k, v, **kw)
                if not torch.isfinite(got).all():
                    fail(f"flash {arch} {label} {dtype}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                tol = TOL[str(dtype).split(".")[1]]
                ms = time_ms(lambda: flash_attention(q, k, v, **kw), iters=10)
                print(f"[flash] {arch} {label} {str(dtype)[6:]}: "
                      f"max_abs_err {err:.3g} (tol {tol}), {ms:.4f} ms",
                      flush=True)
                if err > tol:
                    fail(f"flash {arch} {label} {dtype}: err {err} > {tol}")
                if (arch, label, dtype) == ("smollm-360m", "bulk-2048",
                                            torch.bfloat16):
                    kernel_ms = time_ms(
                        lambda: flash_attention(q, k, v, **kw))
                    plain_ms = time_ms(
                        lambda: attention_plain(q, k, v, **kw))
                    library_ms = time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, is_causal=True, enable_gqa=True))
                    bound_ms, bound_by = attention_bound_ms(
                        q, k, True, window, 0)
                    main = dict(max_abs_err=err, ms=kernel_ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=library_ms)
                    print(f"[flash] main-path shape (B1 Hq15/Hkv5 S2048 D64 "
                          f"causal bf16): kernel {kernel_ms:.4f} ms, plain "
                          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
                          f"bound {bound_ms:.5f} ms ({bound_by})",
                          flush=True)
                del q, k, v, got, want
    return main


def phase_serve():
    """Full-width smollm-360m, contiguous then paged; returns the flash
    launches of the two runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.models.model import count_params, init_params
    from repro_torch.runtime.server import Server, ServerConfig, drive_arrivals

    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} full width, {count_params(params)/1e6:.1f}M "
          f"params in {cfg.param_dtype}, init {time.perf_counter()-t0:.1f}s",
          flush=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 1025, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    chunk = 128
    want_chunks = int(sum(-(-int(n) // chunk) for n in lens))
    outs = {}
    FLASH.launches = 0
    for mode, extra in (("contiguous", {}),
                        ("paged", dict(paged=True, block_size=128))):
        before = FLASH.launches
        srv = Server(cfg, params, ServerConfig(
            max_batch=4, max_seq=2048, max_new_tokens=32,
            prefill_chunk=chunk, **extra))
        t0 = time.perf_counter()
        steps = drive_arrivals(srv, prompts, every=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        n = FLASH.launches - before
        print(f"[serve:{mode}] {st['requests']} requests, {st['tokens']} "
              f"tokens in {steps} steps, {wall:.2f}s; prefill "
              f"{st['prefill_tok_s']:.1f} tok/s, decode "
              f"{st['decode_tok_s']:.1f} tok/s, ttft "
              f"{st['mean_ttft_s']*1e3:.1f} ms, itl "
              f"{st['mean_itl_s']*1e3:.2f} ms; flash launches {n} over "
              f"{st['prefill_chunks']} prefill chunks", flush=True)
        if st["requests"] != len(prompts) or any(
                len(r.out_tokens) != 32 for r in srv.done):
            fail(f"{mode}: not every request answered with 32 tokens")
        if st["prefill_chunks"] != want_chunks:
            fail(f"{mode}: {st['prefill_chunks']} prefill chunks run, "
                 f"expected {want_chunks}")
        if n != cfg.n_layers * want_chunks:
            fail(f"{mode}: flash launched {n} times, expected "
                 f"{cfg.n_layers} x {want_chunks}")
        outs[mode] = {r.rid: r.out_tokens for r in srv.done}
        del srv
    launches = FLASH.launches
    if outs["paged"] != outs["contiguous"]:
        fail("paged tokens differ from contiguous tokens")
    print(f"[serve] paged == contiguous: {len(outs['paged'])} requests "
          f"token-identical", flush=True)
    return launches


def phase_reduced_vs_cpu():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import prefill

    for name in ("smollm-360m", "h2o-danube-1.8b"):
        cfg = get_config(name).reduced()
        params = init_params(cfg, seed=1, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(2, 300))).long()
        _, l_cpu = prefill(cfg, params, toks, cache_len=512)
        _, l_gpu = prefill(cfg, params_to(params, "cuda"), toks.cuda(),
                           cache_len=512)
        err = (l_gpu.cpu() - l_cpu).abs().max().item()
        print(f"[reduced] {name} fp32 prefill logits, card vs CPU: max abs "
              f"diff {err:.3g} (tol 1e-4)", flush=True)
        if not err <= 1e-4:
            fail(f"reduced {name}: card vs CPU logits differ by {err}")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch unavailable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              f"root of the checkout", file=sys.stderr)
        return 2
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase_build()
    main_case = phase_kernels()
    launches = phase_serve()
    phase_reduced_vs_cpu()

    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:93",
        launches=launches, **main_case)]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
