#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Drives the port's main path on one CUDA card and fails loudly if any phase
fails.  It imports nothing of JAX or of the JAX package ``repro``.

1. Build every CUDA kernel from the sources in this checkout (``nvcc`` for
   ``sm_90a`` into ``build/``), all sources in parallel.
2. Hold each kernel to its plain PyTorch version on the card at the main
   paths' shapes.
   Flash attention: smollm-360m heads 15/5 at D 64, h2o-danube-1.8b heads
   32/8 at D 80; bf16 and fp32; bulk S = 1000 and 2048, a 128-row chunk at
   q_offset 1024 of 2048, a 256 window at 2048.  Tolerances: max abs
   error 2e-4 in fp32 (TF32 off), 3e-2 in bf16.  Time the kernel, the plain
   version and ``scaled_dot_product_attention`` (the library yardstick;
   the port never calls it) at the bulk smollm shape.
   SSD scan: mamba2-2.7b heads (H 80, P 64, N 128, G 1, chunk 128) at
   S 2048, ragged S 1000, a 128-row chunk with a carried state and B 2 at
   S 384 with a state, plus one zamba2 shape (H 112, N 64, S 512); bf16
   and fp32.  Tolerances, as max error over max |plain|: y 1e-4 in fp32
   and 2e-2 in bf16, the final state 1e-4.  Time the kernel and the plain
   version at S 2048 and at the 128-row chunk (no single PyTorch call
   computes the scan, so there is no library yardstick).
3. Serve full-width smollm-360m in bf16 (random weights from a seed): 8
   requests with prompts of 256–1024 tokens, 32 new tokens each, batch 4,
   max_seq 2048, prefill chunks of 128, one arrival every 2 steps —
   contiguous, then paged with 128-token blocks.  The two must emit the
   same tokens, and the flash kernel must have launched n_layers times per
   prefill chunk.
4. Serve full-width mamba2-2.7b in bf16 (random weights from a seed): 6
   requests with prompts of 256–1024 tokens, 16 new tokens each, batch 4,
   one arrival every 2 steps — chunked admission (128-token chunks), then
   bulk.  The SSD kernel must have launched n_layers times per prefill
   chunk and per bulk request.  The same prompts then run in fp32 (the
   weights widened), bulk and chunked outside the server: their
   first-token logits must agree to 1e-3 of their largest magnitude, and
   each bf16 server run's to 1.5e-1 of the fp32 ones (bf16 rounding alone
   moves this random-init model's logits by ~7.5%; the share of agreeing
   generated tokens is printed, not held).
5. The reduced configs in fp32: prefill logits (and mamba2's final SSD
   state) through the kernels on the card against their plain versions on
   the CPU.

Prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Exits nonzero, printing
no result, when there is no CUDA device or the port cannot be imported.
"""

from __future__ import annotations

import dataclasses
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


def ssd_bound_ms(x, b, chunk, with_init):
    """Least time for the SSD call: the larger of its operations at the
    bf16 peak (C·Bᵀ once per group, the other three products per head, for
    the rows of each chunk) and its bytes (x, dt, B, C and the state in,
    y and the state out, once each) at the memory rate."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    flops = 0.0
    for lo in range(0, s, chunk):
        r = min(chunk, s - lo)
        flops += bsz * (2.0 * r * r * n * g
                        + h * (2.0 * r * r * p + 2 * 2.0 * r * n * p))
    state_bytes = bsz * h * n * p * 4
    nbytes = (2 * x.numel() * x.element_size() + bsz * s * h * 4
              + 2 * b.numel() * b.element_size()
              + (2 if with_init else 1) * state_bytes + 2 * h * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_ssd_kernels():
    """SSD kernel vs ``ssd_plain`` on the card at the mamba2-2.7b head
    shapes and one zamba2 shape; returns the numbers of the main-path
    shapes (S 2048 bulk, and the 128-row prefill chunk with a state)."""
    import torch

    from repro_torch.kernels.ssd import SSD, ssd, ssd_plain

    for line in SSD.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[ptxas] {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # (label, B, S, H, P, N, with init_state)
    cases = [("mamba2 S2048", 1, 2048, 80, 64, 128, False),
             ("mamba2 S1000 ragged", 1, 1000, 80, 64, 128, False),
             ("mamba2 chunk128+state", 1, 128, 80, 64, 128, True),
             ("mamba2 B2 S384+state", 2, 384, 80, 64, 128, True),
             ("zamba2 S512", 1, 512, 112, 64, 64, False)]
    chunk = 128
    out = {}
    for label, bsz, s, h, p, n, with_init in cases:
        for dtype in (torch.bfloat16, torch.float32):
            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev)

            x = randn(bsz, s, h, p).to(dtype)
            dt = torch.nn.functional.softplus(randn(bsz, s, h))
            a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h,
                                                    device=dev)))
            b = randn(bsz, s, 1, n).to(dtype)
            c = randn(bsz, s, 1, n).to(dtype)
            d = torch.ones(h, device=dev)
            init = randn(bsz, h, n, p) if with_init else None
            args = (x, dt, a, b, c, d)
            kw = dict(chunk=chunk, init_state=init)
            y, st = ssd(*args, **kw)
            torch.cuda.synchronize()
            y_want, st_want = ssd_plain(*args, **kw)
            if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
                fail(f"ssd {label} {dtype}: non-finite output")
            err_y = ((y.float() - y_want.float()).abs().max()
                     / y_want.float().abs().max()).item()
            err_s = ((st - st_want).abs().max() / st_want.abs().max()).item()
            tol_y = 2e-2 if dtype == torch.bfloat16 else 1e-4
            name = str(dtype).split(".")[1]
            print(f"[ssd] {label} {name}: y max_err/max {err_y:.3g} "
                  f"(tol {tol_y}), state {err_s:.3g} (tol 1e-4)", flush=True)
            if err_y > tol_y or err_s > 1e-4:
                fail(f"ssd {label} {dtype}: errors {err_y}, {err_s}")
            if dtype == torch.bfloat16 and label in (
                    "mamba2 S2048", "mamba2 chunk128+state"):
                kernel_ms = time_ms(lambda: ssd(*args, **kw))
                plain_ms = time_ms(lambda: ssd_plain(*args, **kw), iters=5)
                bound_ms, bound_by = ssd_bound_ms(x, b, chunk, with_init)
                out[label] = dict(
                    max_abs_err=(y.float() - y_want.float()).abs().max()
                    .item(), ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
                print(f"[ssd] {label} bf16: kernel {kernel_ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
                      f"({bound_by})", flush=True)
            del x, b, c, y, st, y_want, st_want
    return out


def phase_serve():
    """Full-width smollm-360m, contiguous then paged; returns the flash
    launches of the two runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.kernels.ssd import SSD
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
    FLASH.launches = SSD.launches = 0
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
    if SSD.launches:
        fail(f"smollm: ssd launched {SSD.launches} times (expected 0)")
    if outs["paged"] != outs["contiguous"]:
        fail("paged tokens differ from contiguous tokens")
    print(f"[serve] paged == contiguous: {len(outs['paged'])} requests "
          f"token-identical", flush=True)
    return launches


def phase_serve_mamba2():
    """Full-width mamba2-2.7b, chunked then bulk admission; returns the SSD
    launches of the two runs."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.kernels.ssd import SSD
    from repro_torch.models.model import (
        count_params,
        count_params_analytic,
        init_params,
    )
    from repro_torch.models.prefill import (
        init_prefill_scratch,
        prefill,
        prefill_chunk,
        prefill_chunk_cuts,
    )
    from repro_torch.runtime.server import Server, ServerConfig, drive_arrivals

    cfg = get_config("mamba2-2.7b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"[mamba2] {cfg.name} full width, {n_params/1e6:.1f}M params in "
          f"{cfg.param_dtype}, init {time.perf_counter()-t0:.1f}s", flush=True)
    if n_params != count_params_analytic(cfg):
        fail(f"mamba2: {n_params} params, expected "
             f"{count_params_analytic(cfg)}")
    rng = np.random.default_rng(0)
    lens = rng.integers(256, 1025, size=6)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    chunk, max_new = 128, 16
    want_chunks = int(sum(-(-int(n) // chunk) for n in lens))
    runs = {}
    launches = 0
    for mode, admit_chunk, want in (
            ("chunked", chunk, cfg.n_layers * want_chunks),
            ("bulk", None, cfg.n_layers * len(prompts))):
        srv = Server(cfg, params, ServerConfig(
            max_batch=4, max_seq=2048, max_new_tokens=max_new,
            prefill_chunk=admit_chunk))
        first = {}
        emit = srv._emit_first_token

        def record(i, req, logits, emit=emit, first=first):
            first[req.rid] = logits[0].float().cpu()
            emit(i, req, logits)

        srv._emit_first_token = record
        SSD.launches = FLASH.launches = 0
        t0 = time.perf_counter()
        steps = drive_arrivals(srv, prompts, every=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = SSD.launches
        launches += n
        st = srv.stats()
        print(f"[mamba2:{mode}] {st['requests']} requests, {st['tokens']} "
              f"tokens in {steps} steps, {wall:.2f}s; prefill "
              f"{st['prefill_tok_s']:.1f} tok/s, decode "
              f"{st['decode_tok_s']:.1f} tok/s, ttft "
              f"{st['mean_ttft_s']*1e3:.1f} ms, itl "
              f"{st['mean_itl_s']*1e3:.2f} ms; ssd launches {n} over "
              f"{st['prefill_chunks']} prefill passes", flush=True)
        if st["requests"] != len(prompts) or any(
                len(r.out_tokens) != max_new for r in srv.done):
            fail(f"mamba2 {mode}: not every request answered with "
                 f"{max_new} tokens")
        if n != want or FLASH.launches:
            fail(f"mamba2 {mode}: ssd launched {n} times (expected {want}), "
                 f"flash {FLASH.launches} times (expected 0)")
        if not all(torch.isfinite(v).all() for v in first.values()):
            fail(f"mamba2 {mode}: non-finite first-token logits")
        runs[mode] = ({r.rid: r.out_tokens for r in srv.done}, first)
        del srv
    (tok_c, first_c), (tok_b, first_b) = runs["chunked"], runs["bulk"]
    agree = sum(a == b for r in tok_b for a, b in zip(tok_c[r], tok_b[r]))
    total = sum(len(t) for t in tok_b.values())

    # The same prompts in fp32 (the bf16 weights, widened), bulk and in
    # 128-token chunks outside the server: chunked ≡ bulk is held here, in
    # fp32, where only the GEMMs' summation order differs between the two.
    # bf16 rounding alone moves this random-init model's first-token
    # logits by ~7.5% of their largest magnitude against fp32 (and two
    # bf16 runs whose GEMMs round differently as far apart), so each bf16
    # server run is held to the fp32 logits at 1.5e-1 instead of to each
    # other; a fault in the carry or the kernel moves them by O(1).
    torch.backends.cuda.matmul.allow_tf32 = False       # full fp32 GEMMs
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    params32 = widen(params)
    del params
    err = {"c16-b16": 0.0, "c32-b32": 0.0, "c16-b32": 0.0, "b16-b32": 0.0}
    for rid, prompt in enumerate(prompts):
        toks = torch.as_tensor(prompt[None, :], dtype=torch.long,
                               device="cuda")
        _, b32 = prefill(cfg32, params32, toks)
        scr = init_prefill_scratch(cfg32, 1, toks.shape[1], "cuda")
        for lo, hi in prefill_chunk_cuts(toks.shape[1], chunk_len=chunk,
                                         multiple=cfg.ssm_chunk):
            scr, c32 = prefill_chunk(cfg32, params32, scr, toks[:, lo:hi], lo)
        b32, c32 = b32[0].cpu(), c32[0].cpu()
        for key, (got, want) in {"c16-b16": (first_c[rid], first_b[rid]),
                                 "c32-b32": (c32, b32),
                                 "c16-b32": (first_c[rid], b32),
                                 "b16-b32": (first_b[rid], b32)}.items():
            e = ((got - want).abs().max() / want.abs().max()).item()
            err[key] = max(err[key], e)
    del params32
    print(f"[mamba2] first-token logits, max_err/max over the 6 requests: "
          f"bf16 chunked vs bulk {err['c16-b16']:.3g}; fp32 chunked vs bulk "
          f"{err['c32-b32']:.3g} (tol 1e-3); bf16 chunked vs fp32 "
          f"{err['c16-b32']:.3g}, bf16 bulk vs fp32 {err['b16-b32']:.3g} "
          f"(tol 1.5e-1); generated tokens agree {agree}/{total} "
          f"({agree / total:.1%})", flush=True)
    if not (err["c32-b32"] <= 1e-3 and err["c16-b32"] <= 1.5e-1
            and err["b16-b32"] <= 1.5e-1):
        fail(f"mamba2: first-token logits out of tolerance: {err}")
    return launches


def widen(tree):
    """A copy of a parameter tree with its bf16 leaves in fp32."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.dtype == torch.bfloat16 else tree
    if isinstance(tree, dict):
        return {k: widen(v) for k, v in tree.items()}
    return [widen(v) for v in tree]


def phase_reduced_vs_cpu():
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, params_to
    from repro_torch.models.prefill import prefill

    for name in ("smollm-360m", "h2o-danube-1.8b", "mamba2-2.7b"):
        cfg = get_config(name).reduced()
        params = init_params(cfg, seed=1, device="cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(2, 300))).long()
        c_cpu, l_cpu = prefill(cfg, params, toks, cache_len=512)
        c_gpu, l_gpu = prefill(cfg, params_to(params, "cuda"), toks.cuda(),
                               cache_len=512)
        err = (l_gpu.cpu() - l_cpu).abs().max().item()
        print(f"[reduced] {name} fp32 prefill logits, card vs CPU: max abs "
              f"diff {err:.3g} (tol 1e-4)", flush=True)
        if not err <= 1e-4:
            fail(f"reduced {name}: card vs CPU logits differ by {err}")
        if cfg.family == "ssm":
            want = c_cpu["ssm_state"]
            err = ((c_gpu["ssm_state"].cpu() - want).abs().max()
                   / want.abs().max()).item()
            print(f"[reduced] {name} final ssm_state, card vs CPU: "
                  f"max_err/max {err:.3g} (tol 1e-4)", flush=True)
            if not err <= 1e-4:
                fail(f"reduced {name}: card vs CPU ssm_state differ by {err}")


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

    t_start = time.perf_counter()
    phase_build()
    flash_main = phase_kernels()
    ssd_cases = phase_ssd_kernels()
    flash_launches = phase_serve()
    torch.cuda.empty_cache()              # the smollm weights are gone
    ssd_launches = phase_serve_mamba2()
    torch.cuda.empty_cache()
    phase_reduced_vs_cpu()
    print(f"[smoke] all phases {time.perf_counter() - t_start:.1f}s",
          flush=True)

    ssd_chunk = ssd_cases["mamba2 chunk128+state"]
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:93",
             launches=flash_launches, **flash_main),
        dict(name="ssd", route="cuda",
             source="src/repro_torch/kernels/ssd/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd/kernel.py:96",
             launches=ssd_launches, **ssd_cases["mamba2 S2048"],
             library_ms=None,
             chunk128_ms=ssd_chunk["ms"],
             chunk128_plain_ms=ssd_chunk["plain_ms"],
             chunk128_bound_ms=ssd_chunk["bound_ms"]),
    ]
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
