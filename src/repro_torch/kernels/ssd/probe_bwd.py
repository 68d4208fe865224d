"""Where the SSD backward's time goes on the card:
``python -m repro_torch.kernels.ssd.probe_bwd [--baseline FILE]``.

Builds patched copies of ``csrc/ssd_bwd.cu`` with a part of the kernels
switched off (``no_mma``: the products' k loop; ``no_stage``: the staging
of slices into shared memory; ``no_tail``: the chunks kernel's last
reductions; ``skeleton``: products and staging both), one ``nvcc`` each,
all at once, and times each (and the checkout's own build, twice) by CUDA
kernel with ``torch.profiler`` at the training microbatch of full-width
mamba2-2.7b (B 4, S 2048, bf16) and at S 2048 in fp32.  A patched copy's
outputs are meaningless; only its times count.  ``--baseline FILE`` also
times another source of the same C entry point in turns with the
checkout's (baseline, checkout, checkout, baseline) and prints each
gradient's largest difference between the two, relative to its largest
magnitude.  Prints one JSON object a line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from repro_torch.kernels.common import (
    BUILD_DIR,
    INCLUDE_DIR,
    NVCC_FLAGS,
    nvcc_path,
    source_of,
)
from repro_torch.kernels.ssd.ops import SSD_BWD, _forward, ssd_bwd

_KLOOP = "  for (int k = 0; k < KT; ++k) {"
_STAGE = "  constexpr int PER = ROWS * COLS / NT;"
PATCHES = {
    "no_mma": [(_KLOOP, "  for (int k = 0; k < KT * (lda < 0); ++k) {")],
    "no_stage": [(_STAGE, _STAGE + "\n  if (nr > -1000000) return;")],
    "no_tail": [("  if (tid < 32) {", "  if (tid < 32 && a.seq < 0) {")],
    "skeleton": [(_KLOOP, "  for (int k = 0; k < KT * (lda < 0); ++k) {"),
                 (_STAGE, _STAGE + "\n  if (nr > -1000000) return;")],
}
#: (label, B, S, H, P, N, dtype): the training microbatch, and S 2048 fp32
CASES = [("mamba2 B4 S2048 bf16", 4, 2048, 80, 64, 128, torch.bfloat16),
         ("mamba2 S2048 fp32", 1, 2048, 80, 64, 128, torch.float32)]


def _build(sources):
    """{name: C entry point} of each (name, source text), built at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = BUILD_DIR / f"probe_bwd_{name}.cu"
        src.write_text(text)
        lib = BUILD_DIR / f"libprobe_bwd_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), SSD_BWD.entry)
        fn.argtypes, fn.restype = SSD_BWD.argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _device_split(call, iters=10):
    """(device ms a call, {CUDA kernel: ms a call}) by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"ssd_bwd_\w+", e.name)
            name = m.group(0) if m else e.name[:60]
            rows[name] = rows.get(name, 0.0) + e.time_range.elapsed_us()
    return (sum(rows.values()) / iters / 1e3,
            {k: v / iters / 1e3 for k, v in rows.items()})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--baseline", default=None,
                   help="another source of repro_ssd_bwd to time in turns")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_bwd needs a CUDA device")
    text = source_of(SSD_BWD.name).read_text()
    sources = {"checkout": text}
    for name, reps in PATCHES.items():
        patched = text
        for old, new in reps:
            if old not in patched:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            patched = patched.replace(old, new)
        sources[name] = patched
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = f.read()
    fns = _build(sources)
    gen = torch.Generator(device="cuda").manual_seed(1)
    order = ["checkout", *PATCHES, "checkout"]
    if args.baseline:
        order = ["baseline", "checkout", "checkout", "baseline"] + order[1:-1]
    for label, bsz, s, h, pdim, n, dtype in CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        x, b, c = (rnd(bsz, s, h, pdim).to(dtype), rnd(bsz, s, 1, n).to(dtype),
                   rnd(bsz, s, 1, n).to(dtype))
        dt = torch.nn.functional.softplus(rnd(bsz, s, h))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
        d = torch.ones(h, device="cuda")
        dy = rnd(bsz, s, h, pdim).to(dtype)
        _, _, s_in = _forward(x, dt, a, b, c, d, 128, None)

        def call():
            return ssd_bwd(x, dt, a, b, c, d, dy, None, chunk=128, s_in=s_in)

        grads = {}
        for name in order:
            SSD_BWD._fn = fns[name]
            if name not in grads:
                grads[name] = call()
            ms, split = _device_split(call)
            print(json.dumps(dict(case=label, variant=name, device_ms=ms,
                                  kernels_ms=split)), flush=True)
        if args.baseline:
            rel = {g: ((u.float() - v.float()).abs().max()
                       / v.float().abs().max()).item()
                   for g, u, v in zip(("dx", "ddt", "da", "db", "dc", "dd",
                                       "dinit"), grads["checkout"],
                                      grads["baseline"])}
            print(json.dumps(dict(case=label, checkout_vs_baseline=rel)),
                  flush=True)
    SSD_BWD._fn = None


if __name__ == "__main__":
    main()
