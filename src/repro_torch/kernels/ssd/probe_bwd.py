"""Where the SSD backward's time goes on the card, and what its precision
plan buys: ``python -m repro_torch.kernels.ssd.probe_bwd [--baseline FILE]``.

Builds patched copies of ``csrc/ssd_bwd.cu`` with a part of the bf16
(tensor-core) kernels switched off, one ``nvcc`` each, all at once:
``no_mma`` the products (every ``wgmma``; the accumulators still count
as written), ``no_stage`` the tile loads and their waits (TMA boxes,
cp.async and element fills, mbarriers), ``no_elem`` the L × L
elementwise work of the chunks kernel (masks, splits, row sums of each
k16 step), ``skeleton`` products and staging both, and ``no_lo`` the low
parts of every fp32 operand split into bf16 high and low (they read as
zero).  It times each (and the checkout's own build, twice) by CUDA
kernel with ``torch.profiler`` at the training microbatch of full-width
mamba2-2.7b (B 4, S 2048, bf16), and the checkout alone at S 2048 in
fp32.  Only the checkout's and ``no_lo``'s outputs mean anything: each
gradient's largest difference from ``ref.ssd_bwd_bf16_emulated`` on the
same inputs and kept states, relative to its largest magnitude, is
printed for both (the limit of ``chip_smoke.SSD_BWD_EMU_TOL`` lies
between them).  ``--baseline FILE`` also times another source of the
backward with the checkout's C entry point in turns with the checkout's
(baseline, checkout, checkout, baseline) and prints each gradient's
largest difference between the two.  Prints one JSON object a line and
writes them to ``chiprun_out/probe_bwd.jsonl``; needs a CUDA device.
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
    REPO_ROOT,
    nvcc_path,
    source_of,
)
from repro_torch.kernels.ssd.ops import (
    BWD_LAUNCHED,
    SSD_BWD,
    _forward,
    ssd_bwd,
)
from repro_torch.kernels.ssd.ref import ssd_bwd_bf16_emulated

_SKIP = "\ntemplate <typename... T>\n__device__ void probe_skip(T...) {}\n"
_NO_MMA = [
    ("  hopper::Wgmma<N>::template ss<TA, TB>(acc, da, db, scale_d);",
     "  hopper::fence_regs(acc);"),
    ("  hopper::Wgmma<N>::template rs<TB>(acc, fa, db, 1);",
     "  hopper::fence_regs(acc);"),
]
_NO_STAGE = [
    ("using ll = long long;\n", "using ll = long long;\n" + _SKIP),
    ("hopper::mbar_wait(", "probe_skip("),
    ("hopper::mbar_expect_tx(", "probe_skip("),
    ("tma_load_4d(su", "probe_skip(su"),
    ("expect_tx_if(one", "probe_skip(one"),
    ("tma4_if(one", "probe_skip(one"),
    ("tma3_if(one", "probe_skip(one"),
    ("fill(su, sm,", "probe_skip(su, sm,"),
    ("fill_init(sm, lay.s", "probe_skip(sm, lay.s"),
]
_NO_ELEM = [
    ("if (16 * ks + 15 >= w0) {", "if (a.seq < 0) {"),
    ("if (16 * ks <= w0 + 15) {", "if (a.seq < 0) {"),
]
_NO_LO = [("  lo = hopper::pack_bf16(v0 - h.x, v1 - h.y);", "  lo = 0u;")]
PATCHES = {"no_mma": _NO_MMA, "no_stage": _NO_STAGE, "no_elem": _NO_ELEM,
           "skeleton": _NO_MMA + _NO_STAGE, "no_lo": _NO_LO}
#: (label, B, S, H, P, N, dtype, patched copies): the training microbatch,
#: and S 2048 in fp32 (the CUDA-core kernels: the checkout alone)
CASES = [("mamba2 B4 S2048 bf16", 4, 2048, 80, 64, 128, torch.bfloat16, True),
         ("mamba2 S2048 fp32", 1, 2048, 80, 64, 128, torch.float32, False)]
GRADS = ("dx", "ddt", "da", "db", "dc", "dd", "dinit")


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


def _rel(got, want):
    """{gradient: max |got - want| / max |want|}."""
    return {g: ((u.float() - v.float()).abs().max()
                / v.float().abs().max()).item()
            for g, u, v in zip(GRADS, got, want)}


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
                   help="another source of the entry point to time in turns")
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
    out = REPO_ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    log = open(out / "probe_bwd.jsonl", "w")

    def emit(rec):
        print(json.dumps(rec), flush=True)
        log.write(json.dumps(rec) + "\n")
        log.flush()

    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, bsz, s, h, pdim, n, dtype, patched in CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        x, b, c = (rnd(bsz, s, h, pdim).to(dtype), rnd(bsz, s, 1, n).to(dtype),
                   rnd(bsz, s, 1, n).to(dtype))
        dt = torch.nn.functional.softplus(rnd(bsz, s, h))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
        d = torch.ones(h, device="cuda")
        dy = rnd(bsz, s, h, pdim).to(dtype)
        _, _, s_in = _forward(x, dt, a, b, c, d, 128, None)
        calls = {}
        for name, fn in fns.items():
            def call(fn=fn):
                SSD_BWD._fn = fn
                return ssd_bwd(x, dt, a, b, c, d, dy, None, chunk=128,
                               s_in=s_in)
            calls[name] = call
        order = ["checkout", *(PATCHES if patched else ()), "checkout"]
        if args.baseline:
            order = ["baseline", "checkout", "checkout", "baseline"] + \
                order[1:-1]
        grads = {}
        for name in order:
            if name not in grads and name in ("checkout", "no_lo",
                                              "baseline"):
                grads[name] = calls[name]()
            ms, split = _device_split(calls[name])
            emit(dict(case=label, variant=name, device_ms=ms,
                      kernels_ms=split))
        if dtype == torch.bfloat16:    # every variant launches one plan
            emu = ssd_bwd_bf16_emulated(
                x, dt, a, b, c, d, dy, None, chunk=128, s_in=s_in,
                ht=BWD_LAUNCHED["heads_a_block"])
            for name in ("checkout", "no_lo"):
                if name in grads:
                    emit(dict(case=label, variant=name,
                              vs_bf16_emulated=_rel(grads[name], emu)))
            del emu
        if args.baseline:
            emit(dict(case=label, checkout_vs_baseline=_rel(
                grads["checkout"], grads["baseline"])))
        del grads, x, b, c, dy, s_in
    SSD_BWD._fn = None
    log.close()


if __name__ == "__main__":
    main()
