"""Functions a rank of a :class:`~repro_torch.dist.group.RankPool` runs.

They live in the package so that the ``spawn`` start method can import
them by name.  Each takes the rank's :class:`~repro_torch.dist.group.Group`
first and returns plain, picklable values (numpy arrays, numbers,
strings), so the parent can compare ranks with each other and with the
reference.

* :func:`fused_op` — one fused collective matmul, forward and backward,
  on per-rank inputs.
* :func:`ring_op` — one whole-ring wrapper on per-rank inputs.
* :func:`ring_collectives` — the conduit's bare ring gather and
  reduce-scatter, and the gather's gradient.
* :func:`ring_kernels` — the two whole-ring kernels against their plain
  versions on the card, each timed with the group.
* :func:`train` — the TP train step of ``dist/steps.py`` for a few steps,
  with per-step metrics, hop-kernel launches, wire and staging counts,
  step times and peak device memory.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.cc_matmul import ops as cc_ops


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    from repro_torch.bridge import to_tensor

    return to_tensor(a, device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def fused_op(group, op: str, xs: np.ndarray, ws: np.ndarray,
             gs: np.ndarray, bidirectional: bool,
             device: Optional[str] = None) -> Dict[str, Any]:
    """Rank r takes ``xs[r]``, ``ws[r]`` and the cotangent ``gs[r]``,
    runs ``op`` (``"ag"``: ``allgather_matmul_fused``, ``"rs"``:
    ``matmul_reducescatter_fused``) and backward on ``sum(out · g)``.
    Returns its out, dx and dw (fp32 numpy) and the kernels' launches."""
    dev = group.device if device is None else torch.device(device)
    x = _tensor(xs[group.rank], dev).requires_grad_(True)
    w = _tensor(ws[group.rank], dev).requires_grad_(True)
    g = _tensor(gs[group.rank], dev)
    fn = {"ag": cc_ops.allgather_matmul_fused,
          "rs": cc_ops.matmul_reducescatter_fused}[op]
    cc_ops.reset_counts()
    out = fn(x, w, group, bidirectional=bidirectional)
    (out * g).sum().backward()
    _sync(dev)
    return {"out": _numpy(out), "dx": _numpy(x.grad), "dw": _numpy(w.grad),
            "launches": cc_ops.launches(),
            "plain": dict(cc_ops.PLAIN_CALLS)}


def ring_op(group, op: str, xs: np.ndarray, ws: np.ndarray,
            direction: int) -> Dict[str, Any]:
    """Rank r runs one whole-ring wrapper (``"ag"``: ``ag_matmul_ring``,
    ``"rs"``: ``rs_matmul_ring``) in ``direction`` on ``xs[r]``,
    ``ws[r]``; returns its output (fp32 numpy), the kernels' launches and
    the plain versions' runs."""
    x = _tensor(xs[group.rank], group.device)
    w = _tensor(ws[group.rank], group.device)
    fn = {"ag": cc_ops.ag_matmul_ring, "rs": cc_ops.rs_matmul_ring}[op]
    cc_ops.reset_counts()
    out = fn(x, w, group, direction=direction)
    _sync(group.device)
    return {"out": _numpy(out), "launches": cc_ops.launches(),
            "plain": dict(cc_ops.PLAIN_CALLS)}


def ring_collectives(group, xs: np.ndarray, gs: np.ndarray,
                     chunk_bytes: Optional[int]) -> tuple:
    """The bare ``fused`` conduit collectives (the ring wire) on rank r's
    ``xs[r]``: all_gather along dim 1 and its gradient against the
    cotangent ``gs[r]``, and the reduce_scatter of ``gs[r]``."""
    from repro_torch.core.conduit import Conduit

    x = torch.from_numpy(xs[group.rank]).requires_grad_(True)
    g = torch.from_numpy(gs[group.rank])
    conduit = Conduit(axis=group, transport="fused", chunk_bytes=chunk_bytes)
    out = conduit.all_gather(x, dim=1)
    (out * g).sum().backward()
    rs = conduit.reduce_scatter(g, dim=1)
    return out.detach().numpy(), x.grad.numpy(), rs.numpy()


def _group_ms(group, fn, iters: int) -> float:
    """Milliseconds a call of the collective ``fn`` takes the group: every
    rank starts after a barrier and stops once its own stream is done;
    the slowest rank's time, averaged over ``iters`` calls."""
    import torch.distributed as dist

    fn()
    _sync(group.device)
    dist.barrier(group=group.pg)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(group.device)
    ms = torch.tensor([(time.perf_counter() - t) * 1e3 / iters],
                      dtype=torch.float64)
    dist.all_reduce(ms, op=dist.ReduceOp.MAX, group=group.pg)
    return float(ms.item())


def ring_kernels(group, cases: Sequence[Dict[str, Any]],
                 iters: int = 5) -> List[Dict[str, Any]]:
    """Each case — ``op`` (``"ag"``/``"rs"``), ``direction``, ``B``,
    ``b`` (rows a rank holds in the gather, or receives from the
    reduce-scatter), ``N``, ``K`` and the dtypes ``dx``/``dw`` — on
    inputs drawn on this rank's device from a per-rank seed, through the
    whole-ring kernel and through its plain version (``ref.py``'s
    unfused composition, TF32 off).  x and w are strided views (a row
    block, a column slice).  Returns per case the launches, the max
    error, the plain version's max magnitude, and both times."""
    from repro_torch.kernels.cc_matmul import ref as cc_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, n = group.device, group.size
    out = []
    for i, c in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(
            1000 * i + group.rank)
        dx, dw = getattr(torch, c["dx"]), getattr(torch, c["dw"])
        rows = c["b"] * (n if c["op"] == "rs" else 1)
        x = torch.randn((c["B"], 2 * rows, c["K"]), generator=gen,
                        device=dev).to(dx)[:, rows:]
        w = torch.randn((c["K"], c["N"] + 8), generator=gen,
                        device=dev).to(dw)[:, :c["N"]]
        kernel, plain = {
            "ag": (cc_ops.ag_matmul_ring, cc_ref.allgather_matmul_ref),
            "rs": (cc_ops.rs_matmul_ring, cc_ref.matmul_reducescatter_ref),
        }[c["op"]]

        def run():
            return kernel(x, w, group, direction=c["direction"])

        cc_ops.reset_counts()
        got = run()
        _sync(dev)
        launched = cc_ops.launches()
        want = plain(x, w, group)
        out.append(dict(
            launches=launched,
            finite=bool(torch.isfinite(got).all()),
            max_abs_err=float((got - want).abs().max()),
            max_plain=float(want.abs().max()),
            ms=_group_ms(group, run, iters),
            plain_ms=_group_ms(group, lambda: plain(x, w, group), iters)))
    return out


def _device_summary(prof) -> Dict[str, Any]:
    """Device time of one profiled step from ``torch.profiler``: the
    events it files under the card, summed by name — kernels (the cc_matmul
    kernels among them) and host↔device copies.  (gloo's own events come
    under the card too; they count in neither.)"""
    rows = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])

    def total(pred):
        return sum(ms for name, ms, _ in rows if pred(name))

    def is_copy(name):
        return name.startswith(("Memcpy", "Memset"))

    return {"kernel_ms": total(lambda n: not is_copy(n)
                               and not n.startswith("gloo")),
            "cc_ms": total(lambda n: "hop_gemm" in n or "_ring" in n),
            "copy_ms": total(is_copy),
            "top": rows[:10]}


def _digest(t: torch.Tensor) -> str:
    a = t.detach().cpu().contiguous()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return hashlib.sha256(a.numpy().tobytes()).hexdigest()


def train(group, arch: str, *, steps: int, reduced: bool = False,
          cfg_overrides: Optional[Dict[str, Any]] = None,
          step_overrides: Optional[Dict[str, Any]] = None,
          tp_transport: Optional[str] = None,
          seed: int = 0, params_np: Optional[Dict[str, Any]] = None,
          init_device: Optional[str] = None,
          device: Optional[str] = None,
          batches: Optional[Sequence[Dict[str, np.ndarray]]] = None,
          data: Optional[Dict[str, int]] = None,
          return_params: bool = False,
          profile_step: Optional[int] = None) -> Dict[str, Any]:
    """Train ``arch`` (``reduced()`` if asked, then ``cfg_overrides``)
    for ``steps`` steps of ``build_train_step`` on this rank.

    Parameters: the reference's pytree ``params_np`` (numpy, through
    ``bridge.shard_params``), or ``build_init``'s draw from ``seed`` —
    on ``init_device`` when given (a CPU draw gives the same numbers for a
    card run and a CPU run), moved to the run's device.  Batches: the
    given numpy ``batches`` (step k takes ``batches[k]``), or
    ``SyntheticLM(DataConfig(vocab_size, **data))``.  The step config is
    the TP preset's (``tp_transport``, default from the arch's preset)
    with ``step_overrides``.

    Returns per-step ``metrics``, ``launches`` (each cc_matmul kernel's, that
    step), ``plain`` (the plain versions' runs), ``stats`` (ring hops,
    staged and peer-forwarded bytes, wire seconds), ``seconds``, the device's peak memory, the
    sha256 of every replicated leaf after the last step, and with
    ``return_params`` this rank's parameter shard (fp32 numpy by path).
    ``profile_step`` runs that step under ``torch.profiler`` and adds its
    device-time summary (``profile``: kernels and copies by name, the hop
    kernels' share); the other steps' times are the unprofiled ones."""
    from repro_torch.bridge import shard_params
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.steps import (
        StepConfig,
        TransportPolicy,
        build_init,
        build_train_step,
        init_opt,
    )
    from repro_torch.models.model import params_to

    dev = group.device if device is None else torch.device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    scfg = StepConfig(transport=TransportPolicy(tp=tp_transport or "fused"),
                      **(step_overrides or {}))
    # the group's wire is the group's; this run's tensors live on `dev`
    # (the peer memory serves tensors on the card only)
    run_group = dataclasses.replace(
        group, device=dev, stats=group.stats,
        peer=group.peer if dev.type == "cuda" else None)

    t0 = time.perf_counter()
    if params_np is not None:
        params = shard_params(params_np, group.rank, group.size, dev)
        opt = init_opt(params, scfg)
    elif init_device is None or torch.device(init_device) == dev:
        params, opt = build_init(cfg, run_group, scfg)(seed)
    else:
        init_group = dataclasses.replace(
            run_group, device=torch.device(init_device), stats=group.stats)
        params, opt = build_init(cfg, init_group, scfg)(seed)
        params, opt = params_to(params, dev), None
        opt = init_opt(params, scfg)
    _sync(dev)
    init_s = time.perf_counter() - t0
    step_fn = build_train_step(cfg, run_group, scfg)
    source = None if batches is not None else SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, **(data or {})))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    out: Dict[str, List[Any]] = {k: [] for k in (
        "metrics", "launches", "plain", "stats", "seconds")}
    for k in range(steps):
        if batches is not None:
            batch = {n: torch.from_numpy(np.asarray(a)).long()
                     for n, a in batches[k].items()}
        else:
            batch = source.global_batch(k)
        cc_ops.reset_counts()
        before = dict(group.stats)
        _sync(dev)
        prof = None
        if k == profile_step and dev.type == "cuda":
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch, k)
        _sync(dev)
        out["seconds"].append(time.perf_counter() - t)
        if prof is not None:
            prof.__exit__(None, None, None)
            out["profile"] = _device_summary(prof)
        out["metrics"].append(metrics)
        out["launches"].append(cc_ops.launches())
        out["plain"].append(dict(cc_ops.PLAIN_CALLS))
        out["stats"].append({n: group.stats[n] - before[n]
                             for n in group.stats})

    leaves = list(sharding.leaves(params))
    result: Dict[str, Any] = dict(out)
    result.update(
        init_seconds=init_s,
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0),
        n_params=sum(t.numel() for _, t in leaves),
        replicated={"/".join(map(str, p)): _digest(t) for p, t in leaves
                    if sharding.placement(p) == "rep"})
    if return_params:
        result["params"] = {"/".join(map(str, p)): _numpy(t)
                            for p, t in leaves}
    return result


__all__ = ["fused_op", "ring_collectives", "ring_kernels", "ring_op",
           "train"]
