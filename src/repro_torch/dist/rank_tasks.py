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
  reduce-scatter, and the gather's gradient; :func:`collective_grad`
  any transport's differentiable gather, reduce-scatter or all-to-all.
* :func:`overlap_op` — one overlap schedule of ``core/overlap.py``,
  forward and backward, beside the fused op on the same inputs.
* :func:`ring_kernels` — the two whole-ring ops against their plain
  versions on the card, each timed with the group, their hop products
  counted and (optionally) profiled.
* :func:`train` — the train step of ``dist/steps.py`` over the group or
  a grid of it (TP for a dense model, expert parallelism for a MoE
  model, a data axis) for a few steps, with per-step metrics, hop-kernel
  launches, wire and staging counts, step times and peak device memory.
* :func:`train_grid` — the ``Trainer`` on the rank's grid, with its
  checkpoints and the restart protocol (``launch/train.py``'s task).
* :func:`grid_sync` — the data line's gradient sync, exact and int8,
  on the step's own gradients; :func:`cross_pod_op` the same functions
  on given per-rank gradients.

Expert parallelism (``models/moe_ep.py``):

* :func:`all_to_all_grad` — the conduit all-to-all and its backward.
* :func:`moe_ep_layer` — one MoE layer's EP forward (and backward) on
  the rank's rows; :func:`moe_ep_layer_check` holds it to the dense
  layer's results on the card.
* :func:`ep_serve` — bulk prefill and decode steps on the rank's rows.

The PGAS substrate (``core/pgas.py``, ``core/am.py``, ``core/art.py``):

* :func:`pgas_program` — a list of one-sided operations (PUT, GET, the
  AM classes, the symbol closures) on a symmetric heap; returns the heap
  and what each GET or medium AM delivered.
* :func:`quickstart` — the quickstart's ring PUT, ``SCALE`` Active Message
  and ART matmul.
* :func:`put_get_sweep` — PUT and GET between ranks 0 and 1 over a range
  of sizes, timed and read back.
* :func:`case_study` — the paper's Sec. V: ART ≡ bulk ≡ ``M @ N`` and the
  kernel-split convolution, timed.
* :func:`art_op`, :func:`art_send_op`, :func:`collective_op` — one ART
  entry point or conduit collective on per-rank inputs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.cc_matmul import ops as cc_ops


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensor(a: Any, device) -> torch.Tensor:
    """A numpy array, or a tensor (a CUDA tensor may arrive from the
    parent through CUDA IPC), on ``device``."""
    from repro_torch.bridge import to_tensor

    if isinstance(a, torch.Tensor):
        return a.to(device)
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


def overlap_op(group, op: str, xs: np.ndarray, ws: np.ndarray,
               gs: np.ndarray, bidirectional: bool) -> Dict[str, Any]:
    """Rank r runs ``op`` of ``core/overlap.py`` (``"ag"``:
    ``allgather_matmul``, ``"rs"``: ``matmul_reducescatter``) with
    ``axis=group`` on ``xs[r]``, ``ws[r]`` and backward on ``sum(out ·
    gs[r])``; then the fused op on the same inputs (:func:`fused_op`).
    Returns each one's out, dx and dw (fp32 numpy) and the group's
    permutes in the overlap call, forward and backward."""
    from repro_torch.core import overlap

    x = _tensor(xs[group.rank], group.device).requires_grad_(True)
    w = _tensor(ws[group.rank], group.device).requires_grad_(True)
    g = _tensor(gs[group.rank], group.device)
    fn = {"ag": overlap.allgather_matmul,
          "rs": overlap.matmul_reducescatter}[op]
    hops = group.stats["hops"]
    out = fn(x, w, axis=group, bidirectional=bidirectional)
    (out * g).sum().backward()
    hops = group.stats["hops"] - hops
    _sync(group.device)
    return {"out": _numpy(out), "dx": _numpy(x.grad), "dw": _numpy(w.grad),
            "hops": hops,
            "fused": fused_op(group, op, xs, ws, gs, bidirectional)}


def collective_grad(group, transport: str, op: str, xs: np.ndarray,
                    gs: np.ndarray, chunk_bytes: Optional[int] = None,
                    dim: int = 0) -> Dict[str, np.ndarray]:
    """Rank r: ``y = Conduit(group, transport, chunk_bytes).<op>(xs[r])``
    (``all_gather`` / ``reduce_scatter`` along ``dim``, or
    ``all_to_all``) under autograd, backward with the cotangent
    ``gs[r]``; returns y and the gradient of ``xs[r]``."""
    from repro_torch.core.conduit import Conduit

    c = Conduit(axis=group, transport=transport, chunk_bytes=chunk_bytes)
    x = _tensor(xs[group.rank], group.device).requires_grad_(True)
    kw = {} if op == "all_to_all" else {"dim": dim}
    y = getattr(c, op)(x, **kw)
    y.backward(_tensor(gs[group.rank], group.device))
    return {"y": _numpy(y), "dx": _numpy(x.grad)}


def vocab_embed(group, table: np.ndarray, tokens: np.ndarray,
                cot: np.ndarray) -> Dict[str, np.ndarray]:
    """The vocab-parallel embedding (``models/vocab_parallel.py``, through
    a sequence-sharded ``tp_block.SeqLine`` as the TP step embeds; a
    dense config, whose widths the lookup does not read) of the line's
    whole ``tokens`` (B, S) over this rank's rows of ``table`` (V, D),
    and backward on ``sum(rows · cot[:, this rank's rows])``: returns its
    (B, S/n, D) rows and its shard's gradient."""
    from repro_torch.configs import get_config
    from repro_torch.core.conduit import Conduit
    from repro_torch.dist import sharding
    from repro_torch.models.tp_block import SeqLine
    from repro_torch.models.vocab_parallel import VocabParallel

    n, r = group.size, group.rank
    conduit = Conduit(axis=group, transport="fused")
    line = SeqLine(conduit, sp=True,
                   vocab=VocabParallel(conduit, len(table)))
    shard = sharding.shard_leaf(_tensor(table, group.device), "row", r, n)
    shard.requires_grad_(True)
    rows = line.embed(get_config("h2o-danube-1.8b").reduced(),
                      {"embed": shard},
                      _tensor(tokens, group.device).long())
    s_loc = rows.shape[1]
    (rows * _tensor(cot, group.device)[:, r * s_loc:(r + 1) * s_loc]
     ).sum().backward()
    return {"rows": _numpy(rows), "grad": _numpy(shard.grad)}


def vocab_ce(group, arch: str, hidden: np.ndarray, labels: np.ndarray,
             head: np.ndarray, *, seq_chunk: int,
             cfg_overrides: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
    """The vocab-parallel head and CE (``dist.loss.head_loss``) of the
    reduced ``arch`` on this rank: its rows of ``hidden`` (B, S, D), the
    line's whole ``labels`` (B, S), its vocab part of ``head`` (the
    untied (D, V) ``lm_head``, or, tied, the (V, D) ``embed``), sums over
    the line (a sequence-sharded line, the head the fused AG edge).
    Backward on the rank's loss; returns the loss, the metrics, and the
    gradients of its rows and its head shard, with the kernels' launches
    and the plain versions' runs."""
    from repro_torch.configs import get_config
    from repro_torch.core.conduit import Conduit
    from repro_torch.dist import sharding
    from repro_torch.dist.loss import head_loss
    from repro_torch.models.tp_block import SeqLine
    from repro_torch.models.vocab_parallel import VocabParallel

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              **(cfg_overrides or {}))
    n, r = group.size, group.rank
    dev = group.device
    name = "embed" if cfg.tie_embeddings else "lm_head"
    full = _tensor(head, dev)
    shard = sharding.shard_leaf(full, sharding.placement(
        (name,), "model", tuple(full.shape), n, scheme="art"), r,
        n).requires_grad_(True)
    s_loc = hidden.shape[1] // n
    h = _tensor(hidden, dev)[:, r * s_loc:(r + 1) * s_loc].contiguous()
    h.requires_grad_(True)
    conduit = Conduit(axis=group, transport="fused")
    vp = VocabParallel(conduit, cfg.vocab_size)
    cc_ops.reset_counts()
    loss, metrics = head_loss(
        cfg, {name: shard}, h, _tensor(labels, dev).long(),
        h.new_zeros((), dtype=torch.float32), seq_chunk=seq_chunk,
        group=group, line=SeqLine(conduit, sp=True, vocab=vp))
    loss.backward()
    return {"loss": loss.item(), "metrics": metrics, "dh": _numpy(h.grad),
            "dhead": _numpy(shard.grad), "launches": cc_ops.launches(),
            "plain": dict(cc_ops.PLAIN_CALLS)}


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


def ring_kernels(group, cases: Sequence[Dict[str, Any]], iters: int = 5,
                 long_iters: int = 0,
                 profile_calls: int = 0) -> List[Dict[str, Any]]:
    """Each case — ``op`` (``"ag"``/``"rs"``), ``direction``, ``B``,
    ``b`` (rows a rank holds in the gather, or receives from the
    reduce-scatter), ``N``, ``K`` and the dtypes ``dx``/``dw`` — on
    inputs drawn on this rank's device from a per-rank seed, through the
    whole-ring op and through its plain version (``ref.py``'s unfused
    composition, TF32 off).  x and w are strided views (a row block, a
    column slice).  Returns per case the launches, the hop products one
    call launched (``Group.stats["ring_kernels"]``, as the launcher counts
    them), the max error, the plain version's max magnitude, both times
    over ``iters`` calls, with ``long_iters`` the ring's time over that
    many calls too (``ms_long``), and, with ``profile_calls``, this
    rank's device time a call by ``torch.profiler``: its hop products
    (``hop_ms``, over ``hop_events`` of them) and its forwards
    (``copy_ms``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for i, c in enumerate(cases):
        x, w, run, plain = ring_case(group, i, c)
        cc_ops.reset_counts()
        before = group.stats["ring_kernels"]
        got = run()
        _sync(group.device)
        launched = cc_ops.launches()
        want = plain(x, w, group)
        out.append(dict(
            launches=launched,
            ring_kernels=group.stats["ring_kernels"] - before,
            finite=bool(torch.isfinite(got).all()),
            max_abs_err=float((got - want).abs().max()),
            max_plain=float(want.abs().max()),
            ms=_group_ms(group, run, iters),
            plain_ms=_group_ms(group, lambda: plain(x, w, group), iters)))
        if long_iters:
            out[-1]["ms_long"] = _group_ms(group, run, long_iters)
        if profile_calls:
            out[-1].update(_ring_profile(group, run, profile_calls))
    return out


def ring_case(group, i: int, c: Dict[str, Any]):
    """Case ``i`` of ``ring_kernels``: this rank's x and w (strided views,
    drawn from a per-rank seed), a call of the whole-ring op on them, and
    the op's plain version."""
    from repro_torch.kernels.cc_matmul import ref as cc_ref

    dev, n = group.device, group.size
    gen = torch.Generator(device=dev).manual_seed(1000 * i + group.rank)
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

    return x, w, run, plain


#: seconds each rank idles inside its profile before the first ring call
#: and after the last one's synchronise (``_ring_profile``)
PROFILE_MARGIN_S = 0.05


def _ring_profile(group, run, calls: int,
                  margin_s: float = PROFILE_MARGIN_S) -> Dict[str, float]:
    """This rank's device time a ring call by ``torch.profiler``: the hop
    products (and how many), and the forwards (device-to-device
    copies).

    The calls sit ``margin_s`` inside the profile on both sides: the ranks
    come from a group timing's all-reduce together, so every rank's
    profiler is running before the first hop of any, and the last hop has
    ended well before any profiler stops.  Without the margins a
    profile can come back short of hop records, on every rank at once
    (``probe_ring_profile`` counts how often)."""
    from torch.profiler import ProfilerActivity, profile

    _sync(group.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(calls):
            run()
        _sync(group.device)
        time.sleep(margin_s)
    hop_ms = copy_ms = hop_events = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if "hop_gemm" in ev.key:
            hop_ms += us / 1e3
            hop_events += ev.count
        elif ev.key.startswith("Memcpy DtoD"):
            copy_ms += us / 1e3
    return {"hop_ms": hop_ms / calls, "hop_events": hop_events / calls,
            "copy_ms": copy_ms / calls}


def _device_summary(prof) -> Dict[str, Any]:
    """Device time of one profiled step from ``torch.profiler``: the
    events it files under the card, summed by name — kernels (the cc_matmul
    kernels among them) and host↔device copies, and the union of the
    kernels' spans (``kernel_spans``).  (gloo's own events come under the
    card too; they count in neither.)"""
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

    return {"kernel_ms": total(_is_kernel),
            "cc_ms": total(lambda n: "hop_gemm" in n),
            "copy_ms": total(_is_copy),
            "kernel_spans": _kernel_spans(prof),
            "top": rows[:10]}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _is_kernel(name: str) -> bool:
    return not _is_copy(name) and not name.startswith("gloo")


def union_spans(spans: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The union of ``(start, end)`` intervals, as disjoint intervals in
    order."""
    out: List[Tuple[int, int]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _kernel_spans(prof) -> List[Tuple[int, int]]:
    """The union of this rank's kernel spans on the card, in ns on the
    host clock torch.profiler stamps every process's events with (empty
    where the profiler does not expose its raw events)."""
    try:
        return union_spans([
            (e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if str(e.device_type()).endswith("CUDA")
            and _is_kernel(e.name())])
    except AttributeError:
        return []


def _stats_delta(before: Dict[str, Dict[str, float]],
                 after: Dict[str, Dict[str, float]]
                 ) -> Dict[str, Dict[str, float]]:
    return {a: {n: after[a][n] - before[a][n] for n in after[a]}
            for a in after}


def _digest(t: torch.Tensor) -> str:
    a = t.detach().cpu().contiguous()
    if a.dtype == torch.bfloat16:
        a = a.view(torch.int16)
    return hashlib.sha256(a.numpy().tobytes()).hexdigest()


def train(group, arch: str, *, steps: int, reduced: bool = False,
          cfg_overrides: Optional[Dict[str, Any]] = None,
          step_overrides: Optional[Dict[str, Any]] = None,
          tp_transport: Optional[str] = None,
          moe_transport: Optional[str] = None,
          moe_stream_chunks: Optional[int] = None,
          cross_pod: Optional[str] = None,
          seed: int = 0, params_np: Optional[Dict[str, Any]] = None,
          init_device: Optional[str] = None,
          device: Optional[str] = None,
          batches: Optional[Sequence[Dict[str, np.ndarray]]] = None,
          data: Optional[Dict[str, int]] = None,
          return_params: bool = False,
          profile_step: Optional[int] = None,
          grid: Optional[Dict[str, int]] = None,
          vocab_rows: bool = False) -> Dict[str, Any]:
    """Train ``arch`` (``reduced()`` if asked, then ``cfg_overrides``)
    for ``steps`` steps of ``build_train_step`` on this rank.

    The world is the ``1 × n`` grid of the arch's axis, or with ``grid``
    (``launch.mesh.make_host_mesh``'s ``data``, ``model``, ``expert``)
    that grid.  A MoE arch trains by expert parallelism over its expert
    line (its experts split, its rows of each microbatch its own), its
    exchange on ``moe_transport`` (default ``xla``) in
    ``moe_stream_chunks`` chunks; a data line's gradient sync rides
    ``cross_pod`` (default ``ring``).

    Parameters: the reference's pytree ``params_np`` (numpy, through
    ``bridge.shard_params`` on the inner line), or ``build_init``'s
    draw from ``seed`` —
    on ``init_device`` when given (a CPU draw gives the same numbers for a
    card run and a CPU run), moved to the run's device.  Batches: the
    given numpy ``batches`` (step k takes ``batches[k]``), or
    ``SyntheticLM(DataConfig(vocab_size, **data))``.  The step config is
    ``TransportPolicy(tp=tp_transport)`` (default ``fused``: this task
    measures the rings; ``xla`` is the reference's GSPMD layout,
    ``models/tp_block.py``) with ``step_overrides``; the TP path it takes
    (``dist.steps.tp_scheme``) is the result's ``scheme``.

    Returns per-step ``metrics``, ``launches`` (each cc_matmul kernel's, that
    step), ``plain`` (the plain versions' runs), ``edges`` (the TP edges
    run, ``artblock.EDGE_CALLS``'s items: (op, global bytes, modeled
    seconds, family, bidirectional) and the calls), ``stats`` (the world's
    ring hops, staged, sent and peer-forwarded bytes, wire seconds) and
    ``line_stats`` (the same, a grid line each), ``rep_wire`` (the step's
    all-reduce of the replicated leaves' gradients over the inner line:
    its payload and staged bytes; the rest of the line's staged bytes is
    everything else), ``seconds``, the device's
    peak memory, the grid's ``coords`` and ``shape``, the sha256 of every
    replicated leaf, the paths of the sharded ones (``sharded``: the
    vocab-parallel ``embed``/``lm_head`` among them where the line splits
    the vocab), and of every leaf (``digests``) after the last step, and with
    ``return_params`` this rank's parameter shard (fp32 numpy by path).
    ``profile_step`` runs that step under ``torch.profiler`` and adds its
    device-time summary (``profile``: kernels and copies by name, the hop
    kernels' share); the other steps' times are the unprofiled ones.
    ``vocab_rows`` adds, each step, an exact checksum of every vocab row
    (column) of this rank's ``embed`` and ``lm_head`` shards
    (:func:`vocab_checksums`)."""
    from repro_torch.bridge import shard_params
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.steps import (
        StepConfig,
        TransportPolicy,
        build_init,
        build_train_step,
        group_axis,
        init_opt,
        param_places,
        step_grid,
        tp_scheme,
    )
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import artblock
    from repro_torch.models.model import params_to

    dev = group.device if device is None else torch.device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    axis = group_axis(cfg)
    scfg = StepConfig(transport=TransportPolicy(
        tp=tp_transport or "fused", moe=moe_transport or "xla",
        cross_pod=cross_pod or "ring",
        moe_stream_chunks=moe_stream_chunks), **(step_overrides or {}))
    # the group's wire is the group's; this run's tensors live on `dev`
    # (the peer memory serves tensors on the card only)
    run_group = dataclasses.replace(
        group, device=dev, stats=group.stats,
        peer=group.peer if dev.type == "cuda" else None)
    mesh = (make_host_mesh(run_group, **grid) if grid
            else step_grid(cfg, run_group))
    inner = mesh.inner
    scheme = tp_scheme(cfg, scfg, inner.size)

    t0 = time.perf_counter()
    if params_np is not None:
        params = shard_params(params_np, inner.rank, inner.size, dev, axis,
                              scheme=scheme)
        opt = init_opt(params, scfg)
    elif init_device is None or torch.device(init_device) == dev:
        params, opt = build_init(cfg, mesh, scfg)(seed)
    else:
        cpu_world = dataclasses.replace(mesh.world,
                                        device=torch.device(init_device))
        params, opt = build_init(cfg, dataclasses.replace(
            mesh, world=cpu_world), scfg)(seed)
        params, opt = params_to(params, dev), None
        opt = init_opt(params, scfg)
    _sync(dev)
    init_s = time.perf_counter() - t0
    step_fn = build_train_step(cfg, mesh, scfg)
    source = (_Batches(batches) if batches is not None else SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, **(data or {}))))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    out: Dict[str, List[Any]] = {k: [] for k in (
        "metrics", "launches", "plain", "stats", "line_stats", "rep_wire",
        "seconds", "vocab_rows", "edges")}
    for k in range(steps):
        batch = source.global_batch(k)
        cc_ops.reset_counts()
        artblock.EDGE_CALLS.clear()
        before = dict(group.stats)
        lines_before = mesh.line_stats()
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
        out["line_stats"].append(_stats_delta(lines_before,
                                              mesh.line_stats()))
        out["rep_wire"].append(dict(step_fn.rep_wire))
        out["edges"].append(sorted(artblock.EDGE_CALLS.items()))
        if vocab_rows:
            out["vocab_rows"].append(vocab_checksums(params))

    leaves = list(sharding.leaves(params))
    places = param_places(cfg, inner.size, axis, scheme)
    result: Dict[str, Any] = dict(out)
    result.update(
        init_seconds=init_s,
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0),
        n_params=sum(t.numel() for _, t in leaves),
        coords=mesh.coords, shape=mesh.shape, scheme=scheme,
        replicated={"/".join(map(str, p)): _digest(t) for p, t in leaves
                    if places[p] == "rep"},
        sharded=sorted("/".join(map(str, p)) for p, _ in leaves
                       if places[p] != "rep"),
        digests={"/".join(map(str, p)): _digest(t) for p, t in leaves})
    if return_params:
        result["params"] = {"/".join(map(str, p)): _numpy(t)
                            for p, t in leaves}
    return result


def vocab_checksums(params) -> Dict[str, np.ndarray]:
    """An exact checksum of every vocab row of ``embed`` (V_loc, D) and
    every vocab column of ``lm_head`` (D, V_loc): the integer sum of each
    element's bits times its position along D, in int64 (no rounding, so
    two runs that hold the same rows agree exactly, whatever their
    shards)."""
    from repro_torch.dist.sharding import VOCAB_PARALLEL

    out = {}
    for name, dim in VOCAB_PARALLEL.items():
        if name not in params:
            continue
        a = params[name].detach().cpu().contiguous()
        bits = (a.view(torch.int16) if a.element_size() == 2
                else a.view(torch.int32)).numpy().astype(np.int64)
        bits = bits if dim == 0 else bits.T
        out[name] = (bits * np.arange(1, bits.shape[1] + 1)).sum(axis=1)
    return out


def _train_setup(arch: str, *, reduced: bool, cfg_overrides,
                 step_overrides, tp_transport=None, moe_transport=None,
                 moe_stream_chunks=None, grad_bucket_kb: int = 0):
    """(cfg, step config) of a grid task: the arch (``reduced()`` if
    asked, then ``cfg_overrides``) and the step config (the TP path of
    ``tp_transport``, default the reference's ``xla``; the MoE exchange
    on ``moe_transport``, default ``xla``) with ``step_overrides``."""
    from repro_torch.configs import get_config
    from repro_torch.dist.steps import StepConfig, TransportPolicy

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    over = dict(step_overrides or {})
    if grad_bucket_kb:
        over["grad_bucket_bytes"] = grad_bucket_kb << 10
    scfg = StepConfig(transport=TransportPolicy(
        tp=tp_transport or "xla", moe=moe_transport or "xla",
        moe_stream_chunks=moe_stream_chunks), **over)
    return cfg, scfg


def free_memory(group) -> Dict[str, int]:
    """Free this rank's cached device memory (and its Python garbage);
    returns what the allocator still holds, in bytes."""
    import gc

    gc.collect()
    if group.device.type != "cuda":
        return {"allocated": 0, "reserved": 0}
    torch.cuda.synchronize(group.device)
    torch.cuda.empty_cache()
    return {"allocated": torch.cuda.memory_allocated(group.device),
            "reserved": torch.cuda.memory_reserved(group.device)}


def _grid_of(group, grid: Dict[str, int]):
    """This rank's grid (``launch.mesh.make_host_mesh``) over the world
    ``group``, and its device."""
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(group, **grid), group.device


class _Batches:
    """A data source of given numpy batches: step k takes the k-th."""

    def __init__(self, batches: Sequence[Dict[str, np.ndarray]]):
        self.batches = batches

    def global_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch: token ids as int64, a frontend's
        embeddings as they are."""
        out = {}
        for k, a in self.batches[step].items():
            t = torch.from_numpy(np.asarray(a))
            out[k] = t if t.is_floating_point() else t.long()
        return out


def train_grid(group, arch: str, *, steps: int, ckpt_dir: str,
               data: int = 1, model: int = 1, expert: int = 1,
               ckpt_interval: int = 50, reduced: bool = False,
               cfg_overrides: Optional[Dict[str, Any]] = None,
               step_overrides: Optional[Dict[str, Any]] = None,
               tp_transport: Optional[str] = None,
               moe_transport: Optional[str] = None,
               moe_stream_chunks: Optional[int] = None,
               grad_bucket_kb: int = 0,
               dataset: Optional[Dict[str, int]] = None,
               batches: Optional[Sequence[Dict[str, np.ndarray]]] = None,
               resume_check: bool = False, profile: bool = False,
               preempt_at: Optional[Tuple[int, int]] = None,
               log: bool = True, cleanup: bool = False) -> Dict[str, Any]:
    """Run the ``Trainer`` for ``steps`` steps on this rank's ``data ×
    model`` (or ``data × expert``) grid, checkpointing every
    ``ckpt_interval`` steps into ``ckpt_dir`` (``launch/train.py``'s
    rank task), the model line's TP on ``tp_transport`` (default the
    reference's ``xla``).  Data: the given numpy ``batches`` (step k takes
    ``batches[k]``), or ``SyntheticLM(DataConfig(vocab_size,
    **dataset))``.  World rank 0 prints the Trainer's log with ``log``.

    With ``resume_check`` it runs the restart protocol instead: a
    Trainer to ``steps − 1`` (its last checkpoint there), the
    uninterrupted next step by the same step function on its state, then
    a fresh Trainer that restores that checkpoint, takes the step and
    writes its final checkpoint; ``resumed`` says whether the two steps'
    losses and every leaf agree bit for bit.  The uninterrupted
    step's wall time is ``next_seconds`` (its cc_matmul launches
    ``next_launches``, its lines' stats ``next_line_stats``), and with
    ``profile`` (on the card) it runs under ``torch.profiler``
    (``profile``: its device-time summary, as :func:`train`'s).
    ``cleanup`` removes ``ckpt_dir`` at the end (world rank 0).  Each
    Trainer runs with its SIGTERM handler installed (the rank's previous
    one comes back after it); ``preempt_at=(rank, step)`` has world rank
    ``rank`` send itself SIGTERM after that step, as a scheduler
    preempting one host would.

    Returns the ``history`` (with ``resume_check``: the first Trainer's
    and the resumed step), the step's ``line_stats``, ``rep_wire`` (as
    :func:`train`'s) and cc_matmul ``launches`` each step (the
    uninterrupted step's ``next_rep_wire``), ``ckpt_seconds``,
    ``restore_seconds``, the
    device's peak memory, the grid's ``coords`` and
    ``shape``, the TP path (``scheme``, ``dist.steps.tp_scheme``), and
    the sha256 of every leaf after the last step (``digests``)."""
    import os
    import shutil
    import signal

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import sharding
    from repro_torch.dist.steps import tp_scheme
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg, scfg = _train_setup(
        arch, reduced=reduced, cfg_overrides=cfg_overrides,
        step_overrides=step_overrides, tp_transport=tp_transport,
        moe_transport=moe_transport,
        moe_stream_chunks=moe_stream_chunks, grad_bucket_kb=grad_bucket_kb)
    mesh, dev = _grid_of(group, dict(data=data, model=model, expert=expert))
    source = (_Batches(batches) if batches is not None else SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, **(dataset or {}))))
    say = print if (log and group.rank == 0) else (lambda _msg: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out: Dict[str, Any] = {"line_stats": [], "launches": [], "rep_wire": [],
                           "coords": mesh.coords, "shape": mesh.shape,
                           "scheme": tp_scheme(cfg, scfg, mesh.inner.size)}
    snap = {"lines": mesh.line_stats()}
    active: Dict[str, "Trainer"] = {}

    def on_step(step, m):
        lines = mesh.line_stats()
        out["line_stats"].append(_stats_delta(snap["lines"], lines))
        out["rep_wire"].append(dict(active["t"].step_fn.rep_wire))
        out["launches"].append(cc_ops.launches())
        cc_ops.reset_counts()
        snap["lines"] = mesh.line_stats()
        if preempt_at == (group.rank, step):
            os.kill(os.getpid(), signal.SIGTERM)

    def run(t: "Trainer"):
        active["t"] = t
        previous = t.install_signal_handler()
        try:
            return t.train(on_step=on_step)
        finally:
            signal.signal(signal.SIGTERM, previous)

    def trainer(total: int) -> "Trainer":
        return Trainer(cfg, scfg, TrainerConfig(
            total_steps=total, ckpt_dir=ckpt_dir,
            ckpt_interval=ckpt_interval), source, mesh, log_fn=say)

    first = trainer(steps - 1 if resume_check else steps)
    cc_ops.reset_counts()
    params, opt, step = run(first)
    history = list(first.history)
    ckpt_s = list(first.ckpt_seconds)
    out["restore_seconds"] = first.restore_seconds
    if resume_check:
        snap["lines"] = mesh.line_stats()
        batch = source.global_batch(step)
        cc_ops.reset_counts()
        prof = None
        if profile and dev.type == "cuda":
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        _sync(dev)
        t = time.perf_counter()
        _, _, m_next = first.step_fn(params, opt, batch, step)
        _sync(dev)
        out["next_seconds"] = time.perf_counter() - t
        if prof is not None:
            prof.__exit__(None, None, None)
            out["profile"] = _device_summary(prof)
        out["next_launches"] = cc_ops.launches()
        out["next_line_stats"] = _stats_delta(snap["lines"],
                                              mesh.line_stats())
        out["next_rep_wire"] = dict(first.step_fn.rep_wire)
        snap["lines"] = mesh.line_stats()
        want = {"/".join(map(str, p)): _digest(t)
                for p, t in sharding.leaves((params, opt["mu"], opt["nu"],
                                             opt.get("master", [])))}
        del params, opt, first
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cc_ops.reset_counts()
        second = trainer(steps)
        params, opt, step = run(second)
        history.append(second.history[-1])
        ckpt_s += second.ckpt_seconds
        out["restore_seconds"] = second.restore_seconds
        got = {"/".join(map(str, p)): _digest(t)
               for p, t in sharding.leaves((params, opt["mu"], opt["nu"],
                                            opt.get("master", [])))}
        out["uninterrupted"] = {k: float(v) for k, v in m_next.items()}
        out["resumed"] = (got == want and float(m_next["loss"])
                          == second.history[-1]["loss"])
    out.update(
        history=history, ckpt_seconds=ckpt_s,
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else 0),
        digests={"/".join(map(str, p)): _digest(t)
                 for p, t in sharding.leaves(params)})
    del params, opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if cleanup:
        mesh.world.barrier()
        if group.rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def grid_sync(group, arch: str, *, data: int, model: int = 1,
              expert: int = 1, bucket_bytes: int,
              cfg_overrides: Optional[Dict[str, Any]] = None,
              step_overrides: Optional[Dict[str, Any]] = None,
              tp_transport: Optional[str] = None,
              dataset: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """The data line's sync of this rank's step-0 gradients (the train
    step's ``local_grads`` on ``build_init``'s parameters and batch 0):
    exact by the step's own sync of its packed buckets
    (``dist.grad_sync.mean_buckets``, the packing untimed), then
    ``bucketed_cross_pod_all_reduce`` compressed, bulk and streamed, on
    the step's ``cross_pod`` transport.
    Returns each run's sent and staged bytes and wire seconds on the data
    line, the compressed runs' sha256 (mean and residual), the largest
    |compressed − exact mean| and |residual|, the line's max |g| / 127
    (``scale``), and the buckets' ``bucket_wire_bytes`` both ways."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import bucketing, grad_sync
    from repro_torch.dist.steps import build_init, build_train_step

    cfg, scfg = _train_setup(arch, reduced=False,
                             cfg_overrides=cfg_overrides,
                             step_overrides=step_overrides,
                             tp_transport=tp_transport)
    mesh, dev = _grid_of(group, dict(data=data, model=model, expert=expert))
    params, opt = build_init(cfg, mesh, scfg)(0)
    del opt
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   **(dataset or {}))).global_batch(0)
    grads, _ = build_train_step(cfg, mesh, scfg).local_grads(params, batch)
    del params
    line = mesh.data
    gmax = max(float(g.abs().max()) for g in grads)
    scale = float(line.all_gather(
        torch.tensor([gmax], dtype=torch.float64), 0).max()) / 127
    transport = scfg.resolved_transport().cross_pod
    plan = bucketing.bucket_plan(grads, target_bytes=bucket_bytes)
    out: Dict[str, Any] = {"scale": scale, "runs": {}}
    exact = None
    for name, compressed, streamed in (("exact", False, True),
                                       ("int8 bulk", True, False),
                                       ("int8 streamed", True, True)):
        bufs = None if compressed else bucketing.pack(grads, plan)
        before = dict(line.stats)
        _sync(dev)
        t = time.perf_counter()
        if compressed:
            synced, res = grad_sync.bucketed_cross_pod_all_reduce(
                grads, line, bucket_bytes=bucket_bytes, compressed=True,
                transport=transport, streamed=streamed)
        else:
            # the step's own sync of its packed buckets
            synced = grad_sync.mean_buckets(bufs, line, transport=transport)
        _sync(dev)
        run = {"seconds": time.perf_counter() - t}
        run.update({k: line.stats[k] - before[k]
                    for k in ("sent_bytes", "staged_bytes", "wire_s")})
        if exact is None:
            exact = bucketing.unpack(synced, plan, torch.float32)
            synced = res = []
        else:
            run["digest"] = [_digest(x) for x in synced + res]
            run["max_err"] = max(float((a - b).abs().max())
                                 for a, b in zip(synced, exact))
            run["max_residual"] = max(float(r.abs().max()) for r in res)
        del synced, res, bufs
        out["runs"][name] = run
    for name, compressed in (("wire_fp32", False), ("wire_int8", True)):
        out[name] = sum(grad_sync.bucket_wire_bytes(
            plan.bucket_elements(), compressed=compressed))
    out["elements"] = sum(plan.bucket_elements())
    out["coords"] = mesh.coords
    del grads, exact
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def cross_pod_op(group, pods: Dict[str, np.ndarray], *, data: int,
                 model: int, compressed: bool = False,
                 bucket_bytes: Optional[int] = None, streamed: bool = True,
                 transport: str = "ring",
                 ef: Optional[Dict[str, np.ndarray]] = None
                 ) -> Dict[str, Any]:
    """``dist/grad_sync.py`` on the outer (``data``) line of a ``data ×
    model`` grid: the rank at outer coordinate p passes ``pods[k][p]`` for
    each leaf k (and ``ef[k][p]``), leaf by leaf, or with
    ``bucket_bytes`` bucketed (``streamed`` or bulk).  Returns the synced
    leaves and residuals (numpy) and the bytes this rank sent on the
    line."""
    from repro_torch.dist import grad_sync
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(group, data=data, model=model)
    p, line = mesh.coords[0], mesh.data
    grads = {k: _tensor(v[p], group.device) for k, v in pods.items()}
    residual = None if ef is None else {
        k: _tensor(v[p], group.device) for k, v in ef.items()}
    sent = line.stats["sent_bytes"]
    if bucket_bytes is None:
        synced, res = grad_sync.cross_pod_all_reduce(
            grads, line, compressed=compressed, transport=transport,
            ef=residual)
    else:
        synced, res = grad_sync.bucketed_cross_pod_all_reduce(
            grads, line, bucket_bytes=bucket_bytes, compressed=compressed,
            transport=transport, ef=residual, streamed=streamed)
    return {"synced": {k: _numpy(v) for k, v in synced.items()},
            "ef": {k: _numpy(v) for k, v in res.items()},
            "sent_bytes": line.stats["sent_bytes"] - sent,
            "coords": mesh.coords}


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def all_to_all_grad(group, transport: str, xs: np.ndarray, gs: np.ndarray,
                    chunk_bytes: Optional[int] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rank r: ``y = Conduit(group, transport).all_to_all(xs[r])`` under
    autograd, backward with the cotangent ``gs[r]``; returns (y, the
    gradient of ``xs[r]``, the same conduit's all_to_all of ``gs[r]``)."""
    from repro_torch.core.conduit import Conduit

    c = Conduit(axis=group, transport=transport, chunk_bytes=chunk_bytes)
    x = _tensor(xs[group.rank], group.device).requires_grad_(True)
    g = _tensor(gs[group.rank], group.device)
    y = c.all_to_all(x)
    y.backward(g)
    return _numpy(y), _numpy(x.grad), _numpy(c.all_to_all(g))


def _ep_layer(group, cfg, moe_params: Dict[str, Any], x: Any,
              cotangent: Any, transport: str,
              stream_chunks: Optional[int]):
    """One MoE layer by expert parallelism on this rank's rows of the
    global ``x`` (B, S, D), from the whole layer's ``moe_params`` (this
    rank keeps its expert shard), backward with its rows of
    ``cotangent`` when given.  Returns (y, this rank's parameters by
    path, its rows of x, the time of the forward and of the backward)."""
    from repro_torch.dist import sharding
    from repro_torch.dist.steps import split_rows
    from repro_torch.models.moe_ep import build_moe_ep_runner

    dev = group.device
    rows = split_rows(x.shape[0], group)
    full = sharding.map_leaves(lambda _, a: _tensor(a, dev), moe_params)
    p = sharding.shard_tree({"moe": full}, group.rank, group.size,
                            "expert")["moe"]
    p = sharding.map_leaves(lambda _, t: t.detach().requires_grad_(True), p)
    x_loc = _tensor(x, dev)[rows].clone().requires_grad_(True)
    runner = build_moe_ep_runner(cfg, group, transport=transport,
                                 stream_chunks=stream_chunks)
    _sync(dev)
    t0 = time.perf_counter()
    y = runner(cfg, p, x_loc)
    _sync(dev)
    fwd_s, bwd_s = time.perf_counter() - t0, 0.0
    if cotangent is not None:
        t0 = time.perf_counter()
        (y.float() * _tensor(cotangent, dev)[rows].float()).sum().backward()
        _sync(dev)
        bwd_s = time.perf_counter() - t0
    return y, p, x_loc, fwd_s, bwd_s


def moe_ep_layer(group, cfg, moe_params: Dict[str, np.ndarray],
                 x: np.ndarray, *, transport: str,
                 cotangent: Optional[np.ndarray] = None,
                 stream_chunks: Optional[int] = None,
                 probe: bool = False) -> Dict[str, Any]:
    """``models/moe_ep.py``'s runner over the group on this rank's rows of
    ``x`` (numpy, the whole layer's ``moe_params`` as the reference's
    numpy tree): returns ``y`` (its rows), and with ``cotangent`` the
    gradients (``grads`` by path, this rank's part: its expert shard's
    whole gradient, its tokens' share of a replicated leaf's, and its
    rows of x's).  ``probe`` dispatches through a counting transport
    registered for the call in front of ``transport``: ``calls`` lists
    the elements of every all_to_all it carried."""
    from repro_torch.core import conduit
    from repro_torch.dist import sharding

    calls: List[int] = []
    if probe:
        inner = conduit.resolve("all_to_all", transport)

        @conduit.register("all_to_all", "probe")
        def _probe(v, *, axis, chunk_bytes=None):
            calls.append(v.numel())
            return inner(v, axis=axis, chunk_bytes=chunk_bytes)

    try:
        y, p, x_loc, _, _ = _ep_layer(group, cfg, moe_params, x, cotangent,
                                      "probe" if probe else transport,
                                      stream_chunks)
    finally:
        if probe:
            conduit.unregister("all_to_all", "probe")
    out: Dict[str, Any] = {"y": _numpy(y), "calls": calls}
    if cotangent is not None:
        out["grads"] = {"/".join(map(str, k)): _numpy(t.grad)
                        for k, t in sharding.leaves(p)}
        out["x_grad"] = _numpy(x_loc.grad)
    return out


def _errors(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    d = (got.float() - want.float())
    w = want.float()
    return {"max_abs": float(d.abs().max()), "ref_max": float(w.abs().max()),
            "rel_fro": float(d.norm() / w.norm().clamp_min(1e-30))}


def moe_ep_layer_check(group, cfg, moe_params: Dict[str, Any], x: Any,
                       cotangent: Any, want: Dict[str, Any], *,
                       transport: str) -> Dict[str, Any]:
    """The EP layer's forward and backward on this rank (as
    :func:`moe_ep_layer`) held to the dense layer's results ``want`` (the
    whole batch's ``y``, ``x_grad``, ``idx`` and ``keep``, and the whole
    parameters' ``grads`` by path, from ``layers.moe`` and its autograd;
    tensors on the card may come through CUDA IPC), on this rank's
    device.  A replicated leaf's gradient is summed over the group before
    it is compared.  Returns each tensor's errors (``_errors``), whether
    the routing (``idx``, ``keep``) equals the dense layer's on the
    rank's rows, the forward and backward seconds, the wire seconds and
    the peak device memory."""
    from repro_torch.dist import sharding
    from repro_torch.dist.steps import split_rows
    from repro_torch.models import layers as L

    dev = group.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    wire0 = group.stats["wire_s"]
    y, p, x_loc, fwd_s, bwd_s = _ep_layer(group, cfg, moe_params, x,
                                          cotangent, transport, None)
    wire_s = group.stats["wire_s"] - wire0
    rows = split_rows(x.shape[0], group)
    e_loc = cfg.n_experts // group.size
    experts = slice(group.rank * e_loc, (group.rank + 1) * e_loc)
    with torch.no_grad():
        _, idx, keep, _, _ = L.moe_route(cfg, p["router"],
                                         x_loc.to(L.cdtype(cfg)))
        errs = {"y": _errors(y, _tensor(want["y"], dev)[rows]),
                "x_grad": _errors(x_loc.grad,
                                  _tensor(want["x_grad"], dev)[rows])}
        for path, t in sharding.leaves(p):
            name = "/".join(map(str, path))
            w = _tensor(want["grads"][name], dev)
            if sharding.placement(("moe",) + path, "expert") == "expert":
                g, w = t.grad, w[experts]
            else:
                g = group.all_reduce(t.grad)
            errs[name] = _errors(g, w)
        same_idx = bool(torch.equal(idx, _tensor(want["idx"], dev)[rows]))
        same_keep = bool(torch.equal(keep, _tensor(want["keep"], dev)[rows]))
    out = {"errors": errs, "same_idx": same_idx, "same_keep": same_keep,
           "kept": int(keep.sum()), "choices": keep.numel(),
           "forward_s": fwd_s, "backward_s": bwd_s, "wire_s": wire_s,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0)}
    del y, p, x_loc
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def ep_serve(group, arch: str, prompts: np.ndarray, *, steps: int,
             transport: str = "xla", reduced: bool = False,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             params_np: Optional[Dict[str, Any]] = None, seed: int = 0,
             feed: Optional[np.ndarray] = None,
             cache_len: Optional[int] = None,
             profile_step: Optional[int] = None) -> Dict[str, Any]:
    """A MoE model served by expert parallelism: this rank's rows of the
    global ``prompts`` (B, S) (``dist/steps.split_rows``) through bulk
    prefill with the EP runner, then ``steps`` decode steps through
    ``serve_step`` with the EP decode runner (``moe_decode_runner``), the
    next tokens greedy or, with ``feed`` (steps, B), this rank's rows of
    ``feed[k]`` (the same inputs as another run).

    Parameters: the reference's whole pytree ``params_np`` (this rank
    keeps its expert shard), or the draw of ``models.model.init_params``
    from ``seed`` on this rank's device, each layer cut to the rank's
    shard as it is drawn (every rank draws the same numbers).

    Returns the rank's prefill logits and each step's logits (fp32) and
    greedy ids, each decode step's wall seconds and wire seconds, the
    flash launches of prefill, the peak device memory, and with
    ``profile_step`` that step's device summary (``_device_summary``:
    its kernel spans on the host clock)."""
    from repro_torch.bridge import shard_params
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.dist.steps import (
        TransportPolicy,
        moe_decode_runner,
        serve_step,
        split_rows,
    )
    from repro_torch.kernels.flash_attention import FLASH
    from repro_torch.models.model import init_params
    from repro_torch.models.moe_ep import build_moe_ep_runner
    from repro_torch.models.prefill import prefill

    dev = group.device
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if params_np is not None:
        params = shard_params(params_np, group.rank, group.size, dev,
                              "expert")
    else:
        params = init_params(cfg, seed, dev, layer_fn=lambda layer:
                             sharding.shard_tree(layer, group.rank,
                                                 group.size, "expert"))
    rows = split_rows(prompts.shape[0], group)
    toks = torch.as_tensor(np.asarray(prompts)[rows], dtype=torch.long,
                           device=dev)
    prefill_runner = build_moe_ep_runner(cfg, group, transport=transport)
    decode_runner = moe_decode_runner(cfg, group,
                                      TransportPolicy(moe=transport))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    out: Dict[str, Any] = {k: [] for k in ("logits", "ids", "seconds",
                                          "wire_s")}
    with torch.no_grad():
        flash0 = FLASH.launches
        cache, logits = prefill(cfg, params, toks,
                                cache_len=cache_len or toks.shape[1] + steps,
                                moe_ffn=prefill_runner)
        _sync(dev)
        out["prefill_flash_launches"] = FLASH.launches - flash0
        out["prefill_logits"] = _numpy(logits)
        for k in range(steps):
            nxt = (torch.argmax(logits, dim=-1) if feed is None else
                   torch.as_tensor(np.asarray(feed[k])[rows],
                                   dtype=torch.long, device=dev))
            group.barrier()
            wire0 = group.stats["wire_s"]
            prof = None
            if k == profile_step and dev.type == "cuda":
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            cache, logits = serve_step(cfg, params, cache, nxt.long(),
                                       moe_runner=decode_runner,
                                       sample=False)
            _sync(dev)
            out["seconds"].append(time.perf_counter() - t0)
            if prof is not None:
                prof.__exit__(None, None, None)
                out["profile"] = _device_summary(prof)
            out["wire_s"].append(group.stats["wire_s"] - wire0)
            out["logits"].append(_numpy(logits))
            out["ids"].append(_numpy(torch.argmax(logits, dim=-1)))
    out["n_params"] = sum(t.numel() for _, t in sharding.leaves(params))
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    del params, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the PGAS substrate
# ---------------------------------------------------------------------------


def scale_handler(heap, args, payload):
    """The quickstart's ``SCALE`` request handler (the DLA pattern: an AM
    invoking a compute handler): 16 words at ``args[0]`` times
    ``args[1]``, stored at ``args[2]``."""
    from repro_torch.core.am import make_args
    from repro_torch.core.pgas import _start

    src = _start(args[0], 16, heap.numel())
    dst = _start(args[2], 16, heap.numel())
    inbox = heap[src:src + 16].clone()
    heap[dst:dst + 16] = inbox * float(int(args[1]))
    return heap, 0, make_args(), torch.zeros_like(payload)


def accum_handler(heap, args, payload):
    """``ACCUM`` request handler: adds the payload into the heap at
    ``args[0]``."""
    from repro_torch.core.am import make_args
    from repro_torch.core.pgas import _start

    n = payload.numel()
    s = _start(args[0], n, heap.numel())
    heap[s:s + n] += payload.reshape(-1).to(heap.dtype)
    return heap, 0, make_args(), torch.zeros_like(payload)


def am_registry():
    """The built-ins, then ``SCALE`` (opcode 2) and ``ACCUM`` (opcode 3)."""
    from repro_torch.core.am import HandlerRegistry

    reg = HandlerRegistry()
    reg.register_request("SCALE", scale_handler)
    reg.register_request("ACCUM", accum_handler)
    return reg


def _heap_on(group, heap, device):
    """A zeroed partition: the group's (mapped on a card group with peer
    memory), or a plain one on ``device`` when given."""
    from repro_torch.core.pgas import GlobalAddressSpace

    if device is not None:
        return heap.zeros_local(device)
    return GlobalAddressSpace(group, heap).zeros_local()


def pgas_program(group, size: int, symbols: Sequence, ops: Sequence,
                 init: Optional[np.ndarray] = None,
                 device: Optional[str] = None) -> Dict[str, Any]:
    """Run ``ops`` on a symmetric heap of ``size`` fp32 words with
    ``symbols`` (``(name, words)`` in allocation order), starting from
    ``init[rank]`` (zeros when ``None``).  Each op is a tuple whose first
    entry names it; per-rank payloads are arrays indexed by rank:

    ``("put", payloads, offset, perm)``, ``("put_slice", src, length,
    offset, perm)`` (the payload is a slice of the sender's own heap),
    ``("put_ring", payloads, offset, shift)``, ``("get", offset, size,
    perm)``, ``("write_symbol", name, payloads, perm)``, ``("write_block",
    name, block_words, payloads, bid, perm)``, ``("read_symbol", name,
    perm)``, ``("gasnet_put", payloads, offset, perm)``, ``("gasnet_get",
    src, dst, size, perm)``, ``("am", opcode, args, payloads, perm)``,
    ``("am_short", handler, args, perm)``, ``("am_medium", handler, args,
    payloads, perm)``, ``("am_long", handler, args, payloads, offset,
    perm)``.

    Returns the final heap and, in order, what each GET, read and medium
    AM delivered (fp32 numpy)."""
    from repro_torch.core import am, pgas

    heap = pgas.SymmetricHeap(size)
    for name, words in symbols:
        heap.alloc(name, words)
    gas = pgas.GlobalAddressSpace(group, heap)
    h = _heap_on(group, heap, device)
    if init is not None:
        h.copy_(_tensor(init[group.rank], h.device))
    reg = am_registry()
    my, kw = group.rank, dict(group=group)

    def mine(payloads):
        return _tensor(payloads[my], h.device)

    outs = []
    for op in ops:
        kind, rest = op[0], op[1:]
        if kind == "put":
            payloads, off, perm = rest
            pgas.put(h, mine(payloads), off, perm=perm, **kw)
        elif kind == "put_slice":
            src, length, off, perm = rest
            pgas.put(h, h[src:src + length], off, perm=perm, **kw)
        elif kind == "put_ring":
            payloads, off, shift = rest
            pgas.put_ring(h, mine(payloads), off, shift=shift, **kw)
        elif kind == "get":
            off, n, perm = rest
            outs.append(pgas.get(h, off, n, perm=perm, **kw))
        elif kind == "write_symbol":
            name, payloads, perm = rest
            gas.write_symbol(name, perm=perm)(h, mine(payloads))
        elif kind == "write_block":
            name, block_words, payloads, bid, perm = rest
            gas.write_block(name, block_words, perm=perm)(h, mine(payloads),
                                                          bid)
        elif kind == "read_symbol":
            name, perm = rest
            outs.append(gas.read_symbol(name, perm=perm)(h)[1])
        elif kind == "gasnet_put":
            payloads, off, perm = rest
            am.gasnet_put(reg, h, mine(payloads), off, perm=perm, **kw)
        elif kind == "gasnet_get":
            src, dst, n, perm = rest
            am.gasnet_get(reg, h, src, dst, n, perm=perm, **kw)
        elif kind == "am":
            opcode, args, payloads, perm = rest
            am.am_request(reg, h, opcode, am.make_args(*args),
                          mine(payloads), perm=perm, **kw)
        elif kind == "am_short":
            name, args, perm = rest
            am.am_request_short(reg, h, reg.request_opcode(name),
                                am.make_args(*args), perm=perm, **kw)
        elif kind == "am_medium":
            name, args, payloads, perm = rest
            _, scratch = am.am_request_medium(
                reg, h, reg.request_opcode(name), am.make_args(*args),
                mine(payloads), perm=perm, **kw)
            outs.append(scratch)
        elif kind == "am_long":
            name, args, payloads, off, perm = rest
            am.am_request_long(reg, h, reg.request_opcode(name),
                               am.make_args(*args), mine(payloads), off,
                               perm=perm, **kw)
        else:
            raise ValueError(f"unknown PGAS op {kind!r}")
    _sync(h.device)
    return {"heap": _numpy(h), "outputs": [_numpy(o) for o in outs],
            "device": str(h.device), "peer": group.peer is not None
            and h.device.type == "cuda"}


def heap_churn(group, programs: int, words: int) -> Dict[str, Any]:
    """``programs`` heaps of ``words`` fp32 words, one after the other on
    the group's device, each filled by a ring PUT, read back and dropped.
    Returns, after each mapping, how many partitions the group's peer
    memory holds (the next mapping frees the heap gone before it, so 1
    each time on a peer group), and whether every read-back held."""
    from repro_torch.core import pgas

    gas = pgas.GlobalAddressSpace(group, pgas.SymmetricHeap(words))
    held, ok = [], True
    for i in range(programs):
        h = gas.zeros_local()
        if group.peer is not None:
            held.append(len(group.peer.partitions))
        pgas.put_ring(h, torch.full((words,), i + 1.0, device=h.device), 0,
                      group=group)
        ok = ok and bool((h == i + 1.0).all())
        del h
    return {"partitions": held, "read_back": ok}


def quickstart_inputs(seed: int = 0):
    """The quickstart's ART operands: M (64, 32) and N (32, 64), fp32,
    from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((64, 32)).astype(np.float32),
            rng.standard_normal((32, 64)).astype(np.float32))


def quickstart(group, seed: int = 0, device: Optional[str] = None
               ) -> Dict[str, Any]:
    """The quickstart on this rank (every rank runs it): a 64-word heap
    with ``inbox`` and ``result`` (16 words each); a ring PUT of
    ``rank + 1`` into the next rank's inbox; a short ``SCALE`` AM from
    rank 0 to rank 2 (inbox × 10 into result); the ART matmul of M and N
    split over the group (4 chunks).  Returns the heap after the PUT and
    at the end, this rank's ART column block, and its max error against
    the same block of ``M @ N`` in float64 on the host."""
    from repro_torch.core import am, art, pgas

    heap = pgas.SymmetricHeap(64)
    heap.alloc("inbox", 16)
    heap.alloc("result", 16)
    gas = pgas.GlobalAddressSpace(group, heap)
    h = _heap_on(group, heap, device)
    n, my = group.size, group.rank

    def ring_put(h):
        payload = torch.full((16,), my + 1.0, device=h.device)
        return pgas.put(h, payload, heap.addr("inbox"), group=group,
                        perm=[(i, (i + 1) % n) for i in range(n)])

    gas.run(ring_put)(h)
    after_put = _numpy(h.clone())

    reg = am.HandlerRegistry()
    scale = reg.register_request("SCALE", scale_handler)

    def send_compute(h):
        args = am.make_args(heap.addr("inbox"), 10, heap.addr("result"))
        return am.am_request_short(reg, h, scale, args, group=group,
                                   perm=[(0, 2)])

    gas.run(send_compute)(h)

    m, nn = quickstart_inputs(seed)
    k = m.shape[1] // n
    c = nn.shape[1] // n
    got = art.art_matmul_reducescatter(
        _tensor(m[:, my * k:(my + 1) * k], h.device),
        _tensor(nn[my * k:(my + 1) * k], h.device), group=group,
        n_chunks=4)
    want = (m.astype(np.float64) @ nn.astype(np.float64))[
        :, my * c:(my + 1) * c]
    art_np = _numpy(got)
    return {"heap_after_put": after_put, "heap": _numpy(h), "art": art_np,
            "art_err": float(np.abs(art_np - want).max()),
            "peer_bytes": group.stats["peer_bytes"],
            "device": str(h.device),
            "peer": group.peer is not None and h.device.type == "cuda"}


def put_get_sweep(group, sizes_words: Sequence[int], heap_words: int,
                  iters: int = 20, store_iters: int = 50
                  ) -> List[Dict[str, Any]]:
    """PUT from rank 0 into rank 1's heap, then GET of it back by rank 0,
    at each size, on a ``heap_words`` fp32 heap (the other ranks take
    part in the collectives and move nothing).  Per size: the whole
    collective call (barriers included, host clock on rank 0, each call
    ending in its own synchronise and barrier), and the transfer alone —
    on peer memory the one copy into (PUT) or out of (GET) the peer's
    partition, by CUDA events on rank 0, the rank that issues it; over the
    wire one ``Group.permute`` of the payload (staging included, host
    clock on the receiving rank).  Every PUT is read back on rank 1 and
    every GET checked on rank 0.  Rank 0 returns the rows; the others an
    empty list."""
    from repro_torch.core import pgas
    from repro_torch.core.pgas import _settle

    heap = pgas.SymmetricHeap(heap_words)
    h = _heap_on(group, heap, None)
    dev, my = h.device, group.rank
    peer = pgas._peer_views(group, h)
    put_perm, get_perm = [(0, 1)], [(0, 1)]   # get: (requester, source)
    rows = []
    for i, words in enumerate(sizes_words):
        payload = (torch.arange(words, device=dev, dtype=torch.float32)
                   % 997 + i + 0.5)
        n_calls = iters if words * 4 <= (1 << 21) else max(3, iters // 4)

        def timed_calls(fn):
            _settle(group, dev)
            t = time.perf_counter()
            for _ in range(n_calls):
                out = fn()
            _sync(dev)
            return (time.perf_counter() - t) / n_calls, out

        put_s, _ = timed_calls(lambda: pgas.put(
            h, payload, 0, group=group, perm=put_perm))
        ok_put = bool(torch.equal(h[:words], payload)) if my == 1 else True
        get_s, got = timed_calls(lambda: pgas.get(
            h, 0, words, group=group, perm=get_perm))
        ok_get = bool(torch.equal(got, payload)) if my == 0 else True
        if peer is not None:
            put_alone = _event_s(dev, store_iters, lambda: peer[1][:words]
                                 .copy_(payload)) if my == 0 else 0.0
            buf = torch.empty_like(payload)
            get_alone = _event_s(dev, store_iters, lambda: buf.copy_(
                peer[1][:words])) if my == 0 else 0.0
            _settle(group, dev)
        else:
            put_alone = _permute_s(group, payload, put_perm, n_calls, 1)
            get_alone = _permute_s(group, payload, [(1, 0)], n_calls, 0)
        oks = group.all_reduce(torch.tensor([int(ok_put and ok_get)],
                                            dtype=torch.int32))
        alone = torch.tensor([put_alone, get_alone], dtype=torch.float64)
        alone = group.all_reduce(alone)      # only one rank's is nonzero
        rows.append(dict(words=int(words), bytes=int(words) * 4,
                         put_s=put_s, get_s=get_s,
                         put_alone_s=float(alone[0]),
                         get_alone_s=float(alone[1]),
                         read_back=int(oks.item()) == group.size))
    return rows if my == 0 else []


def _event_s(dev, iters: int, fn) -> float:
    """Seconds a call of ``fn`` takes on the card: CUDA events around
    ``iters`` calls after a warm-up, averaged."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _permute_s(group, payload, perm, iters: int, receiver: int) -> float:
    """Seconds one ``Group.permute`` of ``payload`` over ``perm`` takes,
    on the receiving rank's host clock (staging and a synchronise
    included); 0 on the other ranks."""
    from repro_torch.core.pgas import _settle

    _settle(group, payload.device)
    t = time.perf_counter()
    for _ in range(iters):
        group.permute(payload, perm)
        _sync(payload.device)
    s = (time.perf_counter() - t) / iters
    return s if group.rank == receiver else 0.0


def case_study(group, sizes: Sequence[int], n_chunks: int,
               conv_sets: Sequence[Tuple[int, int]] = (), fmap: int = 64,
               batches: Sequence[int] = (1,), seed: int = 0,
               iters: int = 3) -> Dict[str, Any]:
    """The paper's Sec. V on this rank: for each size, M and N (fp32,
    drawn from ``seed`` on the group's device, the same on every rank),
    this rank's column block of M and row block of N through
    :func:`art_matmul_reducescatter` (``n_chunks``) and
    :func:`bulk_matmul_reducescatter`, each against this rank's block of
    one ``torch.matmul`` of M and N (max error over max |want|) and timed
    (the group's wall time a call, the slowest rank).  Then
    :func:`split_conv_allgather` for each ``(Cout, k)`` set (Cin = Cout,
    ``fmap``² images, VALID) at each batch, against one ``conv2d`` of all
    the kernels.  TF32 off."""
    from repro_torch.core import art

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, n, my = group.device, group.size, group.rank
    out: Dict[str, Any] = {"matmul": [], "conv": []}
    for size in sizes:
        gen = torch.Generator(device=dev).manual_seed(seed + size)
        m = torch.randn((size, size), generator=gen, device=dev)
        nn = torch.randn((size, size), generator=gen, device=dev)
        k = size // n
        m_cols = m[:, my * k:(my + 1) * k].contiguous()
        n_rows = nn[my * k:(my + 1) * k].contiguous()
        want = torch.matmul(m, nn)[:, my * k:(my + 1) * k]
        del m, nn
        row = {"size": size}
        for name, fn in (
                ("art", lambda: art.art_matmul_reducescatter(
                    m_cols, n_rows, group=group, n_chunks=n_chunks)),
                ("bulk", lambda: art.bulk_matmul_reducescatter(
                    m_cols, n_rows, group=group))):
            got = fn()
            _sync(dev)
            row[name + "_err"] = float((got - want).abs().max()
                                       / want.abs().max())
            row[name + "_finite"] = bool(torch.isfinite(got).all())
            row[name + "_ms"] = _group_ms(group, fn, iters)
            del got
        out["matmul"].append(row)
        del m_cols, n_rows, want
    for cout, ksz in conv_sets:
        for bsz in batches:
            gen = torch.Generator(device=dev).manual_seed(seed + cout + bsz)
            imgs = torch.randn((bsz, fmap, fmap, cout), generator=gen,
                               device=dev)
            kern = torch.randn((ksz, ksz, cout, cout), generator=gen,
                               device=dev) / (ksz * ksz * cout) ** 0.5
            c = cout // n
            mine = kern[..., my * c:(my + 1) * c].contiguous()
            want = torch.nn.functional.conv2d(
                imgs.permute(0, 3, 1, 2), kern.permute(3, 2, 0, 1)
            ).permute(0, 2, 3, 1)

            def fn():
                return art.split_conv_allgather(imgs, mine, group=group)

            got = fn()
            _sync(dev)
            out["conv"].append(dict(
                cout=cout, k=ksz, batch=bsz,
                err=float((got - want).abs().max() / want.abs().max()),
                finite=bool(torch.isfinite(got).all()),
                ms=_group_ms(group, fn, iters)))
            del imgs, kern, mine, want, got
    return out


def permute_op(group, xs: np.ndarray, perm) -> np.ndarray:
    """``Group.permute`` of ``xs[rank]`` over ``perm``."""
    return _numpy(group.permute(_tensor(xs[group.rank], group.device),
                                perm))


def art_op(group, op: str, a: np.ndarray, b: np.ndarray,
           n_chunks: int = 1) -> np.ndarray:
    """Rank r runs one case-study entry point on ``a[r]``, ``b[r]``:
    ``"art"`` (``art_matmul_reducescatter``), ``"bulk"`` or ``"conv"``
    (``split_conv_allgather``; ``b[r]`` is the rank's kernel group)."""
    from repro_torch.core import art

    x, y = _tensor(a[group.rank], group.device), _tensor(b[group.rank],
                                                         group.device)
    if op == "art":
        out = art.art_matmul_reducescatter(x, y, group=group,
                                           n_chunks=n_chunks)
    elif op == "bulk":
        out = art.bulk_matmul_reducescatter(x, y, group=group)
    else:
        out = art.split_conv_allgather(x, y, group=group)
    return _numpy(out)


def art_send_op(group, chunks: np.ndarray, shift: int,
                accumulate: bool) -> np.ndarray:
    """``art_send`` with ``compute_chunk(k) = chunks[rank][k]``."""
    from repro_torch.core import art

    mine = _tensor(chunks[group.rank], group.device)
    run = art.art_send(lambda k: mine[k].clone(), mine.shape[0],
                       group=group, shift=shift, accumulate=accumulate)
    return _numpy(run())


def collective_op(group, transport: str, op: str, xs: Optional[np.ndarray],
                  chunk_bytes: Optional[int] = None, root: int = 0,
                  streamed: int = 0, dim: int = 0) -> Any:
    """Rank r runs ``Conduit(group, transport, chunk_bytes).<op>`` on
    ``xs[r]`` (``barrier`` takes none, ``broadcast`` the ``root``); with
    ``streamed`` > 0, the op runs through ``Conduit.streamed`` on that
    many pieces of ``xs[r]`` split along ``dim``, and the per-piece
    results are returned as a list."""
    from repro_torch.core import pipeline as pl
    from repro_torch.core.conduit import Conduit

    c = Conduit(axis=group, transport=transport, chunk_bytes=chunk_bytes)
    if op == "barrier":
        return _numpy(c.barrier())
    x = _tensor(xs[group.rank], group.device)
    kw = {"root": root} if op == "broadcast" else {}
    if streamed:
        return [_numpy(t) for t in c.streamed(op, pl.split(x, streamed,
                                                           dim), **kw)]
    return _numpy(getattr(c, op)(x, **kw))


__all__ = ["accum_handler", "all_to_all_grad", "am_registry", "art_op",
           "art_send_op", "case_study", "collective_grad", "collective_op",
           "ep_serve", "fused_op", "moe_ep_layer", "moe_ep_layer_check",
           "overlap_op", "permute_op",
           "pgas_program",
           "put_get_sweep", "quickstart", "quickstart_inputs",
           "ring_collectives", "ring_kernels", "ring_op", "scale_handler",
           "train"]
