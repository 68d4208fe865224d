"""How long one hand-off between rank processes sharing the card takes:
``python -m repro_torch.kernels.cc_matmul.probe_handoff [--iters N]
[--ranks 2 4]``.

For each group size, a rank pool on the card (its ranks map each other's
memory, ``peer.PeerMemory.map_partition``) passes a token around its ring
``--iters`` times (1000) by each of three means (``csrc/probe_handoff.cu``):

* ``spin`` — one kernel a rank that polls its flag with ``ld.acquire.sys``
  and ``__nanosleep`` (the wait of the earlier whole-ring kernels): a
  rank whose predecessor has not run yet spins through its time slice;
* ``memops`` — ``cuStreamWaitValue64`` (greater or equal) on the rank's
  flag and ``cuStreamWriteValue64`` of the next rank's: a wait the card's
  front end holds in stream order (the ring's hand-off, ``ring.py``);
* ``events`` — IPC events (``cudaEventInterprocess``) with
  ``cudaStreamWaitEvent``, after a host handshake through a file every
  rank maps (a wait sees only the last record enqueued before it).

``memops`` and ``events`` put a one-thread kernel between the wait and the
hand-off, as the ring puts its hop products.  Each rank times the whole
from a barrier to its stream's end; the slowest rank's time over ``iters``
× n hand-offs is the time of one.  The token must come back as ``iters`` ×
n.  Prints the card's name and power limit, the card's stream-wait
attributes, and one JSON object a (group size, means), also written to
``chiprun_out/probe_handoff.jsonl``; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.common import REPO_ROOT, CudaKernel, current_stream

MEANS = ("spin", "memops", "events")
#: the longest one hand-off may wait before the probe gives up
TIMEOUT_S = 60.0

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_LIB = "cc_matmul/probe_handoff"
SPIN = CudaKernel(_LIB, "repro_probe_spin", [_P, _P, _P, _I, _I, _D, _P])
MEMOPS = CudaKernel(_LIB, "repro_probe_memops", [_P, _P, _P, _I, _I, _P])
EVENTS = CudaKernel(_LIB, "repro_probe_events",
                    [_P, _P, _P, _I, _I, _I, _P, _D, _P])
_EV_CREATE = CudaKernel(_LIB, "repro_probe_event_create",
                        [ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_char)])
_EV_OPEN = CudaKernel(_LIB, "repro_probe_event_open",
                      [ctypes.POINTER(ctypes.c_char), ctypes.POINTER(_P)])
_EV_DESTROY = CudaKernel(_LIB, "repro_probe_event_destroy", [_P])
_READ = CudaKernel(_LIB, "repro_probe_read", [_P, _P])


def _check(kernel: CudaKernel, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel.entry} failed with code {rc}")


def _exchange(group, raw: bytes):
    """Every rank's 64 bytes, by rank."""
    mine = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    got = [torch.empty(64, dtype=torch.uint8) for _ in range(group.size)]
    dist.all_gather(got, mine, group=group.pg)
    return [bytes(t.tolist()) for t in got]


def _host_flags(group):
    """``group.size`` int64 counters in a file every rank maps."""
    path = [None]
    if group.rank == 0:
        fd, path[0] = tempfile.mkstemp(prefix="probe_handoff_")
        os.write(fd, bytes(8 * group.size))
        os.close(fd)
    dist.broadcast_object_list(path, src=0, group=group.pg)
    return path[0], np.memmap(path[0], dtype=np.int64, mode="r+",
                              shape=(group.size,))


def handoff(group, iters: int) -> Dict[str, Any]:
    """Rank task: the token around the ring ``iters`` times by each
    means; per means the rank's milliseconds and, on rank 0, the token."""
    n, rank = group.size, group.rank
    stream = current_stream(group.device)
    out: Dict[str, Any] = {}
    for means in MEANS:
        ptrs = group.peer.map_partition(16)     # flag, token: zeroed
        mine, nxt, token = ptrs[rank], ptrs[(rank + 1) % n], ptrs[0] + 8
        first = int(rank == 0)
        if means == "events":
            ev, handle = ctypes.c_void_p(), ctypes.create_string_buffer(64)
            _check(_EV_CREATE, _EV_CREATE.fn()(ctypes.byref(ev), handle))
            handles = _exchange(group, handle.raw)
            prev_ev = ctypes.c_void_p()
            _check(_EV_OPEN, _EV_OPEN.fn()(
                ctypes.create_string_buffer(handles[(rank - 1) % n], 64),
                ctypes.byref(prev_ev)))
            path, host = _host_flags(group)
        torch.cuda.synchronize(group.device)
        dist.barrier(group=group.pg)
        t0 = time.perf_counter()
        if means == "spin":
            _check(SPIN, SPIN.fn()(mine, nxt, token, first, iters, TIMEOUT_S,
                                   stream))
        elif means == "memops":
            _check(MEMOPS, MEMOPS.fn()(mine, nxt, token, first, iters,
                                       stream))
        else:
            _check(EVENTS, EVENTS.fn()(ev, prev_ev, host.ctypes.data, rank,
                                       (rank - 1) % n, iters, token,
                                       TIMEOUT_S, stream))
        torch.cuda.synchronize(group.device)
        ms = (time.perf_counter() - t0) * 1e3
        dist.barrier(group=group.pg)
        if rank == 0:
            got = ctypes.c_ulonglong(0)
            _check(_READ, _READ.fn()(token, ctypes.byref(got)))
            out[f"{means}_token"] = got.value
        out[f"{means}_ms"] = ms
        if means == "events":
            dist.barrier(group=group.pg)
            _EV_DESTROY.fn()(prev_ev)
            _EV_DESTROY.fn()(ev)
            del host
            if rank == 0:
                os.unlink(path)
        group.peer.release_partitions([ptrs])
    return out


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=1000)
    p.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_handoff needs a CUDA device")
    from repro_torch.dist.group import RankPool
    from repro_torch.kernels.cc_matmul.peer import stream_ops
    from repro_torch.kernels.common import build

    # the rank task by its module's name, not __main__'s (spawn)
    task = importlib.import_module(
        "repro_torch.kernels.cc_matmul.probe_handoff").handoff
    build([_LIB])
    card = card_name_and_limit()
    print(f"[probe_handoff] card: {card}", flush=True)
    out = REPO_ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "probe_handoff.jsonl", "w") as log:
        def emit(rec):
            print(json.dumps(rec), flush=True)
            log.write(json.dumps(rec) + "\n")
            log.flush()

        emit(dict(card=card, **stream_ops()))
        for n in args.ranks:
            with RankPool(n, device="cuda") as pool:
                res = pool.run(task, args.iters)
            for means in MEANS:
                ms = max(r[f"{means}_ms"] for r in res)
                token = res[0][f"{means}_token"]
                emit(dict(ranks=n, means=means, iters=args.iters,
                          group_ms=ms, us_per_handoff=ms * 1e3 /
                          (args.iters * n), token=token,
                          token_ok=token == args.iters * n, card=card))
                if token != args.iters * n:
                    raise SystemExit(f"{means} at {n} ranks: token {token}, "
                                     f"expected {args.iters * n}")


if __name__ == "__main__":
    main()
