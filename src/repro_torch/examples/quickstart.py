"""Quickstart: the PGAS programming model on 4 ranks.

The port's counterpart of ``examples/quickstart.py``: four rank processes
share a symmetric heap (64 words a rank), then exercise the paper's
primitives — a one-sided ring PUT, an Active Message invoking a custom
compute handler (``SCALE``, the DLA pattern) and an ART-overlapped
distributed matmul (``rank_tasks.quickstart``).  On the card the ranks
share it and map each other's partitions, so the PUT is a store into the
next rank's memory; with ``--device cpu`` they are gloo ranks on the host.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    dev = resolve_device(args.device)
    with RankPool(4, device=dev.type) as pool:
        res = pool.run(rank_tasks.quickstart)
    inbox = res[1]["heap_after_put"][:16]
    result = res[2]["heap"][16:32]
    print("after ring put, rank1 inbox head:", inbox[:4])
    print("rank2 result after AM compute:", result[:4])
    err = max(r["art_err"] for r in res)
    print(f"ART matmul max |err| vs local math: {err:.2e} "
          f"({'peer-mapped heaps' if res[0]['peer'] else 'over the wire'}, "
          f"{res[0]['device']})")
    if not (np.all(inbox == 1.0) and np.all(result == 20.0) and err < 2e-4):
        print("quickstart FAILED")
        return 1
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
