"""How often ``torch.profiler`` comes back short of a ring call's hop
records: ``python -m repro_torch.dist.probe_ring_profile [--reps N]``.

A rank pool of four on the card takes phase 7's reduce-scatter cases
(``chip_smoke.RING_CASES``) through phase 7's flow ``--reps`` times (60):
a call, the group's timing over 5 and over 20 calls, then 5 calls under
``rank_tasks._ring_profile``, the reps alternately with no margin and with
``rank_tasks.PROFILE_MARGIN_S``.  A profile is short when a rank counts
fewer than 4 hop products a call.  Prints the card's name and power limit
and one JSON object a margin (profiles of the group, short ones, each
short one's per-rank counts), also written to
``chiprun_out/probe_ring_profile.json``; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Any, Dict, List

from repro_torch.dist import rank_tasks

#: phase 7's reduce-scatter cases: (label, direction, B, b, N, K, dx, dw)
CASES = [
    ("o edge fwd", 1, 2, 512, 1280, 640, "float32", "bfloat16"),
    ("down edge fwd", -1, 2, 512, 1280, 1728, "float32", "bfloat16"),
    ("up|gate edge bwd", 1, 2, 512, 1280, 3456, "float32", "bfloat16"),
    ("ragged", -1, 2, 77, 45, 130, "bfloat16", "bfloat16"),
    ("ragged", 1, 2, 77, 45, 130, "float32", "bfloat16"),
]
CALLS = 5


def profile_counts(group, reps: int) -> List[Dict[str, Any]]:
    """This rank's hop records a call in every profile (rank task)."""
    cases = [dict(op="rs", direction=d, B=bsz, b=b, N=n, K=k, dx=dx, dw=dw)
             for _, d, bsz, b, n, k, dx, dw in CASES]
    out = []
    for rep in range(reps):
        margin = rank_tasks.PROFILE_MARGIN_S if rep % 2 else 0.0
        for i, c in enumerate(cases):
            run = rank_tasks.ring_case(group, i, c)[2]
            run()
            rank_tasks._group_ms(group, run, 5)
            rank_tasks._group_ms(group, run, 20)
            got = rank_tasks._ring_profile(group, run, CALLS, margin)
            out.append(dict(rep=rep, case=i, margin_s=margin,
                            hop_events=got["hop_events"]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=60)
    args = ap.parse_args()

    from repro_torch.dist.group import RankPool
    from repro_torch.kernels.common import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    build(["cc_matmul"])
    tp = 4
    with RankPool(tp, device="cuda") as pool:
        res = pool.run(profile_counts, args.reps)
    rows = []
    for margin in (0.0, rank_tasks.PROFILE_MARGIN_S):
        groups = [[r[j] for r in res] for j in range(len(res[0]))
                  if res[0][j]["margin_s"] == margin]
        short = [dict(rep=g[0]["rep"], case=CASES[g[0]["case"]][0],
                      hop_events=[x["hop_events"] for x in g])
                 for g in groups
                 if any(x["hop_events"] != float(tp) for x in g)]
        rows.append(dict(margin_s=margin, profiles=len(groups),
                         short=len(short), short_profiles=short,
                         card=card.strip()))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/probe_ring_profile.json", "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
