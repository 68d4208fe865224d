"""The paper's Sec. V case study on 2 ranks: parallel matmul with ART
partial-sum exchange against the bulk-synchronous baseline, and the
kernel-split convolution (``rank_tasks.case_study``).

The port's counterpart of ``examples/pgas_matmul_2node.py``: ART ≡ bulk ≡
``M @ N`` at the case study's sizes (``configs/fshmem_case_study.py``:
256/512/1024, 8 ART chunks, fp32, TF32 off), each held within 2e-4 of one
``torch.matmul`` relative to the largest output, and the convolution sets
against one ``conv2d``; the wall time of each call is printed.  The
reference's HLO-collective census and modelled Fig. 7 speedups are not
carried over (they read XLA HLO and link models).

Run:  PYTHONPATH=src python -m repro_torch.examples.pgas_matmul_2node \\
          [--device cpu] [--sizes 256 512 1024] [--fmap 64]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

TOL = 2e-4


def main(argv: Optional[Sequence[str]] = None) -> int:
    from repro_torch.configs.fshmem_case_study import config as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=list(cs.matmul_sizes))
    ap.add_argument("--fmap", type=int, default=cs.conv_fmap,
                    help="conv feature-map side")
    ap.add_argument("--iters", type=int, default=3,
                    help="timed calls of each entry point")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.dist import rank_tasks
    from repro_torch.dist.group import RankPool

    dev = resolve_device(args.device)
    with RankPool(cs.n_nodes, device=dev.type) as pool:
        res = pool.run(rank_tasks.case_study, args.sizes, cs.art_chunks,
                       cs.conv_sets, args.fmap, (1,), iters=args.iters)
    ok = True
    for rows in zip(*(r["matmul"] for r in res)):
        art = max(r["art_err"] for r in rows)
        bulk = max(r["bulk_err"] for r in rows)
        good = art <= TOL and bulk <= TOL and all(
            r["art_finite"] and r["bulk_finite"] for r in rows)
        ok &= good
        print(f"matmul {rows[0]['size']}: ART ({cs.art_chunks} chunks) err "
              f"{art:.2e}, bulk err {bulk:.2e} (tol {TOL}) "
              f"{'OK' if good else 'FAILED'} | {rows[0]['art_ms']:.3f} ms "
              f"ART, {rows[0]['bulk_ms']:.3f} ms bulk ({dev.type})")
    for rows in zip(*(r["conv"] for r in res)):
        err = max(r["err"] for r in rows)
        good = err <= TOL and all(r["finite"] for r in rows)
        ok &= good
        r0 = rows[0]
        print(f"conv {r0['cout']}x{r0['k']}x{r0['k']} on {args.fmap}x"
              f"{args.fmap}, batch {r0['batch']}: err {err:.2e} "
              f"{'OK' if good else 'FAILED'} | {r0['ms']:.3f} ms")
    print("pgas_matmul_2node OK" if ok else "pgas_matmul_2node FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
