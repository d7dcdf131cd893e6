"""Dry-run profile (``repro.launch.hlo_profile``): the ops of one cell's
step ranked by the HBM bytes they move and by their FLOPs, each named by
its caller in the port, from the counter of ``launch/op_analysis.py``.

    PYTHONPATH=src python -m repro_torch.launch.op_profile --arch zamba2-1.2b \\
        --shape long_500k
"""
from __future__ import annotations

import argparse
import collections


def contributors(analysis, top: int = 15) -> dict:
    """Print the total HBM bytes, then the ``top`` (caller, op) pairs by
    bytes as ``caller :: op``, the top callers by bytes over all their
    ops, and the top (caller, op) pairs by FLOPs. Returns the rankings as
    {"bytes": [((caller, op), bytes, ops)], "callers": [(caller, bytes,
    ops)], "flops": [((caller, op), flops, ops)]}."""
    by_bytes, by_flops, count = (collections.Counter() for _ in range(3))
    by_caller, caller_ops = collections.Counter(), collections.Counter()
    for r in analysis.ops:
        key = (r.caller, r.op)
        by_bytes[key] += r.bytes
        by_flops[key] += r.flops
        count[key] += 1
        by_caller[r.caller] += r.bytes
        caller_ops[r.caller] += 1
    out = {"bytes": [(k, v, count[k]) for k, v in by_bytes.most_common(top)],
           "callers": [(k, v, caller_ops[k]) for k, v in by_caller.most_common(top)],
           "flops": [(k, v, count[k]) for k, v in by_flops.most_common(top) if v]}
    print(f"total HBM bytes {analysis.hbm_bytes / 1e9:.1f} GB, FLOPs {analysis.flops / 1e12:.2f} T "
          f"({len(analysis.ops)} ops)")
    print("--- top HBM contributors")
    for (caller, op), v, n in out["bytes"]:
        print(f"{v / 1e9:9.2f} GB  {caller} :: {op}  ({n} ops)")
    print("--- top callers by HBM bytes")
    for caller, v, n in out["callers"]:
        print(f"{v / 1e9:9.2f} GB  {caller}  ({n} ops)")
    print("--- top FLOP contributors")
    for (caller, op), v, n in out["flops"]:
        print(f"{v / 1e12:9.3f} TF  {caller} :: {op}  ({n} ops)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--microbatches", type=int, default=16)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.train.train_loop import TrainConfig
    rec, ana = lower_cell(args.arch, args.shape, {"card": 1},
                          TrainConfig(microbatches=args.microbatches, remat=True))
    r = rec["roofline"]
    print(f"{args.arch} x {args.shape} x card: compute={r['compute_s'] * 1e3:.2f}ms "
          f"memory={r['memory_s'] * 1e3:.2f}ms dominant={r['dominant']}")
    return contributors(ana, top=args.top)


if __name__ == "__main__":
    main()
