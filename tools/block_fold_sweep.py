#!/usr/bin/env python3
"""Kernel 1 over a block of vectors (``semiring_spmv_padded_batch``,
``src/repro_torch/kernels/csrc/semiring_spmv.cu``) at each value of its
template parameter NB, the vectors a warp folds against each tile-row
chunk, timed on one NVIDIA GPU on full-size cit-HP at 128×128 tiles with
B = 32 vectors, for the five semirings:

    python3 tools/block_fold_sweep.py

For each semiring: the block launch at NB = 1, 2, 4, 8, 16 and 32 single
launches of kernel 1, medians of 5 CUDA-event timings each, every block
result held with ``torch.equal`` to kernel 1 row by row; kernel 2 over
the same block at a per-row density of 5%, held with ``torch.equal`` to
kernel 2 row by row. Prints the nvcc register and spill lines of the two
sources, the card's name and power limit, then one JSON object. Exits
non-zero without a card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 0
B = 32
NBS = (1, 2, 4, 8, 16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("block_fold_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    import numpy as np

    from repro_torch.core import SEMIRINGS, build_bsr_padded
    from repro_torch.graphs import generate
    from repro_torch.graphs.engine import edge_values
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded, semiring_spmv_padded_batch
    from repro_torch.kernels.spmspv_tiles import (
        semiring_spmspv_padded, semiring_spmspv_padded_batch,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi.splitlines()[0]}")
    dev = torch.device("cuda")
    _build.build_all()
    for src in ("semiring_spmv.cu", "spmspv_tiles.cu"):
        for line in _build.build_log.get(src, "").splitlines():
            if "batch" in line or "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    def time_ms(fn, reps: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        return statistics.median(ts)

    rng = np.random.default_rng(SEED)
    g = generate("cit-HP", 1.0, SEED)
    out = {"graph": "cit-HP", "B": B, "rows": []}
    for name, sr in SEMIRINGS.items():
        vals = edge_values(g, sr, weighted=sr.collective == "pmin", seed=5,
                           normalize=name == "plus_times")
        a = build_bsr_padded(g.cols.astype(np.int32), g.rows.astype(np.int32), vals,
                             (g.n, g.n), sr, block=(128, 128), device=dev)
        n_pad = a.shape[1]
        if sr.dtype == torch.int32:
            xv = rng.integers(0, 2, (B, n_pad)).astype(np.int32)
        else:
            xv = rng.uniform(0.5, 4.0, (B, n_pad)).astype(np.float32)
        xs = torch.from_numpy(xv).to(dev)
        single = torch.stack([semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr) for x in xs])
        row = {"semiring": name, "tiles": list(a.tiles.shape),
               "seq_ms": time_ms(lambda: [semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr)
                                          for x in xs])}
        for nb in NBS:
            ys = semiring_spmv_padded_batch(a.tiles, a.tile_cols, xs, sr=sr, nb=nb)
            torch.cuda.synchronize()
            if not torch.equal(ys, single):
                raise RuntimeError(f"{name} nb={nb}: the block launch differs from kernel 1")
            row[f"nb{nb}_ms"] = time_ms(
                lambda: semiring_spmv_padded_batch(a.tiles, a.tile_cols, xs, sr=sr, nb=nb))
        keep = torch.from_numpy(rng.random((B, g.n)) < 0.05).to(dev)
        xsp = torch.where(keep, xs[:, : g.n], sr.zero)
        kb, xd = ops._frontier_block(a, xsp, sr, None)
        meta = ops._spmspv_meta_batch(a, kb)
        ys2 = semiring_spmspv_padded_batch(a.tiles, meta, xd, sr=sr)
        single2 = torch.stack([semiring_spmspv_padded(a.tiles, m, x, sr=sr)
                               for m, x in zip(meta, xd)])
        torch.cuda.synchronize()
        if not torch.equal(ys2, single2):
            raise RuntimeError(f"{name}: kernel 2 over the block differs from kernel 2")
        row["spmspv_block_ms"] = time_ms(
            lambda: semiring_spmspv_padded_batch(a.tiles, meta, xd, sr=sr))
        row["spmspv_seq_ms"] = time_ms(
            lambda: [semiring_spmspv_padded(a.tiles, m, x, sr=sr) for m, x in zip(meta, xd)])
        row["n_active"] = int(meta[:, :, 0].sum())
        out["rows"].append(row)
        print(json.dumps(row))
        del a, xs, single, ys, meta, xd, ys2, single2
        torch.cuda.empty_cache()
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = smi.splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
