#!/usr/bin/env python3
"""Kernels 1 and 2 over a block of vectors (``semiring_spmv_padded_batch``
and ``semiring_spmspv_padded_batch``, the shared-memory block fold of
``src/repro_torch/kernels/csrc/tile_fold.cuh``) at values of its
compile-time constants, the tile rows a CTA owns (``TILEFOLD_BLOCK_ROWS``),
the lanes of a warp across rows (``TILEFOLD_LANE_ROWS``; the others across
vectors) and the depth of its cp.async ring (``TILEFOLD_STAGES``), timed
on one NVIDIA GPU on full-size cit-HP at 128×128 tiles with B = 32
vectors, for the five semirings:

    python3 tools/block_fold_sweep.py [--variants 64/16/2,64/32/2,...]

each variant written rows/lane_rows/stages.

Each variant is built with nvcc into ``kernels/build/sweep/`` (all
started together) and called through the same C entry points as the
wrappers. For each semiring: kernel 1 over the block and 32 single
launches of kernel 1, and kernel 2 over the same block at a per-row
density of 5% and 32 single launches of kernel 2, medians of 5 CUDA-event
timings each; every block result is held with ``torch.equal`` to the
single-vector kernel row by row. Prints the nvcc register and spill lines
of each variant, the card's name and power limit, then one JSON object.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 0
B = 32
SOURCES = {"spmv": ("semiring_spmv.cu", "semiring_spmv_padded_batch"),
           "spmspv": ("spmspv_tiles.cu", "semiring_spmspv_padded_batch")}


def build_variants(_build, variants):
    """Compile both block sources once per variant (rows, lane_rows,
    stages), all nvcc processes started together; returns
    {variant: {key: fn}} and the ptxas lines of the block kernels."""
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for variant in variants:
        rows, lane_rows, stages = variant
        for key, (src, _) in SOURCES.items():
            lib = out_dir / f"{Path(src).stem}-{rows}-{lane_rows}-{stages}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DTILEFOLD_BLOCK_ROWS={rows}",
                   f"-DTILEFOLD_LANE_ROWS={lane_rows}", f"-DTILEFOLD_STAGES={stages}",
                   "-o", str(lib), str(_build.CSRC / src)]
            procs.append((variant, key, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    fns, log = {}, []
    for variant, key, lib, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key} {variant}:\n{err}")
        lines = err.splitlines()
        for k, line in enumerate(lines):
            if "tile_fold_block_kernel" in line and "Compiling" in line:
                log.append(f"{variant} {key}: {line.strip()[-80:]}")
                log.extend(f"    {x.strip()}" for x in lines[k + 2:k + 4])
        fn = getattr(ctypes.CDLL(str(lib)), SOURCES[key][1])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.setdefault(variant, {})[key] = fn
    return fns, log


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", default="64/16/2,64/32/2,64/8/2,128/16/2,64/16/3")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("block_fold_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    import numpy as np

    from repro_torch.core import SEMIRINGS, build_bsr_padded
    from repro_torch.graphs import generate
    from repro_torch.graphs.engine import edge_values
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi.splitlines()[0]}")
    variants = [tuple(int(v) for v in x.split("/")) for x in args.variants.split(",")]
    _build.build_all()
    fns, log = build_variants(_build, variants)
    for line in log:
        print(line)
    dev = torch.device("cuda")

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

    def block_call(fn, a, index, xs, sr, tag=""):
        mb, t, bm, bn = a.tiles.shape
        ys = torch.empty((xs.shape[0], mb * bm), dtype=sr.dtype, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.tiles.data_ptr(), index.data_ptr(), xs.data_ptr(), ys.data_ptr(), mb, t, bm,
                 bn, xs.shape[1], xs.shape[0], sr.code, stream)
        if err:
            raise RuntimeError(f"{tag}: launch failed with cudaError_t {err}")
        return ys

    rng = np.random.default_rng(SEED)
    g = generate("cit-HP", 1.0, SEED)
    out = {"graph": "cit-HP", "B": B, "variants": ["/".join(map(str, v)) for v in variants],
           "rows": []}
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
        keep = torch.from_numpy(rng.random((B, g.n)) < 0.05).to(dev)
        kb, xd = ops._frontier_block(a, torch.where(keep, xs[:, :g.n], sr.zero), sr, None)
        meta = ops._spmspv_meta_batch(a, kb)
        union = ops._spmspv_union_batch(meta)
        single = torch.stack([semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr) for x in xs])
        single2 = torch.stack([semiring_spmspv_padded(a.tiles, m, x, sr=sr)
                               for m, x in zip(meta, xd)])
        row = {"semiring": name, "tiles": list(a.tiles.shape),
               "n_active": int(meta[:, :, 0].sum()), "n_union": int(union[:, :, 0].sum()),
               "seq_kernel1_ms": time_ms(lambda: [semiring_spmv_padded(a.tiles, a.tile_cols, x,
                                                                       sr=sr) for x in xs]),
               "seq_kernel2_ms": time_ms(lambda: [semiring_spmspv_padded(a.tiles, m, x, sr=sr)
                                                  for m, x in zip(meta, xd)])}
        for variant, f in fns.items():
            tag = "/".join(map(str, variant))
            ys = block_call(f["spmv"], a, a.tile_cols, xs, sr, tag)
            ys2 = block_call(f["spmspv"], a, union, xd, sr, tag)
            torch.cuda.synchronize()
            if not torch.equal(ys, single):
                raise RuntimeError(f"{name} {tag}: kernel 1 over the block differs from kernel 1")
            if not torch.equal(ys2, single2):
                raise RuntimeError(f"{name} {tag}: kernel 2 over the block differs from kernel 2")
            row[f"spmv_{tag}_ms"] = time_ms(lambda: block_call(f["spmv"], a, a.tile_cols, xs, sr))
            row[f"spmspv_{tag}_ms"] = time_ms(lambda: block_call(f["spmspv"], a, union, xd, sr))
        out["rows"].append(row)
        print(json.dumps(row))
        del a, xs, single, single2, meta, union, xd
        torch.cuda.empty_cache()
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = smi.splitlines()[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
