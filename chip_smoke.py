#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. Device: prints the card's name and power limit, builds the CUDA tile
     kernels from ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a).
  2. Kernel vs plain version: on the full-size cit-HP stand-in (n=34,546,
     128×128 tiles, 4.7 GB per matrix) for all five semirings, each kernel
     against its plain PyTorch version (``kernels/ref.py``) on the same
     card inputs: exact for the integer and min semirings, ⟨+,×⟩ within
     rtol 1e-5, atol 1e-6 (another fold order). SpMSpV at frontier
     densities of 0.1%, 5% and 60%. Plus the full ca-Q stand-in at 16×16
     tiles. Kernel, plain, bound and (⟨+,×⟩) library times.
  3. Main path: adaptive BFS/SSSP/PPR through ``build_engine(fmt="bsr")``
     on full-size cit-HP (scale-free), held to the numpy/scipy oracles.
  4. Main path: BFS on full-size r-TX (regular, n=1,087,849), levels
     held to the oracle clipped to max_iters.
  5. Per traversal: wall ms, iterations, launches per kernel, peak memory.

The launch counters are set to 0 before phase 3 and read after phase 4;
the run fails unless both kernels launched there. Any mismatch raises,
so the run exits non-zero without the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
DENSITIES = (0.001, 0.05, 0.6)
RTX_MAX_ITERS = 256


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch.core import SEMIRINGS, build_bsr_padded, frontier_from_dense
    from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES
    from repro_torch.graphs import (
        bfs, bfs_reference, build_engine, generate, largest_component_source, ppr,
        ppr_reference, sssp, sssp_reference, trained_stump,
    )
    from repro_torch.graphs.engine import edge_values
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.semiring_spmv import semiring_spmv_padded
    from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded

    dev = torch.device("cuda")
    kernels = (semiring_spmv_padded, semiring_spmspv_padded)

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s")
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    def time_ms(fn, reps: int = 10) -> float:
        """Median of ``reps`` single-call CUDA-event timings after warm-up."""
        for _ in range(2):
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

    def compare(y, y_plain, sr, what: str) -> float:
        """Hold a kernel output to its plain version; max |diff| over
        entries finite in both."""
        torch.cuda.synchronize()
        if sr.name == "plus_times":
            torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-6, equal_nan=True,
                                       msg=lambda m: f"{what}: {m}")
        else:
            check(torch.equal(y, y_plain), f"{what}: kernel differs from the plain version")
        fin = torch.isfinite(y.double()) & torch.isfinite(y_plain.double())
        diff = (y.double() - y_plain.double()).abs()[fin]
        return float(diff.max()) if diff.numel() else 0.0

    def transposed(g, sr, block, weighted=False, normalize=False):
        vals = edge_values(g, sr, weighted=weighted, seed=5, normalize=normalize)
        return build_bsr_padded(g.cols.astype(np.int32), g.rows.astype(np.int32), vals,
                                (g.n, g.n), sr, block=block, device=dev)

    def random_x(rng, sr, n):
        if sr.dtype == torch.int32:
            v = rng.integers(0, 2, n).astype(np.int32)
        elif sr.name == "plus_times":
            v = rng.random(n).astype(np.float32)
        else:
            v = rng.uniform(1.0, 10.0, n).astype(np.float32)
        return torch.from_numpy(v).to(dev)

    def sparse_x(rng, sr, x, n_true, density):
        xs = x.clone()
        keep = torch.from_numpy(rng.random(x.shape[0]) < density).to(dev)
        keep[n_true:] = False
        xs[~keep] = sr.zero
        return xs

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        """Least time for the work, in ms, and what sets it: the bytes over
        the memory rate or the operations over the fp32 rate."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def library_bsr(a, sr):
        """torch.sparse_bsr_tensor over the real tiles (pads dropped)."""
        real = (a.tiles != sr.zero).flatten(2).any(dim=2)           # [mb, T]
        crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                          real.sum(dim=1).cumsum(0)])
        return torch.sparse_bsr_tensor(crow, a.tile_cols[real].long(), a.tiles[real],
                                       size=a.shape, check_invariants=False)

    # ---------------------------------------------------------------- 2
    rng = np.random.default_rng(SEED)
    cit = generate("cit-HP", 1.0, SEED)
    worst = {k.__name__: 0.0 for k in kernels}
    summary = {}
    weighted = {"min_plus": True, "min_times": True}
    for name, sr in SEMIRINGS.items():
        a = transposed(cit, sr, (128, 128), weighted=weighted.get(name, False),
                       normalize=name == "plus_times")
        mb, t, bm, bn = a.tiles.shape
        x = random_x(rng, sr, a.shape[1])
        lib = library_bsr(a, sr) if name == "plus_times" else None
        y = semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr)
        err = compare(y, ref.spmv_padded_ref(a.tiles, a.tile_cols, x, sr), sr,
                      f"spmv {name} cit-HP")
        if lib is not None:
            torch.testing.assert_close((lib @ x[:, None])[:, 0], y, rtol=1e-4, atol=1e-6)
        nbytes = a.tiles.numel() * 4 + a.tile_cols.numel() * 4 + x.numel() * 4 + mb * bm * 4
        bound_ms, bound_by = bound(nbytes, 2 * a.tiles.numel())
        row = {"kernel": "semiring_spmv_padded", "semiring": name, "graph": "cit-HP",
               "tiles": [mb, t, bm, bn], "max_abs_err": err,
               "ms": time_ms(lambda: semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr)),
               "plain_ms": time_ms(lambda: ref.spmv_padded_ref(a.tiles, a.tile_cols, x, sr)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": time_ms(lambda: lib @ x[:, None]) if lib is not None else None,
               "real_slots": int(lib.values().shape[0]) if lib is not None else None}
        worst["semiring_spmv_padded"] = max(worst["semiring_spmv_padded"], err)
        print(json.dumps(row))
        if lib is not None:
            summary["semiring_spmv_padded"] = row
        for d in DENSITIES:
            f = frontier_from_dense(sparse_x(rng, sr, x, cit.n, d)[: cit.n], sr)
            meta = ops._spmspv_meta(a, f, sr)
            xd = ops._dense_frontier(a, f, sr)
            y = semiring_spmspv_padded(a.tiles, meta, xd, sr=sr)
            err = compare(y, ref.spmspv_padded_ref(a.tiles, meta, xd, sr), sr,
                          f"spmspv {name} cit-HP density {d}")
            n_active = int(meta[:, 0].sum())
            nbytes = (n_active * bm * bn * 4 + meta.numel() * 4 + xd.numel() * 4
                      + mb * bm * 4)
            bound_ms, bound_by = bound(nbytes, 2 * n_active * bm * bn)
            row = {"kernel": "semiring_spmspv_padded", "semiring": name, "graph": "cit-HP",
                   "density": d, "n_active": n_active, "max_abs_err": err,
                   "ms": time_ms(lambda: semiring_spmspv_padded(a.tiles, meta, xd, sr=sr)),
                   "plain_ms": time_ms(lambda: ref.spmspv_padded_ref(a.tiles, meta, xd, sr)),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": time_ms(lambda: lib @ xd[:, None]) if lib is not None else None}
            worst["semiring_spmspv_padded"] = max(worst["semiring_spmspv_padded"], err)
            print(json.dumps(row))
            if lib is not None and d == 0.05:
                summary["semiring_spmspv_padded"] = row
        del a, x, y, lib
        torch.cuda.empty_cache()

    caq = generate("ca-Q", 1.0, SEED)
    for name, sr in SEMIRINGS.items():
        a = transposed(caq, sr, (16, 16), weighted=weighted.get(name, False),
                       normalize=name == "plus_times")
        x = random_x(rng, sr, a.shape[1])
        err = compare(semiring_spmv_padded(a.tiles, a.tile_cols, x, sr=sr),
                      ref.spmv_padded_ref(a.tiles, a.tile_cols, x, sr), sr,
                      f"spmv {name} ca-Q 16x16")
        worst["semiring_spmv_padded"] = max(worst["semiring_spmv_padded"], err)
        for d in DENSITIES:
            f = frontier_from_dense(sparse_x(rng, sr, x, caq.n, d)[: caq.n], sr)
            meta, xd = ops._spmspv_meta(a, f, sr), ops._dense_frontier(a, f, sr)
            err = compare(semiring_spmspv_padded(a.tiles, meta, xd, sr=sr),
                          ref.spmspv_padded_ref(a.tiles, meta, xd, sr), sr,
                          f"spmspv {name} ca-Q 16x16 density {d}")
            worst["semiring_spmspv_padded"] = max(worst["semiring_spmspv_padded"], err)
        print(f"phase 2: ca-Q {tuple(a.tiles.shape)} at 16x16 tiles, {name}: both kernels "
              "match the plain version")
    print(f"phase 2: max |kernel - plain| {json.dumps(worst)}")

    # ---------------------------------------------------------------- 3, 4
    stump = trained_stump()
    for k in kernels:
        k.launches = 0
    traversals = []

    def run(label, g, sr, app, **build_kw):
        torch.cuda.reset_peak_memory_stats()
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        eng = build_engine(g, sr, stump, fmt_spmv="bsr", fmt_spmspv="bsr", **build_kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = app(eng)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        its = res.iterations
        row = {"traversal": label, "graph": g.name, "n": g.n, "nnz": g.nnz,
               "graph_class": eng.graph_class, "threshold": eng.threshold,
               "n_pad": eng.n, "build_s": build_s,
               "wall_ms": wall_ms, "iterations": its,
               "kernel_used": res.kernel_used[:its].tolist(),
               "launches": {k.__name__: k.launches - b for k, b in zip(kernels, before)},
               "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del eng
        torch.cuda.empty_cache()
        traversals.append(row)
        print(json.dumps(row))
        return res

    src = largest_component_source(cit)
    res = run("bfs", cit, BOOL_OR_AND, lambda e: bfs(e, src))
    check(np.array_equal(res.levels.cpu().numpy(), bfs_reference(cit.rows, cit.cols, cit.n, src)),
          "cit-HP BFS levels differ from the oracle")
    res = run("sssp", cit, MIN_PLUS, lambda e: sssp(e, src), weighted=True, seed=5)
    w = edge_values(cit, MIN_PLUS, weighted=True, seed=5)
    check(np.array_equal(res.dist.cpu().numpy(),
                         sssp_reference(cit.rows, cit.cols, w, cit.n, src).astype(np.float32)),
          "cit-HP SSSP distances differ from Dijkstra")
    res = run("ppr", cit, PLUS_TIMES, lambda e: ppr(e, src), normalize=True)
    np.testing.assert_allclose(res.rank.cpu().numpy(),
                               ppr_reference(cit.rows, cit.cols, cit.n, src, sparse=True),
                               rtol=1e-3, atol=1e-6)
    print("phase 3: cit-HP BFS/SSSP/PPR match the oracles")

    rtx = generate("r-TX", 1.0, SEED)
    src = largest_component_source(rtx)
    res = run("bfs", rtx, BOOL_OR_AND, lambda e: bfs(e, src, max_iters=RTX_MAX_ITERS))
    want = bfs_reference(rtx.rows, rtx.cols, rtx.n, src)
    want = np.where(want > RTX_MAX_ITERS, -1, want)
    check(np.array_equal(res.levels.cpu().numpy(), want),
          "r-TX BFS levels differ from the oracle clipped to max_iters")
    print(f"phase 4: r-TX BFS matches the oracle over {RTX_MAX_ITERS} levels")

    launches = {k.__name__: k.launches for k in kernels}
    print(f"phase 5: launches on the main path {json.dumps(launches)}")
    for k in kernels:
        check(k.launches > 0, f"{k.__name__} was not launched on the main path")

    sources = {"semiring_spmv_padded": ("src/repro_torch/kernels/csrc/semiring_spmv.cu",
                                        "src/repro/kernels/semiring_spmv.py:56"),
               "semiring_spmspv_padded": ("src/repro_torch/kernels/csrc/spmspv_tiles.cu",
                                          "src/repro/kernels/spmspv_tiles.py:71")}
    line = []
    for k in kernels:
        row = summary[k.__name__]
        line.append({"name": k.__name__, "route": "cuda", "source": sources[k.__name__][0],
                     "replaces": sources[k.__name__][1], "launches": launches[k.__name__],
                     "max_abs_err": worst[k.__name__], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
