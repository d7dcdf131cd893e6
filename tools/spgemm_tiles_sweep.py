#!/usr/bin/env python3
"""Kernel 6, the masked tile SpGEMM (``src/repro_torch/kernels/csrc/
spgemm_tiles.cu``), timed on one NVIDIA GPU on full-size ca-Q with phase
9's operands of ``chip_smoke.py`` (B dense, a mask of density 0.4, every
semiring in its safe domain), and its ⟨+,×⟩ precision against the row
degree:

    python3 tools/spgemm_tiles_sweep.py [--blocks 16,64,128]
        [--semirings plus_times,...] [--repeat R] [--degree 81,1000]
        [--triangle]

The kernel is built by the wrapper's build (``kernels/_build.py``) and
called through its launch (``spgemm_tiles._launch``) into an output
filled once. For each block and semiring the output is held to the plain
version (``ref.spgemm_padded_ref``: exact for the integer and min
semirings, ⟨+,×⟩ within rtol 1e-5, atol 1e-6) and timed, medians of 5
CUDA-event timings of the launch alone, ``--repeat`` rounds (a list a row); beside
it the whole wrapper call and, for ⟨+,×⟩, ``torch.sparse.sampled_addmm``
(mask as CSR, A dense). ``--degree`` adds, for each degree d, ⟨+,×⟩ f32
at 64×64 on a 4096 × 4096 A with about d nonzeros in every row (values
and a dense B in [0, 1), every output tile active): the kernel's worst
ratio |y − want| / (atol + rtol · |want|) under that tolerance against
the plain version and against the product in float64, and the plain
version's against float64; above 1 a comparison fails. ``--triangle``
adds cit-HP's triangle operands at 64×64 (int32 ⟨+,∧⟩, the operands
kernel 6 is timed on in phase 10), held to ``torch._int_mm``. Prints the
card's name and power limit, a JSON line a row, then one JSON object.
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--blocks", default="64")
    parser.add_argument("--semirings", default=None,
                        help="comma-separated semiring names (default: all)")
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--degree", default="")
    parser.add_argument("--triangle", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("spgemm_tiles_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    import numpy as np

    from repro_torch.core import SEMIRINGS, build_bsr_padded
    from repro_torch.core.semiring import PLUS_AND
    from repro_torch.graphs import generate
    from repro_torch.graphs.analytics import triangle_problem
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import spgemm_tiles as st

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi.splitlines()[0]}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built kernel 6 in {time.perf_counter() - t0:.1f} s")
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

    def same(y, want, sr, what: str) -> None:
        torch.cuda.synchronize()
        if sr.name == "plus_times":
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6, equal_nan=True,
                                       msg=lambda m: f"{what}: {m}")
        elif not torch.equal(y, want):
            raise RuntimeError(f"{what}: differs from the plain version")

    def launcher(a_tiles, meta, bp, mk, sr):
        """A closure that launches the kernel into an output filled once."""
        out = torch.full_like(mk, sr.zero)

        def call():
            st._launch(a_tiles, meta, bp, mk, out, sr)
            return out
        return call

    def ratio(y, want) -> float:
        """Worst |y − want| / (atol + rtol·|want|) under ⟨+,×⟩'s tolerance."""
        y, want = y.double(), want.double()
        return float(((y - want).abs() / (1e-6 + 1e-5 * want.abs())).max())

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    caq = generate("ca-Q", 1.0, SEED)
    n = caq.n
    report = {"graph": "ca-Q", "rows": [], "precision": [],
              "caq_max_row_degree": int(np.bincount(caq.rows).max())}

    sr = SEMIRINGS["plus_times"]
    for degree in (int(x) for x in args.degree.split(",") if x):
        nd, bm = 4096, 64
        keep = torch.rand((nd, nd), generator=gen, device=dev) < degree / nd
        a_dense = torch.where(keep, torch.rand((nd, nd), generator=gen, device=dev), 0.0)
        b = torch.rand((nd, nd), generator=gen, device=dev)
        r, c = torch.nonzero(a_dense, as_tuple=True)
        a = build_bsr_padded(r.int().cpu().numpy(), c.int().cpu().numpy(),
                             a_dense[r, c].cpu().numpy(), (nd, nd), sr, block=(bm, bm),
                             device=dev)
        bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, sr, None)
        want64 = a_dense.double() @ b.double()
        plain = ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)
        y = launcher(a.tiles, meta, bp, mk, sr)()
        row = {"degree": degree, "max_row_degree": int(keep.sum(dim=1).max()),
               "tiles": list(a.tiles.shape), "plain_vs_f64": ratio(plain, want64),
               "kernel_vs_plain": ratio(y, plain), "kernel_vs_f64": ratio(y, want64)}
        report["precision"].append(row)
        print(json.dumps(row), flush=True)
        del keep, a_dense, b, a, bp, mk, meta, want64, plain, y
        torch.cuda.empty_cache()

    names = args.semirings.split(",") if args.semirings else list(SEMIRINGS)
    for name, sr in SEMIRINGS.items():
        if name not in names:
            continue

        def u():
            return torch.rand((n, n), generator=gen, device=dev)

        if sr.collective == "pmin":
            vals = rng.integers(1, 9, caq.nnz).astype(np.float32)
            b = torch.randint(1, 9, (n, n), generator=gen, device=dev).float()
            mask = torch.where(u() < 0.4, 1.0, float("inf"))
        elif sr.dtype == torch.int32:
            vals = np.ones(caq.nnz, np.int32)
            b = torch.randint(0, 9, (n, n), generator=gen, device=dev, dtype=torch.int32)
            mask = (u() < 0.4).int()
        else:
            vals = rng.random(caq.nnz).astype(np.float32)
            b, mask = u(), (u() < 0.4).float()
        for bm in (int(x) for x in args.blocks.split(",")):
            a = build_bsr_padded(caq.rows.astype(np.int32), caq.cols.astype(np.int32), vals,
                                 (n, n), sr, block=(bm, bm), device=dev)
            bpad = torch.full((a.shape[1], n), sr.one, dtype=sr.dtype, device=dev)
            bpad[:n] = b
            mpad = torch.full((a.shape[0], n), sr.zero, dtype=sr.dtype, device=dev)
            mpad[:n] = mask
            bp, mk, meta, bn, _ = ops._spgemm_operands(a, bpad, sr, mpad)
            want = ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)
            st_ = ops.spgemm_stream_stats(a, meta, bp, mk)
            row = {"semiring": name, "block": bm, "tiles": list(a.tiles.shape),
                   "n_active": st_["n_active"], "real_slots": st_["real_slots"],
                   "real_macs": st_["real_macs"]}
            call = launcher(a.tiles, meta, bp, mk, sr)
            st.semiring_spgemm_padded.paths = dict.fromkeys(st.PATHS, 0)
            same(call(), want, sr, f"{name} {bm}")
            row["paths"] = {k: int(v) for k, v in st.semiring_spgemm_padded.paths.items()}

            def wrapper():
                return st.semiring_spgemm_padded(a.tiles, meta, bp, mk, sr=sr, bn=bn)

            same(wrapper(), want, sr, f"{name} {bm} through the wrapper")
            row["launch_ms"], row["wrapper_ms"] = [], []
            for _ in range(args.repeat):
                row["launch_ms"].append(time_ms(call))
                row["wrapper_ms"].append(time_ms(wrapper))
            if name == "plus_times":
                a_dense = torch.zeros((n, n), dtype=torch.float32, device=dev)
                a_dense.index_put_((torch.from_numpy(caq.rows.astype(np.int64)).to(dev),
                                    torch.from_numpy(caq.cols.astype(np.int64)).to(dev)),
                                   torch.from_numpy(vals).to(dev), accumulate=True)
                mask_csr = mask.to_sparse_csr()
                row["sampled_addmm_ms"] = time_ms(
                    lambda: torch.sparse.sampled_addmm(mask_csr, a_dense, b, beta=0.0))
                del a_dense, mask_csr
            report["rows"].append(row)
            print(json.dumps(row), flush=True)
            del a, bpad, mpad, bp, mk, meta, want, call
            torch.cuda.empty_cache()
        del b, mask

    if args.triangle:
        cit = generate("cit-HP", 1.0, SEED)
        a, b, mask, _ = triangle_problem(cit, "bsr", (64, 64), device=dev)
        bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, PLUS_AND, mask)
        del b, mask
        l8 = mk.to(torch.int8)
        want = torch._int_mm(l8, l8.t()) * mk     # (L·Lᵀ) ⊙ L, exact in int32
        del l8
        call = launcher(a.tiles, meta, bp, mk, PLUS_AND)
        same(call(), want, PLUS_AND, "cit-HP triangle operands")
        row = {"semiring": "plus_and", "graph": "cit-HP", "block": 64,
               "tiles": list(a.tiles.shape), "launch_ms": time_ms(call, reps=3)}
        print(json.dumps(row), flush=True)
        report["rows"].append(row)
    report["device"] = torch.cuda.get_device_name(0)
    report["nvidia_smi"] = smi.splitlines()[0]
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
