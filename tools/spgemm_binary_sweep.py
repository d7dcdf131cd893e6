#!/usr/bin/env python3
"""Host-side design choices of the tensor-core SpGEMM for 0/1 operands
(``src/repro_torch/kernels/spgemm_binary.py``, kernel 6b), timed on one
NVIDIA GPU on cit-HP's triangle-count operands at 64×64 tiles:

    python3 tools/spgemm_binary_sweep.py

* packing B to int8 Bᵀ: the source's pack kernel against PyTorch's cast
  and ``.t().contiguous()`` (``ref.pack_binary_ref``), A's cast included
  in both;
* the kernel alone under three orders of its groups of output tiles: the
  wrapper's (runs of up to 4 active tiles of a block row, ordered by the
  tile-column of their first tile), the same groups by block row, and
  fixed windows of 4 tile-columns ordered by window;
* how many (output tile, real slot) pairs meet an all-zero block of B,
  which the kernel multiplies all the same.

Every output is held with ``torch.equal`` to the wrapper's. Prints the
card's name and power limit, then one JSON object. Exits non-zero
without a card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 0
GROUP = 4     # group_size(64)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("spgemm_binary_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))
    from repro_torch.core.semiring import PLUS_AND
    from repro_torch.graphs import generate
    from repro_torch.graphs.analytics import triangle_problem
    from repro_torch.kernels import ops, ref, spgemm_binary

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi.splitlines()[0]}")
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

    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise RuntimeError(f"spgemm_binary_sweep: {msg}")

    cit = generate("cit-HP", 1.0, SEED)
    a, b, mask, _ = triangle_problem(cit, "bsr", (64, 64), device=dev)
    bp, mk, meta, bn, _ = ops._spgemm_operands(a, b, PLUS_AND, mask)
    del b, mask
    mb, t, bm, bk = a.tiles.shape
    check(spgemm_binary.group_size(bm) == GROUP, "the wrapper's group size changed")
    want = spgemm_binary.semiring_spgemm_binary(a.tiles, meta, bp, mk, sr=PLUS_AND, bn=bn)
    row = {"graph": cit.name, "tiles": [mb, t, bm, bk]}

    packed = spgemm_binary.pack(a.tiles, bp)
    plain = ref.pack_binary_ref(a.tiles, bp)
    check(all(torch.equal(x, y) for x, y in zip(packed, plain)), "the packs differ")
    del plain
    row["pack_ms"] = time_ms(lambda: spgemm_binary.pack(a.tiles, bp))
    row["pack_plain_ms"] = time_ms(lambda: ref.pack_binary_ref(a.tiles, bp))

    a8, bt8 = packed
    n_real = ref.ell_n_real(meta[:, :t])
    active, groups = spgemm_binary.group_tiles(meta, t, GROUP)
    act = active.long()
    first = groups[:, 0].long()
    by_row = groups[torch.argsort(act[first, 0] * (meta.shape[1] - t) + act[first, 1])]
    key = act[:, 0] * (meta.shape[1] - t) + act[:, 1] // GROUP
    starts = torch.ones_like(key, dtype=torch.bool)
    starts[1:] = key[1:] != key[:-1]
    w_first = torch.nonzero(starts)[:, 0]
    w_count = torch.diff(torch.cat([w_first, torch.tensor([act.shape[0]], device=dev)]))
    w_order = torch.argsort((act[w_first, 1] // GROUP) * mb + act[w_first, 0])
    windows = torch.stack([w_first[w_order], w_count[w_order]], dim=1)
    out = torch.zeros_like(mk)
    for label, g in (("by_first_column", groups), ("by_row", by_row), ("column_windows", windows)):
        g = g.to(torch.int32).contiguous()
        row[f"groups_{label}"] = g.shape[0]
        row[f"kernel_ms_{label}"] = time_ms(lambda: spgemm_binary._launch(
            a8, bt8, n_real, active, g, meta, mk, out, PLUS_AND))
        check(torch.equal(out, want), f"the kernel differs with groups {label}")
        out.zero_()

    # pairs (output tile (i, j), real slot of row i) and those whose B
    # block (tile-column of the slot, j) is not all zero
    kb, nb = bp.shape[0] // bk, bp.shape[1] // bn
    b_nonzero = (bp.view(kb, bk, nb, bn) != 0).any(dim=3).any(dim=1).double()   # [kb, nb]
    cols = meta[:, :t].long()
    real = torch.arange(t, device=dev)[None, :] < n_real[:, None].long()
    uses = torch.zeros((mb, kb), dtype=torch.float64, device=dev)
    uses[torch.arange(mb, device=dev)[:, None].expand(-1, t)[real], cols[real]] = 1.0
    flags = (meta[:, t:] > 0).double()
    row["pairs"] = int((uses.sum(dim=1) * flags.sum(dim=1)).sum())
    row["pairs_nonzero_b"] = int(((uses @ b_nonzero) * flags).sum())
    row["share_zero_b"] = 1 - row["pairs_nonzero_b"] / row["pairs"]
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
