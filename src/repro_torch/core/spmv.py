"""Semiring SpMV: y = A ⊕.⊗ x with a dense input vector (paper §3).

COO/CSR run as gather + ⊕-segment-reduce; BSRMatrix as a plain PyTorch
tile fold (``spmv_bsr_ref``). PaddedBSR goes through the tile kernels'
front door (``kernels/ops.py``): a hand-written CUDA kernel on the card,
its plain PyTorch version on the host. ``impl="fused"`` takes the fused
kernel, which streams only each block row's real tiles. ``spmv_batch``
takes a [B, n] block of dense vectors (the multi-source traversals).
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import BSRMatrix, COOMatrix, CSRMatrix, PaddedBSR
from repro_torch.core.semiring import Semiring
from repro_torch.kernels.ref import fold_rows

Tensor = torch.Tensor


def spmv_coo(a: COOMatrix, x: Tensor, sr: Semiring) -> Tensor:
    """y_i = ⊕_{(i,j)∈A} a_ij ⊗ x_j; padded entries (row = M) are dropped."""
    m, _ = a.shape
    ok = a.rows < m
    xj = x[torch.where(ok, a.cols, 0).long()]
    prod = sr.mul(a.vals.to(sr.dtype), xj.to(sr.dtype))
    prod = torch.where(ok, prod, sr.zero)
    return sr.segment_reduce(prod, torch.where(ok, a.rows, m), m)


def spmv_csr(a: CSRMatrix, x: Tensor, sr: Semiring) -> Tensor:
    """CSR uses the precomputed expanded segment ids; same math as COO."""
    m, _ = a.shape
    ok = a.seg_ids < m
    xj = x[torch.where(ok, a.cols, 0).long()]
    prod = sr.mul(a.vals.to(sr.dtype), xj.to(sr.dtype))
    prod = torch.where(ok, prod, sr.zero)
    return sr.segment_reduce(prod, a.seg_ids, m)


def spmv_bsr_ref(a: BSRMatrix, x: Tensor, sr: Semiring) -> Tensor:
    """Plain tile fold over the CSR-of-tiles list: block row i ⊕-folds its
    stored tiles' dense matvecs in tile order; pad tiles are not read."""
    ptr = a.tile_row_ptr.long()
    cols = a.tile_cols.long()
    y = fold_rows(a.tiles, ptr[1:] - ptr[:-1], lambda rows, j: ptr[rows] + j,
                  lambda rows, j: cols[ptr[rows] + j], x, sr)
    return y.reshape(-1)


def spmv_batch(a, xs: Tensor, sr: Semiring, impl: str = "auto") -> Tensor:
    """Batched SpMV: Y = A ⊕.⊗ Xᵀ with a [B, n] block of dense vectors.
    COO/CSR share one segment-id vector across the block, so the whole
    batch reduces in one B-lane ⊕-segment-reduce over data laid out
    [nnz, B]. PaddedBSR runs kernel 1 over the block (``impl="ref"``: its
    plain version; ``impl="fused"``: the fused kernel row by row); other
    formats go row by row. Row b equals ``spmv(a, xs[b], sr, impl)``."""
    if isinstance(a, (COOMatrix, CSRMatrix)):
        m, _ = a.shape
        seg = a.seg_ids if isinstance(a, CSRMatrix) else a.rows
        ok = seg < m
        xj = xs[:, torch.where(ok, a.cols, 0).long()]                  # [B, nnz]
        prod = sr.mul(a.vals.to(sr.dtype)[None], xj.to(sr.dtype))
        prod = torch.where(ok[None], prod, sr.zero)
        return sr.segment_reduce(prod.T, torch.where(ok, seg, m), m).T
    if isinstance(a, PaddedBSR) and impl != "fused":
        from repro_torch.kernels import ops

        if impl == "ref":
            return ops.semiring_spmv_batch_ref(a, xs, sr)
        return ops.semiring_spmv_batch(a, xs, sr)
    return _rows(xs, lambda x: spmv(a, x, sr, impl=impl))


def _rows(xs: Tensor, fn) -> Tensor:
    """fn on each row of xs, stacked (an empty block stays empty)."""
    if xs.shape[0] == 0:
        return fn(xs.new_zeros(xs.shape[1]))[None][:0]
    return torch.stack([fn(x) for x in xs])


def spmv(a, x: Tensor, sr: Semiring, impl: str = "auto") -> Tensor:
    if isinstance(a, COOMatrix):
        return spmv_coo(a, x, sr)
    if isinstance(a, CSRMatrix):
        return spmv_csr(a, x, sr)
    if isinstance(a, BSRMatrix):
        return spmv_bsr_ref(a, x, sr)
    if isinstance(a, PaddedBSR):
        from repro_torch.kernels import ops

        if impl == "ref":
            return ops.semiring_spmv_ref(a, x, sr)
        if impl == "fused":
            return ops.semiring_spmv_fused(a, x, sr)
        return ops.semiring_spmv(a, x, sr)
    raise TypeError(type(a))
