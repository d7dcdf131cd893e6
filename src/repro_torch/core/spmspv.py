"""Semiring SpMSpV: y = A ⊕.⊗ x with a compressed sparse input vector
(paper §4.1).

* ``spmspv_csr_masked`` / ``spmspv_coo_masked`` scan every stored nonzero
  and mask by frontier membership (the paper's CSR/COO variants);
* ``spmspv_csc_gather`` gathers only the active columns' slices (the
  paper's winning family);
* PaddedBSR visits only column tiles with an active entry (the tile
  kernels, ``kernels/spmspv_tiles.py``; ``impl="fused"`` takes the fused
  one).

``spmspv_batch`` and ``spmspv_batch_union`` take a [B, n] block of dense
vectors (the multi-source traversals).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.formats import COOMatrix, CSCMatrix, CSRMatrix, PaddedBSR
from repro_torch.core.semiring import Semiring

Tensor = torch.Tensor


@dataclasses.dataclass
class Frontier:
    """Compressed sparse vector: indices int32 [f_max] (pad = n, out of
    range), values [f_max] (pad = semiring zero), count 0-dim int32."""

    indices: Tensor
    values: Tensor
    count: Tensor
    n: int

    @property
    def f_max(self) -> int:
        return self.indices.shape[0]

    def density(self) -> Tensor:
        """Non-zeros / n as f32: the paper's switching signal (§4.2)."""
        return self.count.to(torch.float32) / torch.tensor(
            float(self.n), dtype=torch.float32, device=self.count.device)

    def to_dense(self, sr: Semiring) -> Tensor:
        dev = self.indices.device
        dense = torch.full((self.n,), sr.zero, dtype=sr.dtype, device=dev)
        ok = self.indices < self.n
        safe = torch.where(ok, self.indices, 0).long()
        # pad entries carry the ⊕-identity to index 0, a no-op in every mode
        val = torch.where(ok, self.values.to(sr.dtype), sr.zero)
        return dense.scatter_reduce_(0, safe, val, reduce=sr.scatter_mode(),
                                     include_self=True)


def frontier_from_dense(x: Tensor, sr: Semiring, f_max: int | None = None) -> Frontier:
    """Compress a dense vector: a stable partition brings non-zeros first.
    ``f_max`` defaults to n (always lossless)."""
    n = x.shape[0]
    f_max = f_max or n
    is_nz = x != sr.zero
    count = is_nz.to(torch.int32).sum().to(torch.int32)
    order = torch.argsort((~is_nz).to(torch.int8), stable=True)
    ar = torch.arange(n, device=x.device)
    idx = torch.where(ar < count, order, n)[:f_max].to(torch.int32)
    ok = idx < n
    vals = torch.where(ok, x[torch.where(ok, idx, 0).long()].to(sr.dtype), sr.zero)
    return Frontier(idx, vals, torch.clamp(count, max=f_max), n)


def spmspv_csr_masked(a: CSRMatrix, x: Frontier, sr: Semiring) -> Tensor:
    """Paper's CSR-SpMSpV: touches every stored nonzero, masking inactive
    columns through the dense scatter of the frontier."""
    m, _ = a.shape
    x_dense = x.to_dense(sr)
    ok = a.seg_ids < m
    xj = x_dense[torch.where(ok, a.cols, 0).long()]
    prod = sr.mul(a.vals.to(sr.dtype), xj)
    prod = torch.where(ok & (xj != sr.zero), prod, sr.zero)
    return sr.segment_reduce(prod, a.seg_ids, m)


def spmspv_csc_gather(a: CSCMatrix, x: Frontier, sr: Semiring) -> Tensor:
    """Paper's CSC-SpMSpV: for each frontier entry j, slice column j's
    (rows, vals) (≤ max_col_nnz entries) and ⊕-scatter a_ij ⊗ x_j into y."""
    m, n = a.shape
    dev = x.indices.device
    ok_col = x.indices < n
    safe_j = torch.where(ok_col, x.indices, 0).long()
    start = a.col_ptr[safe_j]
    length = a.col_ptr[safe_j + 1] - start
    offs = torch.arange(a.max_col_nnz, dtype=torch.int32, device=dev)
    gidx = start[:, None] + offs[None, :]
    in_col = offs[None, :] < length[:, None]
    gidx = torch.where(in_col, gidx, a.nnz_max - 1).long()
    rows = a.rows[gidx]
    vals = a.vals[gidx].to(sr.dtype)
    prod = sr.mul(vals, x.values.to(sr.dtype)[:, None])
    valid = in_col & ok_col[:, None]
    prod = torch.where(valid, prod, sr.zero)
    seg = torch.where(valid, rows, m)
    return sr.segment_reduce(prod.reshape(-1), seg.reshape(-1), m)


def spmspv_coo_masked(a: COOMatrix, x: Frontier, sr: Semiring) -> Tensor:
    """Paper's COO-SpMSpV: full nnz scan masked by frontier membership."""
    m, _ = a.shape
    x_dense = x.to_dense(sr)
    ok = a.rows < m
    xj = x_dense[torch.where(ok, a.cols, 0).long()]
    prod = sr.mul(a.vals.to(sr.dtype), xj)
    prod = torch.where(ok & (xj != sr.zero), prod, sr.zero)
    return sr.segment_reduce(prod, torch.where(ok, a.rows, m), m)


def spmspv_batch(a, xs: Tensor, sr: Semiring, f_max: int | None = None,
                 impl: str = "auto") -> Tensor:
    """Batched SpMSpV over a [B, n] block of dense vectors: each row is
    compressed to a capacity-``f_max`` frontier and multiplied on its own,
    so row b equals ``spmspv(a, frontier_from_dense(xs[b], sr, f_max), sr,
    impl)``. PaddedBSR runs kernel 2 over the block, each row with its own
    active-slot meta (``impl="ref"``: its plain version); other formats
    and ``impl="fused"`` go row by row."""
    if isinstance(a, PaddedBSR) and impl != "fused":
        from repro_torch.kernels import ops

        if impl == "ref":
            return ops.semiring_spmspv_batch_ref(a, xs, sr, f_max)
        return ops.semiring_spmspv_batch(a, xs, sr, f_max)
    from repro_torch.core.spmv import _rows

    return _rows(xs, lambda x: spmspv(a, frontier_from_dense(x, sr, f_max=f_max), sr,
                                      impl=impl))


def spmspv_batch_union(a: CSCMatrix, xs: Tensor, sr: Semiring,
                       f_max: int | None = None) -> Tensor:
    """Batched CSC SpMSpV over the **union frontier**, the fast path for a
    query block on one graph: the active columns of all B rows are
    compressed once (capacity ``f_max``), their (rows, vals) slices
    gathered once into [F, L], multiplied by each row's entries into
    [B, F, L], and ⊕-reduced in ONE segment-reduce over [F·L, B] with the
    [F, L] ids shared across the B lanes. A row contributes only where its
    own entry is nonzero, so row b equals ``spmspv(a, frontier(xs[b]))``
    whenever ``f_max`` covers the union; under ⟨+,×⟩ the ⊕ order may
    differ, within float tolerance."""
    m, n = a.shape
    b = xs.shape[0]
    dev = xs.device
    f_max = f_max or n
    nz_any = (xs != sr.zero).any(dim=0)                               # [n]
    count = nz_any.sum()
    order = torch.argsort((~nz_any).to(torch.int8), stable=True)
    ar = torch.arange(n, device=dev)
    idx = torch.where(ar < count, order, n)[:f_max]
    ok_col = idx < n
    safe_j = torch.where(ok_col, idx, 0)
    start = a.col_ptr[safe_j]                                         # [F]
    length = a.col_ptr[safe_j + 1] - start
    offs = torch.arange(a.max_col_nnz, dtype=torch.int32, device=dev)  # [L]
    gidx = start[:, None] + offs[None, :]                             # [F, L]
    in_col = offs[None, :] < length[:, None]
    gidx = torch.where(in_col, gidx, a.nnz_max - 1).long()
    rows = a.rows[gidx]
    vals = a.vals[gidx].to(sr.dtype)
    xv = torch.where(ok_col[None, :], xs[:, safe_j].to(sr.dtype), sr.zero)  # [B, F]
    prod = sr.mul(vals[None], xv[:, :, None])                         # [B, F, L]
    valid = in_col[None] & (xv[:, :, None] != sr.zero)
    prod = torch.where(valid, prod, sr.zero)
    seg = torch.where(in_col, rows, m)                                # [F, L] shared
    flat = prod.reshape(b, -1).T                                      # [F·L, B]
    return sr.segment_reduce(flat, seg.reshape(-1), m).T


def spmspv(a, x: Frontier, sr: Semiring, impl: str = "auto") -> Tensor:
    if isinstance(a, COOMatrix):
        return spmspv_coo_masked(a, x, sr)
    if isinstance(a, CSRMatrix):
        return spmspv_csr_masked(a, x, sr)
    if isinstance(a, CSCMatrix):
        return spmspv_csc_gather(a, x, sr)
    if isinstance(a, PaddedBSR):
        from repro_torch.kernels import ops

        if impl == "ref":
            return ops.semiring_spmspv_ref(a, x, sr)
        if impl == "fused":
            return ops.semiring_spmspv_fused(a, x, sr)
        return ops.semiring_spmspv(a, x, sr)
    raise TypeError(type(a))
