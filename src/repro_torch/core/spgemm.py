"""Masked semiring SpGEMM: C = (A ⊕.⊗ B) ⊙ M (paper §5.1's whole-graph
workloads).

PyTorch counterpart of ``repro.core.spgemm``, with the same three paths:

* ``spgemm_sparse_dense`` — element formats (COO/CSR): one [nnz, N] gather
  of B's rows and one ⊕-segment-reduce per output row.
* ``spgemm_blocked``      — dense-blocked reference: ⊕-accumulate over
  K-blocks (a host loop where the JAX package scans).
* PaddedBSR               — the masked tile SpGEMM
  (``kernels/spgemm_tiles.py``, and for 0/1 operands under ⟨+,∧⟩ and
  ⟨∨,∧⟩ its tensor-core variant ``kernels/spgemm_binary.py``, chosen by
  ``kernels/ops.py::semiring_spgemm``): hand-written CUDA kernels on the
  card, their plain PyTorch versions on the host. Only output tiles with
  a non-empty mask tile are computed. Both fold only each block row's
  real slots; kernel 6 then adds one pad row for the pad slots, so NaN
  pads (0·inf) come out as the TPU kernel's, and folds ⟨+,×⟩ in fp32 on
  the CUDA cores. On the host, ``tests/test_torch_spgemm.py`` holds that
  decomposition (``kernels/ref.py::spgemm_pad_row_ref``) to the plain
  version; on the card ``chip_smoke.py`` phase 9 checks the real and pad
  pairs kernel 6 reports, and ⟨+,×⟩ on rows of ~1,000 nonzeros within
  half its tolerance.

The mask ⊙ is *structural* (GraphBLAS semantics): C keeps its value where
``mask != sr.zero`` and collapses to the ⊕-identity elsewhere. B and the
mask are dense.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import COOMatrix, CSRMatrix, PaddedBSR
from repro_torch.core.semiring import Semiring

Tensor = torch.Tensor

# Elements of one ⊗ broadcast in the blocked path's non-dot semirings: the
# JAX package leaves the [M, bk, N] broadcast to XLA's fusion; eager
# PyTorch would materialise it, so it is taken a slab of rows at a time.
_BROADCAST_ELEMS = 1 << 20


def apply_mask(c: Tensor, mask: Tensor | None, sr: Semiring) -> Tensor:
    """Structural mask: keep c where mask is stored (≠ ⊕-identity)."""
    if mask is None:
        return c
    return torch.where(mask != sr.zero, c, sr.zero)


def spgemm_dense_ref(a_dense: Tensor, b_dense: Tensor, sr: Semiring,
                     mask: Tensor | None = None) -> Tensor:
    """Row-at-a-time oracle: c_ij = ⊕_k a_ik ⊗ b_kj, one [K, N] broadcast
    live at a time."""
    a = a_dense.to(sr.dtype)
    b = b_dense.to(sr.dtype)
    c = torch.stack([sr.add_reduce(sr.mul(a_i[:, None], b), dim=0) for a_i in a])
    return apply_mask(c, mask, sr)


def _matmul_fp32(a: Tensor, b: Tensor) -> Tensor:
    """⟨+,×⟩ block product in full fp32: TF32 is turned off for the call on
    the card (and restored), as the JAX dot asks for f32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def spgemm_blocked(a_dense: Tensor, b_dense: Tensor, sr: Semiring,
                   mask: Tensor | None = None, block_k: int = 128) -> Tensor:
    """Dense-blocked path: ⊕-accumulate each K-block's contribution in
    block order. A-padding uses the ⊕-identity and B-padding the
    ⊗-identity, so padded products annihilate for every semiring
    (zero ⊗ one = zero; one avoids the min_times inf×0 domain hole)."""
    m, k = a_dense.shape
    k2, n = b_dense.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {tuple(a_dense.shape)} @ "
                         f"{tuple(b_dense.shape)}")
    kb = -(-k // block_k)
    pad = kb * block_k - k
    a = torch.nn.functional.pad(a_dense.to(sr.dtype), (0, pad), value=sr.zero)
    b = torch.nn.functional.pad(b_dense.to(sr.dtype), (0, 0, 0, pad), value=sr.one)
    rows = max(1, _BROADCAST_ELEMS // (block_k * max(n, 1)))
    c = torch.full((m, n), sr.zero, dtype=sr.dtype, device=a.device)
    for blk in range(kb):
        a_blk = a[:, blk * block_k:(blk + 1) * block_k]             # [M, bk]
        b_blk = b[blk * block_k:(blk + 1) * block_k]                # [bk, N]
        if sr.mxu_eligible:
            contrib = _matmul_fp32(a_blk, b_blk).to(c.dtype)
        else:
            contrib = torch.cat([
                sr.add_reduce(sr.mul(a_blk[r:r + rows, :, None], b_blk[None]), dim=1)
                for r in range(0, m, rows)])
        c = sr.add(c, contrib)
    return apply_mask(c, mask, sr)


def spgemm_sparse_dense(a, b_dense: Tensor, sr: Semiring) -> Tensor:
    """Element-format SpGEMM (SpMM): for each stored a_ik, ⊕-scatter
    a_ik ⊗ B[k, :] into output row i: one [nnz, N] gather and one
    segment-reduce, the N-column generalization of spmv_coo/csr."""
    m, _ = a.shape
    seg = a.seg_ids if isinstance(a, CSRMatrix) else a.rows
    ok = seg < m
    bk = b_dense[torch.where(ok, a.cols, 0).long()].to(sr.dtype)   # [nnz, N]
    prod = sr.mul(a.vals.to(sr.dtype)[:, None], bk)
    prod = torch.where(ok[:, None], prod, sr.zero)
    return sr.segment_reduce(prod, torch.where(ok, seg, m), m)


def spgemm_masked(a, b_dense: Tensor, sr: Semiring, mask: Tensor | None = None,
                  impl: str = "auto") -> Tensor:
    """Dispatch on A's container (mirrors core.spmv.spmv):

    COO/CSR     -> spgemm_sparse_dense + mask
    PaddedBSR   -> the masked tile SpGEMM (kernels/ops.py::semiring_spgemm
                   picks kernel 6 or its tensor-core variant); impl="ref"
                   selects kernel 6's plain version
    dense Tensor -> spgemm_blocked
    """
    if isinstance(a, (COOMatrix, CSRMatrix)):
        return apply_mask(spgemm_sparse_dense(a, b_dense, sr), mask, sr)
    if isinstance(a, PaddedBSR):
        from repro_torch.kernels import ops  # deferred: ops imports core

        if impl == "ref":
            return ops.semiring_spgemm_ref(a, b_dense, sr, mask=mask)
        return ops.semiring_spgemm(a, b_dense, sr, mask=mask)
    if isinstance(a, Tensor):
        return spgemm_blocked(a, b_dense, sr, mask=mask)
    raise TypeError(type(a))
