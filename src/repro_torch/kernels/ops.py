"""Front door of the tile kernels and the MoE dispatch gather, as
``repro.kernels.ops`` is for the TPU kernels: operand preparation (dtype
casts, the fused, SpMSpV and SpGEMM metadata, the dense frontier, the
SpGEMM padding), the choice between kernel 6 and its tensor-core variant
for 0/1 operands, the [B, n] block calls of kernels 1 and 2 behind the
multi-source traversals, the plain ``*_ref`` counterparts of the unfused
calls, the bytes and work each tile kernel needs (``*_stream_stats``), and
``moe_dispatch``: the MoE dispatch gather under autograd, its backward the
gather's transpose (kernel 7ᵀ)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import PaddedBSR, SlicedELL
from repro_torch.core.semiring import Semiring
from repro_torch.core.spmspv import Frontier
from repro_torch.kernels import ref, spgemm_binary
from repro_torch.kernels.moe_dispatch import moe_dispatch_gather as _moe_dispatch_gather
from repro_torch.kernels.moe_dispatch import moe_dispatch_gather_backward
from repro_torch.kernels.semiring_spmv import (
    semiring_spmv_fused_padded, semiring_spmv_padded, semiring_spmv_padded_batch,
    semiring_spmv_sell,
)
from repro_torch.kernels.spgemm_binary import semiring_spgemm_binary
from repro_torch.kernels.spgemm_tiles import semiring_spgemm_padded
from repro_torch.kernels.spmspv_tiles import (
    semiring_spmspv_fused_padded, semiring_spmspv_padded, semiring_spmspv_padded_batch,
)

Tensor = torch.Tensor


def semiring_spmv(a: PaddedBSR, x: Tensor, sr: Semiring) -> Tensor:
    """y = A ⊕.⊗ x (dense x). x length must be a.shape[1] (padded)."""
    _check_x(x, a.shape)
    return semiring_spmv_padded(a.tiles, a.tile_cols, x.to(sr.dtype).contiguous(), sr=sr)


def _check_x(x: Tensor, shape) -> None:
    if x.shape[0] != shape[1]:
        raise ValueError(f"x has {x.shape[0]} entries, the matrix {shape[1]} columns")


def _spmv_fused_meta(a: PaddedBSR) -> Tensor:
    """int32 [mb, 1+T] = (n_real | tile_cols) for the fused SpMV kernel."""
    return torch.cat([ref.ell_n_real(a.tile_cols)[:, None], a.tile_cols], dim=1)


def semiring_spmv_fused(a: PaddedBSR, x: Tensor, sr: Semiring,
                        chunks: int | None = None) -> Tensor:
    """Fused Load+Kernel SpMV: only each block row's real slots are read.
    Equal to ``semiring_spmv`` where pad ⊗ x is the ⊕-identity; with
    ``chunks=d`` the output is chunk-major [d, m/d]."""
    _check_x(x, a.shape)
    return semiring_spmv_fused_padded(a.tiles, _spmv_fused_meta(a),
                                      x.to(sr.dtype).contiguous(), sr=sr, chunks=chunks)


def semiring_spmv_sliced(s: SlicedELL, x: Tensor, sr: Semiring,
                         chunks: int | None = None) -> Tensor:
    """Fused SpMV over the sell-C-σ layout, output in the original row
    order."""
    _check_x(x, s.shape)
    return semiring_spmv_sell(s.tiles, s.tile_cols, s.row_meta, x.to(sr.dtype).contiguous(),
                              sr=sr, chunks=chunks)


def _spmspv_meta(a: PaddedBSR, f: Frontier, sr: Semiring) -> Tensor:
    """Per block row, compact the slots whose tile-column is frontier-active
    to the front: int32 [mb, 1+2T] = (n_active | perm | permuted cols).
    Only metadata moves, never tile payloads."""
    bn = a.block[1]
    nb = a.shape[1] // bn
    dev = a.tile_cols.device
    # active tile-columns from the frontier indices; pads (index n) land in
    # the spill entry nb, which is sliced off
    tile_idx = torch.where(f.indices < f.n, f.indices // bn, nb).long()
    # index_fill_, not ``active_cols[tile_idx] = True``: a Python value set
    # through an index tensor is copied to the card first, and that copy
    # waits for the stream
    active_cols = torch.zeros(nb + 1, dtype=torch.bool, device=dev).index_fill_(0, tile_idx, True)
    slot_active = active_cols[:nb][a.tile_cols.long()]                # [mb, T]
    # pad slots alias tile-column 0 but hold identity tiles: harmless
    perm = torch.argsort((~slot_active).to(torch.int8), dim=1, stable=True)
    n_active = slot_active.sum(dim=1, dtype=torch.int32)
    cols_perm = torch.gather(a.tile_cols, 1, perm)
    return torch.cat([n_active[:, None], perm.to(torch.int32), cols_perm], dim=1)


def _dense_frontier(a: PaddedBSR, f: Frontier, sr: Semiring) -> Tensor:
    x_dense = f.to_dense(sr)
    pad = a.shape[1] - x_dense.shape[0]
    if pad:
        x_dense = torch.nn.functional.pad(x_dense, (0, pad), value=sr.zero)
    return x_dense


def semiring_spmspv(a: PaddedBSR, f: Frontier, sr: Semiring) -> Tensor:
    """y = A ⊕.⊗ x with x given as a sparse Frontier. Only active column
    tiles are read (the paper's CSC-SpMSpV work-skipping, at tile
    granularity)."""
    return semiring_spmspv_padded(a.tiles, _spmspv_meta(a, f, sr),
                                  _dense_frontier(a, f, sr), sr=sr)


def semiring_spmspv_fused(a: PaddedBSR, f: Frontier, sr: Semiring,
                          chunks: int | None = None) -> Tensor:
    """Fused SpMSpV: ``semiring_spmspv``'s function through the fused
    kernel, optionally chunk-major."""
    return semiring_spmspv_fused_padded(a.tiles, _spmspv_meta(a, f, sr),
                                        _dense_frontier(a, f, sr), sr=sr, chunks=chunks)


def _check_xs(xs: Tensor, shape) -> None:
    if xs.dim() != 2 or xs.shape[1] != shape[1]:
        raise ValueError(f"xs must be [B, {shape[1]}], got {tuple(xs.shape)}")


def semiring_spmv_batch(a: PaddedBSR, xs: Tensor, sr: Semiring) -> Tensor:
    """Y [B, a.shape[0]] with row b = A ⊕.⊗ xs[b]: kernel 1 over the
    block, xs [B, a.shape[1]] (padded), as ``jax.vmap`` of ``semiring_spmv``."""
    _check_xs(xs, a.shape)
    return semiring_spmv_padded_batch(a.tiles, a.tile_cols, xs.to(sr.dtype).contiguous(), sr=sr)


def semiring_spmv_batch_ref(a: PaddedBSR, xs: Tensor, sr: Semiring) -> Tensor:
    _check_xs(xs, a.shape)
    return ref.spmv_padded_batch_ref(a.tiles, a.tile_cols, xs.to(sr.dtype), sr)


def _frontier_block(a: PaddedBSR, xs: Tensor, sr: Semiring, f_max: int | None):
    """Each row of xs [B, n] (n <= a.shape[1]) compressed as
    ``frontier_from_dense(x, sr, f_max)`` compresses it, kept as a mask and
    a dense block: the first ``f_max`` live entries of every row, and
    xs [B, a.shape[1]] with the rest ⊕-identity, each value passed through
    ⊕ with the identity as ``Frontier.to_dense`` scatters it."""
    n = xs.shape[1]
    if n > a.shape[1]:
        raise ValueError(f"xs has {n} columns, the matrix {a.shape[1]}")
    keep = xs != sr.zero
    if f_max is not None and f_max < n:
        keep &= torch.cumsum(keep, dim=1) <= f_max
    x = xs.to(sr.dtype)
    xd = torch.where(keep, sr.add(torch.full_like(x, sr.zero), x), sr.zero)
    pad = a.shape[1] - n
    if pad:
        keep = torch.nn.functional.pad(keep, (0, pad), value=False)
        xd = torch.nn.functional.pad(xd, (0, pad), value=sr.zero)
    return keep, xd.contiguous()


def _spmspv_meta_batch(a: PaddedBSR, keep: Tensor) -> Tensor:
    """``_spmspv_meta`` for each row of a frontier mask keep [B,
    a.shape[1]]: int32 [B, mb, 1+2T] = (n_active | perm | permuted cols)."""
    b = keep.shape[0]
    mb, t = a.tile_cols.shape
    bn = a.block[1]
    tile_active = keep.view(b, a.shape[1] // bn, bn).any(dim=2)       # [B, nb]
    slot_active = tile_active[:, a.tile_cols.long()]                  # [B, mb, T]
    perm = torch.argsort((~slot_active).to(torch.int8), dim=2, stable=True)
    n_active = slot_active.sum(dim=2, dtype=torch.int32)
    cols_perm = torch.gather(a.tile_cols.expand(b, mb, t), 2, perm)
    return torch.cat([n_active[..., None], perm.to(torch.int32), cols_perm], dim=2).contiguous()


UNION_GROUP = 32    # vectors a CTA of the block fold owns (kVecGroup, csrc/tile_fold.cuh)


def _spmspv_union_batch(meta: Tensor) -> Tensor:
    """Kernel 2's operands over a block, from the per-vector metas [B, mb,
    1+2T]: for each group g of 32 vectors and block row i, int32 [G, mb,
    1+3T] = (n_union | union slots | their tile-columns | masks), the slots
    active for some vector of the group, in slot order; bit k of a mask
    (as uint32) says the slot is active for vector 32g + k. A meta lists its
    active slots in slot order, so the union slots whose bit vector b has
    are meta[b, i, 1:1+n_active], in that order. Built with tensor ops on
    the metas' device, no host read."""
    b, mb, w = meta.shape
    t = (w - 1) // 2
    if b == 0:
        return meta.new_zeros((0, mb, 1 + 3 * t))
    dev = meta.device
    perm = meta[..., 1:1 + t].long()
    listed = torch.arange(t, device=dev) < meta[..., :1]                # [B, mb, T] by position
    active = torch.zeros((b, mb, t), dtype=torch.bool, device=dev).scatter_(2, perm, listed)
    g = -(-b // UNION_GROUP)
    active = torch.nn.functional.pad(active, (0, 0, 0, 0, 0, g * UNION_GROUP - b))
    bit = torch.arange(UNION_GROUP, dtype=torch.int64, device=dev).view(1, -1, 1, 1)
    masks = (active.view(g, UNION_GROUP, mb, t).long() << bit).sum(dim=1)   # [G, mb, T]
    in_union = masks != 0
    masks = torch.where(masks >= 2**31, masks - 2**32, masks).to(torch.int32)
    # every meta holds the whole slot permutation: tile_cols from vector 0's
    tile_cols = torch.empty((mb, t), dtype=torch.int32, device=dev).scatter_(
        1, perm[0], meta[0, :, 1 + t:])
    order = torch.argsort((~in_union).to(torch.int8), dim=2, stable=True)
    n_union = in_union.sum(dim=2, dtype=torch.int32)
    cols = torch.gather(tile_cols.expand(g, mb, t), 2, order)
    return torch.cat([n_union[..., None], order.to(torch.int32), cols,
                      torch.gather(masks, 2, order)], dim=2).contiguous()


def semiring_spmspv_batch(a: PaddedBSR, xs: Tensor, sr: Semiring,
                          f_max: int | None = None) -> Tensor:
    """Y [B, a.shape[0]] with row b = ``semiring_spmspv(a,
    frontier_from_dense(xs[b], sr, f_max), sr)``: each row's capacity-f_max
    frontier and its own active-slot meta, kernel 2 over the block. xs
    [B, n] dense, n <= a.shape[1] (the frontier's length)."""
    keep, xd = _frontier_block(a, xs, sr, f_max)
    return semiring_spmspv_padded_batch(a.tiles, _spmspv_meta_batch(a, keep), xd, sr=sr)


def semiring_spmspv_batch_ref(a: PaddedBSR, xs: Tensor, sr: Semiring,
                              f_max: int | None = None) -> Tensor:
    keep, xd = _frontier_block(a, xs, sr, f_max)
    return ref.spmspv_padded_batch_ref(a.tiles, _spmspv_meta_batch(a, keep), xd, sr)


def _spgemm_operands(a: PaddedBSR, b: Tensor, sr: Semiring, mask: Tensor | None):
    """Pad B and the mask to the kernel's block grid and build its meta.
    B's column pad is the ⊗-identity (it annihilates against the
    ⊕-identity pad tiles of A, min_times-safe); the mask's column pad is the
    ⊕-identity, so padded output columns collapse to zero and slice away.
    ``mask=None`` is all ones with the padded columns zero. Output tiles are
    square (bn = bm). Returns (b, mask, meta, bn, n)."""
    bm, _ = a.block
    m_pad, k_pad = a.shape
    if b.shape[0] != k_pad:
        raise ValueError(f"b has {b.shape[0]} rows, the matrix {k_pad} columns")
    n = b.shape[1]
    bn = bm
    n_pad = -(-n // bn) * bn
    bp = torch.nn.functional.pad(b.to(sr.dtype), (0, n_pad - n), value=sr.one)
    if mask is None:
        mk = torch.full((m_pad, n_pad), sr.one, dtype=sr.dtype, device=b.device)
        mk[:, n:] = sr.zero
    else:
        if tuple(mask.shape) != (m_pad, n):
            raise ValueError(f"mask must be {[m_pad, n]}, got {tuple(mask.shape)}")
        mk = torch.nn.functional.pad(mask.to(sr.dtype), (0, n_pad - n), value=sr.zero)
    mb, nb = m_pad // bm, n_pad // bn
    tile_any = (mk.view(mb, bm, nb, bn) != sr.zero).any(dim=3).any(dim=1).to(torch.int32)
    meta = torch.cat([a.tile_cols, tile_any], dim=1)
    return bp, mk, meta, bn, n


def _binary_operands(a: PaddedBSR, bp: Tensor, sr: Semiring) -> bool:
    """Whether the tensor-core variant computes this product: ⟨+,∧⟩ or
    ⟨∨,∧⟩, bm and bk multiples of 16, and every value of A's tiles and of
    the padded B in {0, 1} (one ``aminmax`` per operand, one host sync).
    Exact there: min(a, b) = a·b on {0, 1}; pad tiles are 0, so skipping
    them changes nothing; int32 sums are exact in any order; ⟨∨,∧⟩ is
    count > 0. B's column pad is ``sr.one`` = 1, so it stays 0/1."""
    if not spgemm_binary.takes(sr, *a.block) or a.tiles.numel() == 0 or bp.numel() == 0:
        return False
    lo_a, hi_a = torch.aminmax(a.tiles)
    lo_b, hi_b = torch.aminmax(bp)
    lo, hi = torch.stack([torch.minimum(lo_a, lo_b), torch.maximum(hi_a, hi_b)]).tolist()
    return lo >= 0 and hi <= 1


def semiring_spgemm(a: PaddedBSR, b: Tensor, sr: Semiring, mask: Tensor | None = None) -> Tensor:
    """C = (A ⊕.⊗ B) ⊙ mask. A in ELL-of-tiles; B dense [a.shape[1], N];
    mask dense [a.shape[0], N] or None. Output [a.shape[0], N]. The
    operands decide the kernel before any launch: the tensor-core variant
    (``kernels/spgemm_binary.py``) where ``_binary_operands`` holds, kernel
    6 (``kernels/spgemm_tiles.py``) otherwise. Each launches or raises."""
    bp, mk, meta, bn, n = _spgemm_operands(a, b, sr, mask)
    kernel = semiring_spgemm_binary if _binary_operands(a, bp, sr) else semiring_spgemm_padded
    return kernel(a.tiles, meta, bp, mk, sr=sr, bn=bn)[:, :n]


def semiring_spgemm_ref(a: PaddedBSR, b: Tensor, sr: Semiring,
                        mask: Tensor | None = None) -> Tensor:
    bp, mk, meta, bn, n = _spgemm_operands(a, b, sr, mask)
    return ref.spgemm_padded_ref(a.tiles, meta, bp, mk, sr, bn)[:, :n]


def moe_dispatch_gather(x: Tensor, slot_tok: Tensor, *, group: int | None = None,
                        experts: int | None = None) -> Tensor:
    """Expert-buffer row gather: out[s] = x[slot_tok[s]], zero rows for the
    pad slots (slot_tok == T). ``group``/``experts``: the layout hint of a
    ``dispatch_plan`` buffer (see ``kernels/moe_dispatch.py``). Operands
    already contiguous and int32 pass through without a copy."""
    if not x.is_contiguous():
        x = x.contiguous()
    if slot_tok.dtype != torch.int32:
        slot_tok = slot_tok.to(torch.int32)
    if not slot_tok.is_contiguous():
        slot_tok = slot_tok.contiguous()
    return _moe_dispatch_gather(x, slot_tok, group=group, experts=experts)


def moe_dispatch_gather_ref(x: Tensor, slot_tok: Tensor) -> Tensor:
    return ref.moe_dispatch_gather_ref(x, slot_tok.to(torch.int32))


class MoEDispatch(torch.autograd.Function):
    """The dispatch gather as an autograd node, on every device: forward
    through ``moe_dispatch_gather`` (kernel 7, or its plain version on the
    CPU), backward through ``moe_dispatch_gather_backward`` (kernel 7ᵀ, or
    its plain version), which needs the plan's per-token slots."""

    @staticmethod
    def forward(ctx, x, slot_tok, tok_slots, group, experts):
        ctx.save_for_backward(tok_slots)
        return moe_dispatch_gather(x, slot_tok, group=group, experts=experts)

    @staticmethod
    def backward(ctx, grad_out):
        (tok_slots,) = ctx.saved_tensors
        return moe_dispatch_gather_backward(grad_out.contiguous(), tok_slots), None, None, None, None


def moe_dispatch(x: Tensor, slot_tok: Tensor, tok_slots: Tensor, *, group: int | None = None,
                 experts: int | None = None) -> Tensor:
    """``moe_dispatch_gather`` differentiable in x: ``tok_slots`` int32
    [T, k] lists each token's slots, ascending, S where the assignment
    dropped (``dispatch_plan``'s ``tok_slots``)."""
    if tok_slots.dtype != torch.int32 or not tok_slots.is_contiguous():
        tok_slots = tok_slots.to(torch.int32).contiguous()
    return MoEDispatch.apply(x, slot_tok, tok_slots, group, experts)


def semiring_spmv_ref(a: PaddedBSR, x: Tensor, sr: Semiring) -> Tensor:
    return ref.spmv_padded_ref(a.tiles, a.tile_cols, x.to(sr.dtype), sr)


def semiring_spmspv_ref(a: PaddedBSR, f: Frontier, sr: Semiring) -> Tensor:
    return ref.spmspv_padded_ref(a.tiles, _spmspv_meta(a, f, sr),
                                 _dense_frontier(a, f, sr), sr)


# ---------------------------------------------------------------------------
# Bytes each kernel moves, counted on the host from the metadata that drives
# it, as the JAX package counts them for the TPU: the unfused kernels move a
# tile per grid step and an x block whenever its index changes between
# consecutive steps; the fused kernels move each real (or active) tile once
# and x once. Useful operations are one ⊗ and one ⊕ per element of every
# real slot. ``fused_bytes`` is the bytes bound of kernels 3, 4 and 5.
# ---------------------------------------------------------------------------


def _block_changes(idx: np.ndarray) -> int:
    """Copies for a sequence of per-step block indices [steps, k]: one for
    the first step plus one per change between consecutive steps."""
    if idx.shape[0] == 0:
        return 0
    return 1 + int(np.any(idx[1:] != idx[:-1], axis=1).sum())


def _stream_stats(tile_dmas_unfused: int, x_dmas_unfused: int,
                  tile_dmas_fused: int, x_elems_fused: int,
                  real_slots: int, mb: int, block, esize: int) -> dict:
    bm, bn = block
    tile_b = bm * bn * esize
    y_b = mb * bm * esize
    ops = 2 * real_slots * bm * bn
    unfused_b = tile_dmas_unfused * tile_b + x_dmas_unfused * bn * esize + y_b
    fused_b = tile_dmas_fused * tile_b + x_elems_fused * esize + y_b
    return {
        "ops": ops,
        "unfused_bytes": unfused_b,
        "fused_bytes": fused_b,
        "unfused_ai": ops / max(1, unfused_b),
        "fused_ai": ops / max(1, fused_b),
        "bytes_saved": unfused_b - fused_b,
    }


def spmv_stream_stats(a: PaddedBSR) -> dict:
    """Bytes moved by the unfused against the fused SpMV on this matrix."""
    mb, t = a.tile_cols.shape
    cols = a.tile_cols.cpu().numpy()
    real = int(ref.ell_n_real(a.tile_cols).sum())
    return _stream_stats(mb * t, _block_changes(cols.reshape(-1, 1)), real,
                         a.shape[1] // a.block[1] * a.block[1], real, mb, a.block,
                         a.tiles.element_size())


def sell_stream_stats(s: SlicedELL, a: PaddedBSR) -> dict:
    """The fused sell-C-σ SpMV against the unfused ELL kernel on the same
    edge list."""
    mb, t = a.tile_cols.shape
    cols = a.tile_cols.cpu().numpy()
    real = s.real_slots
    return _stream_stats(mb * t, _block_changes(cols.reshape(-1, 1)), real, s.shape[1],
                         real, mb, s.block, s.tiles.element_size())


def spmspv_stream_stats(a: PaddedBSR, f: Frontier, sr: Semiring) -> dict:
    """Bytes moved by the unfused against the fused SpMSpV for this
    frontier. The unfused TPU kernel's masked steps re-read a resident slot,
    so its copies follow the block-change rule on the permuted slots."""
    mb, t = a.tile_cols.shape
    meta = _spmspv_meta(a, f, sr).cpu().numpy()
    n_active = meta[:, 0]
    perm, cols_p = meta[:, 1:1 + t], meta[:, 1 + t:]
    ok = np.arange(t)[None, :] < n_active[:, None]
    slot_seq = np.where(ok, perm, perm[:, :1])
    tile_idx = np.stack([np.repeat(np.arange(mb), t), slot_seq.reshape(-1)], 1)
    x_seq = np.where(ok, cols_p, cols_p[:, :1]).reshape(-1, 1)
    active = int(n_active.sum())
    return _stream_stats(_block_changes(tile_idx), _block_changes(x_seq), active, a.shape[1],
                         active, mb, a.block, a.tiles.element_size())


def spgemm_stream_stats(a: PaddedBSR, meta: Tensor, b: Tensor, mask: Tensor) -> dict:
    """Work and bytes of one masked tile SpGEMM on ``_spgemm_operands``'
    output, counted on the host from the metadata. Kernel 6 folds every
    slot of each active output tile: ``ops`` (a ⊗ and a ⊕ per MAC) and
    ``bytes`` (tiles, meta, the active list, B, the mask read and the output
    written once each). The tensor-core variant needs only the real slots:
    ``real_macs`` = Σ over active tiles (i, j) of n_real(i)·bm·bk·bn, and
    ``real_bytes`` = the real tiles, meta, the active list, the B blocks
    that some active tile meets under a real slot, the active mask tiles,
    and the whole output, once each at the operands' element size."""
    mb, t, bm, bk = a.tiles.shape
    n = b.shape[1]
    bn = bm
    nb, kb = n // bn, b.shape[0] // bk
    esize = a.tiles.element_size()
    act = (meta[:, t:] > 0).cpu().numpy()                             # [mb, nb]
    cols = meta[:, :t].cpu().numpy()
    n_real = ref.ell_n_real(meta[:, :t]).cpu().numpy().astype(np.int64)
    n_active = int(act.sum())
    uses = np.zeros((mb, kb), np.float64)                             # row i meets k-block k
    for i in range(mb):
        uses[i, cols[i, :n_real[i]]] = 1.0
    b_blocks = int(((uses.T @ act.astype(np.float64)) > 0).sum())
    index_b = 4 * (meta.numel() + 2 * n_active)
    return {
        "n_active": n_active,
        "ops": 2 * n_active * t * bm * bk * bn,
        "bytes": esize * (a.tiles.numel() + b.numel() + 2 * mask.numel()) + index_b,
        "real_slots": int(n_real.sum()),
        "real_macs": int((n_real * act.sum(axis=1)).sum()) * bm * bk * bn,
        "real_bytes": esize * (int(n_real.sum()) * bm * bk + b_blocks * bk * bn
                               + n_active * bm * bn + mb * bm * n) + index_b,
    }
