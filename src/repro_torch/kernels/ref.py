"""Plain PyTorch versions of the tile kernels, the MoE dispatch gather and
its transpose.

The CPU path of every kernel wrapper, and the version ``chip_smoke.py``
holds each CUDA kernel against on the card. Each folds a block row's slots
in slot order, as the kernels do (``repro.kernels.ref`` is the JAX
counterpart).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:   # core imports this module: no import cycle at run time
    from repro_torch.core.semiring import Semiring

Tensor = torch.Tensor


def spmv_padded_ref(tiles: Tensor, tile_cols: Tensor, x: Tensor, sr: Semiring) -> Tensor:
    """y = A ⊕.⊗ x over the ELL-of-tiles layout, every slot folded, pads
    included. tiles [mb, T, bm, bn]; tile_cols [mb, T]; x [nb·bn]."""
    mb, t, bm, bn = tiles.shape
    x_blocks = x.view(-1, bn).to(sr.dtype)
    y = torch.full((mb, bm), sr.zero, dtype=sr.dtype, device=tiles.device)
    for j in range(t):
        xb = x_blocks[tile_cols[:, j].long()]                       # [mb, bn]
        contrib = sr.add_reduce(sr.mul(tiles[:, j], xb[:, None, :]), dim=2)
        y = sr.add(y, contrib)
    return y.reshape(-1).to(x.dtype)


def spmspv_padded_ref(tiles: Tensor, meta: Tensor, x: Tensor, sr: Semiring) -> Tensor:
    """Frontier-filtered fold. meta int32 [mb, 1+2T] = (n_active,
    slot permutation, permuted tile-cols); only the first n_active
    permuted slots of each row contribute. The plain version of both
    SpMSpV kernels: the fused one computes the same function."""
    mb, t, bm, bn = tiles.shape
    x_blocks = x.view(-1, bn).to(sr.dtype)
    n_active = meta[:, 0]
    perm = meta[:, 1:1 + t].long()
    cols = meta[:, 1 + t:].long()
    rows = torch.arange(mb, device=tiles.device)
    y = torch.full((mb, bm), sr.zero, dtype=sr.dtype, device=tiles.device)
    steps = int(n_active.max()) if mb else 0
    for j in range(steps):
        a = tiles[rows, perm[:, j]]                                 # [mb, bm, bn]
        contrib = sr.add_reduce(sr.mul(a, x_blocks[cols[:, j]][:, None, :]), dim=2)
        y = torch.where((j < n_active)[:, None], sr.add(y, contrib), y)
    return y.reshape(-1).to(x.dtype)


def spmv_padded_batch_ref(tiles: Tensor, tile_cols: Tensor, xs: Tensor, sr: Semiring) -> Tensor:
    """Kernel 1 over a block: ``spmv_padded_ref`` on each row of xs
    [B, nb·bn]; ys [B, mb·bm]."""
    mb, _, bm, _ = tiles.shape
    return torch.stack([spmv_padded_ref(tiles, tile_cols, x, sr) for x in xs]) if xs.shape[0] \
        else xs.new_empty((0, mb * bm))


def spmspv_padded_batch_ref(tiles: Tensor, meta: Tensor, xs: Tensor, sr: Semiring) -> Tensor:
    """Kernel 2 over a block: ``spmspv_padded_ref`` on row b's meta
    [mb, 1+2T] and x; meta [B, mb, 1+2T], xs [B, nb·bn]; ys [B, mb·bm]."""
    mb, _, bm, _ = tiles.shape
    return torch.stack([spmspv_padded_ref(tiles, m, x, sr) for m, x in zip(meta, xs)]) \
        if xs.shape[0] else xs.new_empty((0, mb * bm))


def fold_rows(tiles: Tensor, n: Tensor, slot, col, x: Tensor, sr: Semiring) -> Tensor:
    """y [mb, bm]: row i ⊕-folds tiles[slot(i, j)] ⊗ x_block[col(i, j)]
    for j < n[i], in j order. tiles [S, bm, bn] flat; ``slot`` and ``col``
    map (rows, j) to int64 indices. Rows are taken longest first, so the
    rows still folding at step j are a prefix and each step gathers only
    their tiles: no padded copy of the matrix is made."""
    _, bm, bn = tiles.shape
    mb = n.shape[0]
    x_blocks = x.view(-1, bn).to(sr.dtype)
    y = torch.full((mb, bm), sr.zero, dtype=sr.dtype, device=tiles.device)
    order = torch.argsort(n, descending=True, stable=True)
    live = np.bincount(n.cpu().numpy().astype(np.int64), minlength=1)[::-1].cumsum()[::-1]
    for j in range(1, live.shape[0]):
        rows = order[: int(live[j])]
        contrib = sr.add_reduce(sr.mul(tiles[slot(rows, j - 1)],
                                       x_blocks[col(rows, j - 1)][:, None, :]), dim=2)
        y[rows] = sr.add(y[rows], contrib)
    return y


def spmv_fused_padded_ref(tiles: Tensor, meta: Tensor, x: Tensor, sr: Semiring) -> Tensor:
    """Plain version of the fused SpMV: meta int32 [mb, 1+T] = (n_real |
    tile_cols); only the first n_real slots of each row are folded."""
    mb, t, bm, bn = tiles.shape
    cols = meta[:, 1:].long()
    y = fold_rows(tiles.reshape(-1, bm, bn), meta[:, 0],
                  lambda rows, j: rows * t + j, lambda rows, j: cols[rows, j], x, sr)
    return y.reshape(-1).to(x.dtype)


def spmv_sell_ref(tiles: Tensor, tile_cols: Tensor, row_meta: Tensor, x: Tensor,
                  sr: Semiring) -> Tensor:
    """Plain version of the sell-C-σ SpMV: tiles [slot_total, bm, bn];
    row_meta int32 [mb, 3] = (out_block, base, n_real) in compute order.
    Row i folds tiles[base : base + n_real] and lands in block out_block;
    a row with n_real = 0 is the ⊕-identity. Offsets are int64."""
    base = row_meta[:, 1].long()
    cols = tile_cols.long()
    y = fold_rows(tiles, row_meta[:, 2], lambda rows, j: base[rows] + j,
                  lambda rows, j: cols[base[rows] + j], x, sr)
    out = torch.empty_like(y)
    out[row_meta[:, 0].long()] = y
    return out.reshape(-1).to(x.dtype)


# The plain version of kernel 6 evaluates the ⊗ broadcast of a chunk of
# output tiles against one slot at a time; this caps that broadcast.
SPGEMM_BROADCAST_BYTES = 1 << 30


def spgemm_padded_ref(tiles: Tensor, meta: Tensor, b: Tensor, mask: Tensor, sr: Semiring,
                      bn: int) -> Tensor:
    """C = (A ⊕.⊗ B) ⊙ mask over the ELL-of-tiles layout, the plain version
    of the masked tile SpGEMM. tiles [mb, T, bm, bk]; meta int32 [mb, T+nb]
    = (tile_cols | mask-tile flags); b [kb·bk, nb·bn]; mask [mb·bm, nb·bn].

    Each output tile whose flag is set ⊕-folds its block row's T slots in
    slot order, pads included, then keeps its entries where mask ≠ zero; the
    others are the ⊕-identity (an empty mask tile masks them all). Only the
    flagged tiles are computed, vectorised over chunks of them, so no
    [bm, bk, N] broadcast over every column is built."""
    mb, t, bm, bk = tiles.shape
    n = b.shape[1]
    nb = n // bn
    cols = meta[:, :t].long()
    active = torch.nonzero(meta[:, t:] > 0)                           # [n_act, 2]
    out = torch.full((mb * bm, n), sr.zero, dtype=sr.dtype, device=tiles.device)
    out_tiles = out.view(mb, bm, nb, bn)
    b_blocks = b.view(-1, bk, nb, bn)
    mask_tiles = mask.view(mb, bm, nb, bn)
    chunk = max(1, SPGEMM_BROADCAST_BYTES // (bm * bk * bn * tiles.element_size()))
    for s in range(0, active.shape[0], chunk):
        ii, jj = active[s:s + chunk].unbind(1)
        acc = torch.full((ii.shape[0], bm, bn), sr.zero, dtype=sr.dtype, device=tiles.device)
        for slot in range(t):
            a = tiles[ii, slot]                                       # [c, bm, bk]
            bb = b_blocks[cols[ii, slot], :, jj]                      # [c, bk, bn]
            acc = sr.add(acc, sr.add_reduce(sr.mul(a[:, :, :, None], bb[:, None]), dim=2))
        keep = mask_tiles[ii, :, jj] != sr.zero                       # [c, bm, bn]
        out_tiles[ii, :, jj] = torch.where(keep, acc, sr.zero)
    return out


def pad_row(b: Tensor, sr: Semiring, bk: int) -> Tensor:
    """P [nb·bn]: P[c] = ⊕_{k<bk} (zero ⊗ b[k, c]), what one pad slot (the
    ⊕-identity tile under tile-column 0) adds to output column c, reduced
    as ``spgemm_padded_ref`` reduces a slot. Under ⟨+,×⟩ it is ±0 or NaN
    (0·inf), under the min semirings +inf or NaN, under ⟨+,∧⟩ Σ min(0, b)."""
    zero = torch.full((), sr.zero, dtype=sr.dtype, device=b.device)
    return sr.add_reduce(sr.mul(zero, b[:bk]), dim=0).contiguous()


def spgemm_pad_row_ref(tiles: Tensor, meta: Tensor, b: Tensor, mask: Tensor, sr: Semiring,
                       bn: int) -> Tensor:
    """The masked tile SpGEMM as the CUDA kernel decomposes it, in plain
    PyTorch: each flagged output tile folds its block row's ``ell_n_real``
    real slots as ``spgemm_padded_ref`` folds a slot, then its pad slots
    as the kernel folds them: npad · ``pad_row`` for the int32 sum, else
    ⊕ ``pad_row`` once (⊕ is idempotent for min and max, and the f32
    sum's P is ±0 or NaN, which a second add leaves as the first left
    it); then the mask. Pads come after the real slots and each adds P,
    so this is ``spgemm_padded_ref``'s function, bit for bit where both
    reduce alike. Same operands."""
    mb, t, bm, bk = tiles.shape
    n = b.shape[1]
    nb = n // bn
    cols = meta[:, :t].long()
    n_real = ell_n_real(meta[:, :t]).long()
    p = pad_row(b, sr, bk).view(nb, bn)
    active = torch.nonzero(meta[:, t:] > 0)                           # [n_act, 2]
    out = torch.full((mb * bm, n), sr.zero, dtype=sr.dtype, device=tiles.device)
    out_tiles = out.view(mb, bm, nb, bn)
    b_blocks = b.view(-1, bk, nb, bn)
    mask_tiles = mask.view(mb, bm, nb, bn)
    chunk = max(1, SPGEMM_BROADCAST_BYTES // (bm * bk * bn * tiles.element_size()))
    for s in range(0, active.shape[0], chunk):
        ii, jj = active[s:s + chunk].unbind(1)
        real = n_real[ii]
        acc = torch.full((ii.shape[0], bm, bn), sr.zero, dtype=sr.dtype, device=tiles.device)
        for slot in range(int(real.max())):
            live = (slot < real)[:, None, None]
            a = tiles[ii, slot]                                       # [c, bm, bk]
            bb = b_blocks[cols[ii, slot], :, jj]                      # [c, bk, bn]
            contrib = sr.add_reduce(sr.mul(a[:, :, :, None], bb[:, None]), dim=2)
            acc = torch.where(live, sr.add(acc, contrib), acc)
        pads = (t - real)[:, None, None]
        pj = p[jj][:, None, :]
        if sr.name == "plus_and":
            acc = acc + pads.to(sr.dtype) * pj
        else:
            acc = torch.where(pads > 0, sr.add(acc, pj), acc)
        keep = mask_tiles[ii, :, jj] != sr.zero                       # [c, bm, bn]
        out_tiles[ii, :, jj] = torch.where(keep, acc, sr.zero)
    return out


def ell_n_real(tile_cols: Tensor) -> Tensor:
    """Real (non-pad) slots per block row, from the metadata alone: the
    builder stores real tiles first in strictly increasing tile-column order
    and pads repeat tile-column 0, so n_real = 1 + #strict increases. A row
    with no real tile comes out as 1: it streams one pad slot."""
    return (1 + (tile_cols[:, 1:] > tile_cols[:, :-1]).sum(dim=1)).to(torch.int32)


def pack_binary_ref(tiles: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """The tensor-core SpGEMM's int8 operands: A's tiles as they are and B
    transposed to [N, K], both contiguous."""
    return tiles.to(torch.int8), b.to(torch.int8).t().contiguous()


def spgemm_binary_ref(tiles: Tensor, meta: Tensor, b: Tensor, mask: Tensor, sr: Semiring,
                      bn: int) -> Tensor:
    """Plain version of the tensor-core SpGEMM for 0/1 operands: the same
    operands as ``spgemm_padded_ref``, and on them the same result. Each
    flagged output tile sums the products of its block row's first
    ``ell_n_real`` slots only (A tile × B block, ``torch.bmm`` in float64:
    every partial sum is an integer far below 2⁵³, so it is exact, and the
    card has no int32 matrix product); ⟨∨,∧⟩ keeps count > 0. Then the
    mask, as kernel 6's."""
    mb, t, bm, bk = tiles.shape
    n = b.shape[1]
    nb = n // bn
    cols = meta[:, :t].long()
    n_real = ell_n_real(meta[:, :t]).long()
    active = torch.nonzero(meta[:, t:] > 0)                           # [n_act, 2]
    out = torch.full((mb * bm, n), sr.zero, dtype=sr.dtype, device=tiles.device)
    out_tiles = out.view(mb, bm, nb, bn)
    b_blocks = b.view(-1, bk, nb, bn)
    mask_tiles = mask.view(mb, bm, nb, bn)
    chunk = max(1, SPGEMM_BROADCAST_BYTES // ((bm * bk + bk * bn + bm * bn) * 8))
    for s in range(0, active.shape[0], chunk):
        ii, jj = active[s:s + chunk].unbind(1)
        real = n_real[ii]
        acc = torch.zeros((ii.shape[0], bm, bn), dtype=torch.float64, device=tiles.device)
        for slot in range(int(real.max())):
            live = (slot < real).to(torch.float64)[:, None, None]
            a = tiles[ii, slot].to(torch.float64) * live              # [c, bm, bk]
            bb = b_blocks[cols[ii, slot], :, jj].to(torch.float64)    # [c, bk, bn]
            acc += torch.bmm(a, bb)
        count = acc.to(sr.dtype)
        if sr.name == "bool_or_and":
            count = (count > 0).to(sr.dtype)
        keep = mask_tiles[ii, :, jj] != sr.zero
        out_tiles[ii, :, jj] = torch.where(keep, count, sr.zero)
    return out


def moe_dispatch_gather_ref(x: Tensor, slot_tok: Tensor) -> Tensor:
    """out[s] = x[slot_tok[s]], a zero row where slot_tok[s] is not in
    [0, T): the plain version of the MoE dispatch gather. x [T, D];
    slot_tok int32 [S] (the pad is T)."""
    t, d = x.shape
    if t == 0:
        return torch.zeros((slot_tok.shape[0], d), dtype=x.dtype, device=x.device)
    ok = (slot_tok >= 0) & (slot_tok < t)
    rows = x[slot_tok.clamp(0, t - 1).long()]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=x.dtype, device=x.device))


def moe_dispatch_gather_backward_ref(grad_out: Tensor, tok_slots: Tensor) -> Tensor:
    """grad_x[r] = Σ_j grad_out[tok_slots[r, j]] over the j whose slot is
    in [0, S), in ascending j, summed in f32 from zero and rounded once to
    grad_out's dtype; a row with no slot is zero: the plain version of the
    dispatch gather's transpose. grad_out [S, D]; tok_slots int32 [T, k]
    (the pad is S)."""
    s, d = grad_out.shape
    t, k = tok_slots.shape
    acc = torch.zeros((t, d), dtype=torch.float32, device=grad_out.device)
    if s == 0:
        return acc.to(grad_out.dtype)
    ok = (tok_slots >= 0) & (tok_slots < s)
    idx = tok_slots.clamp(0, s - 1).long()
    zero = torch.zeros((), dtype=torch.float32, device=grad_out.device)
    for j in range(k):
        acc = acc + torch.where(ok[:, j, None], grad_out[idx[:, j]].float(), zero)
    return acc.to(grad_out.dtype)
