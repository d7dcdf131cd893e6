"""Plain PyTorch versions of the tile kernels.

The CPU path of every kernel wrapper, and the version ``chip_smoke.py``
holds each CUDA kernel against on the card. Each folds a block row's slots
in slot order, as the kernels do (``repro.kernels.ref`` is the JAX
counterpart).
"""
from __future__ import annotations

import torch

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
    permuted slots of each row contribute."""
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
