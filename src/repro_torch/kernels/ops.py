"""Front door of the tile kernels, as ``repro.kernels.ops`` is for the TPU
kernels: operand preparation (dtype casts, the SpMSpV metadata, the dense
frontier) and the plain ``*_ref`` counterparts of each kernel call."""
from __future__ import annotations

import torch

from repro_torch.core.formats import PaddedBSR
from repro_torch.core.semiring import Semiring
from repro_torch.core.spmspv import Frontier
from repro_torch.kernels import ref
from repro_torch.kernels.semiring_spmv import semiring_spmv_padded
from repro_torch.kernels.spmspv_tiles import semiring_spmspv_padded

Tensor = torch.Tensor


def semiring_spmv(a: PaddedBSR, x: Tensor, sr: Semiring) -> Tensor:
    """y = A ⊕.⊗ x (dense x). x length must be a.shape[1] (padded)."""
    if x.shape[0] != a.shape[1]:
        raise ValueError(f"x has {x.shape[0]} entries, the matrix {a.shape[1]} columns")
    return semiring_spmv_padded(a.tiles, a.tile_cols, x.to(sr.dtype).contiguous(), sr=sr)


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
    active_cols = torch.zeros(nb + 1, dtype=torch.bool, device=dev)
    active_cols[tile_idx] = True
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


def semiring_spmv_ref(a: PaddedBSR, x: Tensor, sr: Semiring) -> Tensor:
    return ref.spmv_padded_ref(a.tiles, a.tile_cols, x.to(sr.dtype), sr)


def semiring_spmspv_ref(a: PaddedBSR, f: Frontier, sr: Semiring) -> Tensor:
    return ref.spmspv_padded_ref(a.tiles, _spmspv_meta(a, f, sr),
                                 _dense_frontier(a, f, sr), sr)
