"""Sparse matrix containers and their host-side builders (paper §2.1, §4.1).

PyTorch counterpart of ``repro.core.formats``. The builders run the same
numpy code as the JAX package and put the outputs on ``device`` (the CUDA
card unless the caller names another). Every array is element-for-element
equal to the JAX builder's output for the same edge list.

Padding conventions (as in the JAX package)
-------------------------------------------
* COO/CSR/CSC pad ``rows``/``cols`` with an out-of-range index (= M or N)
  and ``vals`` with the semiring zero.
* PaddedBSR pads each block row with ⊕-identity tiles pointing at
  tile-column 0 (+inf tiles for the min semirings, 0 tiles otherwise).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.semiring import Semiring

Tensor = torch.Tensor

_NP_DTYPES = {torch.int32: np.int32, torch.float32: np.float32}


def _np_dtype(sr: Semiring) -> np.dtype:
    return np.dtype(_NP_DTYPES[sr.dtype])


def _background(sr: Semiring):
    return np.inf if sr.collective == "pmin" else 0


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


@dataclasses.dataclass
class COOMatrix:
    """Coordinate list, row-major sorted. ``rows``/``cols`` int32 [nnz_max],
    ``vals`` [nnz_max]; padding uses row = shape[0] (dropped)."""

    rows: Tensor
    cols: Tensor
    vals: Tensor
    nnz: int
    shape: Tuple[int, int]

    @property
    def nnz_max(self) -> int:
        return self.rows.shape[0]


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row: row_ptr [M+1], cols/vals [nnz_max], plus the
    expanded row id of every entry (``seg_ids``, padded with M)."""

    row_ptr: Tensor
    cols: Tensor
    vals: Tensor
    seg_ids: Tensor
    nnz: int
    shape: Tuple[int, int]

    @property
    def nnz_max(self) -> int:
        return self.cols.shape[0]


@dataclasses.dataclass
class CSCMatrix:
    """Compressed sparse column: col_ptr [N+1], rows/vals sorted by column.
    ``max_col_nnz`` bounds any single column's length."""

    col_ptr: Tensor
    rows: Tensor
    vals: Tensor
    nnz: int
    shape: Tuple[int, int]
    max_col_nnz: int

    @property
    def nnz_max(self) -> int:
        return self.rows.shape[0]


@dataclasses.dataclass
class PaddedBSR:
    """ELL-of-tiles: every block row padded to T slots, the layout the tile
    kernels consume.

    tiles:     [mb, T, bm, bn]  pad slots hold the ⊕-identity tile
    tile_cols: [mb, T] int32    pad slots point at tile-column 0
    """

    tiles: Tensor
    tile_cols: Tensor
    shape: Tuple[int, int]
    block: Tuple[int, int]

    @property
    def n_block_rows(self) -> int:
        return self.tiles.shape[0]

    @property
    def slots(self) -> int:
        return self.tiles.shape[1]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              shape: Tuple[int, int], sr: Semiring, nnz_max: int | None = None,
              device=None) -> COOMatrix:
    device = resolve_device(device)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    nnz = rows.shape[0]
    nnz_max = nnz_max or _round_up(max(nnz, 1), 8)
    return COOMatrix(
        rows=torch.from_numpy(_pad_to(rows.astype(np.int32), nnz_max, shape[0])).to(device),
        cols=torch.from_numpy(_pad_to(cols.astype(np.int32), nnz_max, shape[1])).to(device),
        vals=torch.from_numpy(_pad_to(vals.astype(_np_dtype(sr)), nnz_max,
                                      _background(sr))).to(device),
        nnz=nnz,
        shape=shape,
    )


def build_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              shape: Tuple[int, int], sr: Semiring, nnz_max: int | None = None,
              device=None) -> CSRMatrix:
    coo = build_coo(rows, cols, vals, shape, sr, nnz_max, device)
    m = shape[0]
    counts = np.bincount(coo.rows[: coo.nnz].cpu().numpy(), minlength=m + 1)[:m]
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return CSRMatrix(
        row_ptr=torch.from_numpy(row_ptr).to(coo.rows.device),
        cols=coo.cols,
        vals=coo.vals,
        seg_ids=coo.rows,
        nnz=coo.nnz,
        shape=shape,
    )


def build_csc(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              shape: Tuple[int, int], sr: Semiring, nnz_max: int | None = None,
              device=None) -> CSCMatrix:
    device = resolve_device(device)
    order = np.lexsort((rows, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]
    nnz = rows.shape[0]
    nnz_max = nnz_max or _round_up(max(nnz, 1), 8)
    n = shape[1]
    counts = np.bincount(cols, minlength=n)
    col_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    max_col_nnz = int(counts.max()) if nnz else 1
    return CSCMatrix(
        col_ptr=torch.from_numpy(col_ptr).to(device),
        rows=torch.from_numpy(_pad_to(rows.astype(np.int32), nnz_max, shape[0])).to(device),
        vals=torch.from_numpy(_pad_to(vals.astype(_np_dtype(sr)), nnz_max,
                                      _background(sr))).to(device),
        nnz=nnz,
        shape=shape,
        max_col_nnz=max(1, max_col_nnz),
    )


@dataclasses.dataclass
class _TileEntries:
    """Output of :func:`_densify_tiles`: the stored tiles and their entries.

    keys:     int64 [n_tiles]  trow·nb + tcol of every nonzero tile, ascending
    tile:     int64 [n_elems]  index into ``keys`` of each distinct element
    offset:   int64 [n_elems]  lr·bn + lc inside the tile
    value:    [n_elems]        background ⊕ every entry at that element
    """

    keys: np.ndarray
    tile: np.ndarray
    offset: np.ndarray
    value: np.ndarray


def _densify_tiles(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   shape: Tuple[int, int], sr: Semiring,
                   block: Tuple[int, int]) -> _TileEntries:
    """Shared tile-densification pass. The JAX package fills one dense
    (bm, bn) numpy tile per stored tile; here only the stored elements are
    kept, so the tile payload is written once, on the device. Entries are
    ⊕-folded into the background in the same (row-tile, col-tile, input)
    order as the JAX pass, so even ⟨+,×⟩ duplicates sum bit-identically."""
    bm, bn = block
    n = shape[1]
    nb = -(-n // bn)
    trow, tcol = rows // bm, cols // bn
    order = np.lexsort((tcol, trow))
    rows_s, cols_s = rows[order].astype(np.int64), cols[order].astype(np.int64)
    trow_s, tcol_s = trow[order].astype(np.int64), tcol[order].astype(np.int64)
    vals_s = vals[order].astype(_np_dtype(sr))
    keys, tile_of = np.unique(trow_s * nb + tcol_s, return_inverse=True)
    offset = (rows_s - trow_s * bm) * bn + (cols_s - tcol_s * bn)
    elems, elem_of = np.unique(tile_of.astype(np.int64) * (bm * bn) + offset,
                                  return_inverse=True)
    value = np.full(elems.shape, _background(sr), dtype=_np_dtype(sr))
    fold = {"pmin": np.minimum, "psum": np.add}.get(sr.collective, np.maximum)
    fold.at(value, elem_of, vals_s)
    return _TileEntries(keys=keys, tile=elems // (bm * bn),
                        offset=elems % (bm * bn), value=value)


def build_bsr_padded(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                     shape: Tuple[int, int], sr: Semiring,
                     block: Tuple[int, int] = (128, 128),
                     slots: int | None = None, device=None) -> PaddedBSR:
    """ELL-of-tiles builder: densify nonzero tiles, pad each block row to a
    uniform slot count. Real tiles come first in each row, in increasing
    tile-column order."""
    device = resolve_device(device)
    bm, bn = block
    m, n = shape
    mb, nb = -(-m // bm), -(-n // bn)
    ent = _densify_tiles(rows, cols, vals, shape, sr, block)
    trow, tcol = ent.keys // nb, ent.keys % nb
    counts = np.bincount(trow, minlength=mb)
    t_needed = max(1, int(counts.max()) if counts.size else 1)
    slots = slots or t_needed
    if slots < t_needed:
        raise ValueError(f"slots={slots} < needed {t_needed}")
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    slot = np.arange(ent.keys.shape[0], dtype=np.int64) - row_start[trow]
    tile_cols_np = np.zeros((mb, slots), dtype=np.int32)
    tile_cols_np[trow, slot] = tcol
    tiles = torch.full((mb, slots, bm, bn), _background(sr), dtype=sr.dtype, device=device)
    flat = (trow * slots + slot)[ent.tile] * (bm * bn) + ent.offset
    tiles.view(-1)[torch.from_numpy(flat).to(device)] = torch.from_numpy(ent.value).to(device)
    return PaddedBSR(
        tiles=tiles,
        tile_cols=torch.from_numpy(tile_cols_np).to(device),
        shape=(mb * bm, nb * bn),
        block=block,
    )
