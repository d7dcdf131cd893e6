"""Sparse matrix containers and their host-side builders (paper §2.1, §4.1).

PyTorch counterpart of ``repro.core.formats``. The builders run the same
numpy code as the JAX package and put the outputs on ``device`` (the CUDA
card unless the caller names another). Every array is element-for-element
equal to the JAX builder's output for the same edge list.

Padding conventions (as in the JAX package)
-------------------------------------------
* COO/CSR/CSC pad ``rows``/``cols`` with an out-of-range index (= M or N)
  and ``vals`` with the semiring zero.
* BSRMatrix pads its tile list, PaddedBSR each block row and SlicedELL
  each slice with ⊕-identity tiles pointing at tile-column 0 (+inf tiles
  for the min semirings, 0 tiles otherwise).
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


@dataclasses.dataclass
class BSRMatrix:
    """Block-sparse row with dense (bm, bn) tiles, CSR-of-tiles metadata.

    tiles:        [t_max, bm, bn]        stored tiles in (block row, tile
                                         column) order, then ⊕-identity pads
    tile_cols:    [t_max] int32          tile-column per tile (pads: 0)
    tile_row_ptr: [n_block_rows+1] int32
    """

    tiles: Tensor
    tile_cols: Tensor
    tile_row_ptr: Tensor
    shape: Tuple[int, int]
    block: Tuple[int, int]

    @property
    def n_block_rows(self) -> int:
        return self.tile_row_ptr.shape[0] - 1

    @property
    def t_max(self) -> int:
        return self.tiles.shape[0]


@dataclasses.dataclass
class SlicedELL:
    """sell-C-σ of tiles: block rows sorted by tile count inside σ-row
    windows, grouped into slices of C rows, each slice padded only to its
    own widest row (PaddedBSR pads every row to the global widest). On
    hub-skewed graphs this removes most of the pad volume.

    tiles:     [slot_total, bm, bn]  flat, slice-major; pad slots hold the
               ⊕-identity tile
    tile_cols: [slot_total] int32    pad slots point at tile-column 0
    row_meta:  [mb, 3] int32 in compute (permuted) order:
               (out_block, base, n_real): row i folds
               tiles[base : base + n_real] into output block ``out_block``
    """

    tiles: Tensor
    tile_cols: Tensor
    row_meta: Tensor
    shape: Tuple[int, int]
    block: Tuple[int, int]
    slice_height: int
    sigma: int

    @property
    def n_block_rows(self) -> int:
        return self.row_meta.shape[0]

    @property
    def slot_total(self) -> int:
        return self.tiles.shape[0]

    @property
    def real_slots(self) -> int:
        return int(self.row_meta[:, 2].sum())

    def to_dense(self, sr: Semiring) -> Tensor:
        """⊕-scatter every real tile into a dense [m, n] tensor in the
        original row order (a test helper)."""
        bm, bn = self.block
        m, n = self.shape
        meta = self.row_meta.long()
        n_real = meta[:, 2]
        row = torch.repeat_interleave(torch.arange(meta.shape[0], device=meta.device), n_real)
        j = torch.arange(row.shape[0], device=meta.device) - (n_real.cumsum(0) - n_real)[row]
        slot = meta[row, 1] + j
        dense = torch.full((m, n), sr.zero, dtype=sr.dtype, device=self.tiles.device)
        blocks = dense.view(m // bm, bm, n // bn, bn).permute(0, 2, 1, 3)
        out, col = meta[row, 0], self.tile_cols[slot].long()
        # every (output block, tile column) pair is stored once
        blocks[out, col] = sr.add(blocks[out, col], self.tiles[slot])
        return dense


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


def _tile_payload(ent: _TileEntries, slot: np.ndarray, shape: tuple, sr: Semiring,
                  device) -> Tensor:
    """A ⊕-identity payload of ``shape`` (slots × bm × bn, flattened over
    the leading dims) holding stored tile k in flat slot ``slot[k]``. Only
    the stored elements cross to the device; offsets are int64."""
    bm, bn = shape[-2:]
    tiles = torch.full(shape, _background(sr), dtype=sr.dtype, device=device)
    flat = slot[ent.tile] * (bm * bn) + ent.offset
    tiles.view(-1)[torch.from_numpy(flat).to(device)] = torch.from_numpy(ent.value).to(device)
    return tiles


def build_bsr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              shape: Tuple[int, int], sr: Semiring,
              block: Tuple[int, int] = (128, 128),
              t_max: int | None = None, device=None) -> BSRMatrix:
    """CSR-of-tiles builder: the stored tiles in (block row, tile column)
    order, padded to ``t_max`` tiles."""
    device = resolve_device(device)
    bm, bn = block
    m, n = shape
    mb, nb = -(-m // bm), -(-n // bn)
    ent = _densify_tiles(rows, cols, vals, shape, sr, block)
    n_tiles = ent.keys.shape[0]
    t_max = t_max or max(1, n_tiles)
    if t_max < n_tiles:
        raise ValueError(f"t_max={t_max} < {n_tiles} stored tiles")
    tile_cols_np = np.zeros(t_max, dtype=np.int32)
    tile_cols_np[:n_tiles] = ent.keys % nb
    counts = np.bincount(ent.keys // nb, minlength=mb)
    tile_row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BSRMatrix(
        tiles=_tile_payload(ent, np.arange(n_tiles), (t_max, bm, bn), sr, device),
        tile_cols=torch.from_numpy(tile_cols_np).to(device),
        tile_row_ptr=torch.from_numpy(tile_row_ptr).to(device),
        shape=(mb * bm, nb * bn),
        block=block,
    )


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
    return PaddedBSR(
        tiles=_tile_payload(ent, trow * slots + slot, (mb, slots, bm, bn), sr, device),
        tile_cols=torch.from_numpy(tile_cols_np).to(device),
        shape=(mb * bm, nb * bn),
        block=block,
    )


def _sell_layout(counts: np.ndarray, c: int, sigma: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Compute order, first slot of every row in compute order, and
    slot_total for per-block-row tile ``counts``. Rows are sorted by
    descending count, stably, inside each σ-window; each slice of ``c``
    rows is as wide as its widest row, and at least 1 wide."""
    mb = counts.shape[0]
    perm = np.concatenate([np.argsort(-counts[w0:w0 + sigma], kind="stable") + w0
                           for w0 in range(0, mb, sigma)] or [np.zeros(0, np.int64)])
    n_slices = -(-mb // c)
    sorted_counts = np.zeros(n_slices * c, dtype=np.int64)
    sorted_counts[:mb] = counts[perm]
    width = np.maximum(1, sorted_counts.reshape(n_slices, c).max(axis=1, initial=0))
    height = np.minimum(c, mb - np.arange(n_slices) * c)
    slice_base = np.concatenate([[0], np.cumsum(height * width)]).astype(np.int64)
    i = np.arange(mb)
    bases = slice_base[i // c] + (i % c) * width[i // c]
    return perm.astype(np.int64), bases, int(slice_base[-1])


def build_sell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               shape: Tuple[int, int], sr: Semiring,
               block: Tuple[int, int] = (128, 128),
               c: int = 8, sigma: int | None = None, device=None) -> SlicedELL:
    """sell-C-σ builder on the shared densification pass: sort block rows
    by descending tile count within σ-row windows (``sigma=None`` sorts
    globally), group them into slices of ``c`` rows, pad each slice to its
    own widest row. A row's tiles are in increasing tile-column order, as
    in PaddedBSR, so the sell kernel folds each row in the ELL kernel's
    order. Only the stored elements pass through the host; the payload is
    written once, on the device."""
    device = resolve_device(device)
    bm, bn = block
    m, n = shape
    mb, nb = -(-m // bm), -(-n // bn)
    sigma = sigma or mb
    if sigma < c:
        raise ValueError(f"sigma={sigma} must be >= slice height c={c}")
    ent = _densify_tiles(rows, cols, vals, shape, sr, block)
    trow = ent.keys // nb
    counts = np.bincount(trow, minlength=mb).astype(np.int64)
    perm, bases, slot_total = _sell_layout(counts, c, sigma)
    slot_total = max(1, slot_total)
    # slot of every stored tile: its row's base plus its rank in the row
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    compute_row = np.empty(mb, dtype=np.int64)
    compute_row[perm] = np.arange(mb)
    slot = bases[compute_row[trow]] + np.arange(trow.shape[0], dtype=np.int64) - row_start[trow]
    tile_cols_np = np.zeros(slot_total, dtype=np.int32)
    tile_cols_np[slot] = ent.keys % nb
    row_meta = np.stack([perm, bases, counts[perm]], axis=1).astype(np.int32)
    return SlicedELL(
        tiles=_tile_payload(ent, slot, (slot_total, bm, bn), sr, device),
        tile_cols=torch.from_numpy(tile_cols_np).to(device),
        row_meta=torch.from_numpy(row_meta).to(device),
        shape=(mb * bm, nb * bn),
        block=block,
        slice_height=c,
        sigma=sigma,
    )


def sell_stream_cost(counts: np.ndarray, block: Tuple[int, int],
                     c: int, sigma: int, elem_bytes: int = 4) -> dict:
    """Bytes model of one sell-C-σ candidate from per-block-row tile counts
    alone (no tiles made). The fused kernel streams the real slots and one
    x block per real slot; pad slots cost storage only and enter at 1/8
    weight."""
    bm, bn = block
    mb = counts.shape[0]
    _, _, slot_total = _sell_layout(np.asarray(counts, dtype=np.int64), c, sigma or mb)
    real = int(counts.sum())
    tile_bytes = bm * bn * elem_bytes
    streamed = real * (tile_bytes + bn * elem_bytes) + mb * bm * elem_bytes
    stored = slot_total * tile_bytes
    return {
        "slot_total": int(slot_total),
        "real_slots": real,
        "streamed_bytes": int(streamed),
        "stored_bytes": int(stored),
        "cost": int(streamed + stored // 8),
    }


def autotune_sell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                  shape: Tuple[int, int], sr: Semiring,
                  blocks: tuple = ((8, 8), (16, 16), (32, 32)),
                  cs: tuple = (4, 8), sigmas: tuple = (None, 32),
                  elem_bytes: int = 4, device=None):
    """Sweep (block, C, σ) candidates, score each with
    :func:`sell_stream_cost`, build only the winner. Returns
    ``(SlicedELL, report)``, the report being the scored candidates, best
    first."""
    m, n = shape
    report = []
    for block in blocks:
        mb, nb = -(-m // block[0]), -(-n // block[1])
        keys = np.unique((rows // block[0]).astype(np.int64) * nb + cols // block[1])
        counts = np.bincount((keys // nb).astype(np.int64), minlength=mb)
        for c in cs:
            for sigma in sigmas:
                sig = sigma or mb
                if sig < c:
                    continue
                report.append({"block": block, "c": c, "sigma": sig,
                               **sell_stream_cost(counts, block, c, sig, elem_bytes)})
    report.sort(key=lambda r: (r["cost"], r["block"], r["c"], r["sigma"]))
    best = report[0]
    sell = build_sell(rows, cols, vals, shape, sr, block=best["block"], c=best["c"],
                      sigma=best["sigma"], device=device)
    return sell, report


def coo_from_dense(dense: np.ndarray, sr: Semiring):
    """Test helper: the structural nonzeros (≠ the semiring zero) of a
    dense numpy matrix as (rows, cols, vals)."""
    rows, cols = np.nonzero(dense != _background(sr))
    return rows.astype(np.int32), cols.astype(np.int32), dense[rows, cols]
