"""Carry matrices across from the JAX package.

Each ``*_from_numpy`` takes the arrays of a ``repro.core.formats``
container, passed as ``np.asarray``, and returns the port's container on
``device`` (the CUDA card unless named), so both packages can run on
literally the same matrix. ``to_numpy`` goes the other way, field by field.
Nothing here imports the JAX package: the caller hands over plain arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.formats import (
    BSRMatrix, COOMatrix, CSCMatrix, CSRMatrix, PaddedBSR, SlicedELL,
)


def _t(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def padded_bsr_from_numpy(tiles: np.ndarray, tile_cols: np.ndarray,
                          shape: Tuple[int, int], block: Tuple[int, int],
                          device=None) -> PaddedBSR:
    device = resolve_device(device)
    return PaddedBSR(_t(tiles, device), _t(np.asarray(tile_cols, np.int32), device),
                     tuple(shape), tuple(block))


def sliced_ell_from_numpy(tiles: np.ndarray, tile_cols: np.ndarray, row_meta: np.ndarray,
                          shape: Tuple[int, int], block: Tuple[int, int], slice_height: int,
                          sigma: int, device=None) -> SlicedELL:
    device = resolve_device(device)
    return SlicedELL(_t(tiles, device), _t(np.asarray(tile_cols, np.int32), device),
                     _t(np.asarray(row_meta, np.int32), device), tuple(shape), tuple(block),
                     int(slice_height), int(sigma))


def bsr_from_numpy(tiles: np.ndarray, tile_cols: np.ndarray, tile_row_ptr: np.ndarray,
                   shape: Tuple[int, int], block: Tuple[int, int], device=None) -> BSRMatrix:
    device = resolve_device(device)
    return BSRMatrix(_t(tiles, device), _t(np.asarray(tile_cols, np.int32), device),
                     _t(np.asarray(tile_row_ptr, np.int32), device), tuple(shape), tuple(block))


def coo_from_numpy(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, nnz,
                   shape: Tuple[int, int], device=None) -> COOMatrix:
    device = resolve_device(device)
    return COOMatrix(_t(rows, device), _t(cols, device), _t(vals, device),
                     int(nnz), tuple(shape))


def csr_from_numpy(row_ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   seg_ids: np.ndarray, nnz, shape: Tuple[int, int],
                   device=None) -> CSRMatrix:
    device = resolve_device(device)
    return CSRMatrix(_t(row_ptr, device), _t(cols, device), _t(vals, device),
                     _t(seg_ids, device), int(nnz), tuple(shape))


def csc_from_numpy(col_ptr: np.ndarray, rows: np.ndarray, vals: np.ndarray, nnz,
                   shape: Tuple[int, int], max_col_nnz: int,
                   device=None) -> CSCMatrix:
    device = resolve_device(device)
    return CSCMatrix(_t(col_ptr, device), _t(rows, device), _t(vals, device),
                     int(nnz), tuple(shape), int(max_col_nnz))


def to_numpy(m) -> dict:
    """Every field of a port container, tensors as numpy arrays."""
    return {f.name: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(m) for v in [getattr(m, f.name)]}
