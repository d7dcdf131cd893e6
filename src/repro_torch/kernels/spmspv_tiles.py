"""Wrappers of the CUDA tile SpMSpV kernels, the ports of the TPU kernels
``repro.kernels.spmspv_tiles.semiring_spmspv_padded`` (``csrc/spmspv_tiles.cu``)
and ``semiring_spmspv_fused_padded`` (``csrc/spmspv_fused.cu``). Both
compute the same function; on the TPU the fused one issues no copy for an
inactive slot, and on this card neither kernel loads one.

meta layout (int32 [mb, 1 + 2T], built by ``ops._spmspv_meta``):
    meta[i, 0]         = n_active_i
    meta[i, 1 : 1+T]   = slot permutation (active slots first)
    meta[i, 1+T : ]    = tile-column index per *permuted* slot
Only the first n_active_i permuted slots of block row i are ⊕-folded.

On a CUDA tensor a wrapper launches its kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``.
Each wrapper's ``.launches`` counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.semiring_spmv import (
    chunk_major, check_chunks, check_tile_operands, launch_tile_kernel,
)

Tensor = torch.Tensor


def semiring_spmspv_padded(tiles: Tensor, meta: Tensor, x: Tensor, *,
                           sr: Semiring) -> Tensor:
    """y [mb·bm] over the active slots only. tiles [mb, T, bm, bn]
    (unpermuted); meta as above; x densified [nb·bn]."""
    check_tile_operands("semiring_spmspv_padded", tiles, meta, 1 + 2 * tiles.shape[1], x, sr)
    if tiles.device.type == "cpu":
        return ref.spmspv_padded_ref(tiles, meta, x, sr)
    y = launch_tile_kernel("spmspv_tiles.cu", "semiring_spmspv_padded", tiles, (meta,), x, sr,
                           *tiles.shape[:2])
    semiring_spmspv_padded.launches += 1
    return y


semiring_spmspv_padded.launches = 0


def semiring_spmspv_fused_padded(tiles: Tensor, meta: Tensor, x: Tensor, *, sr: Semiring,
                                 chunks: int | None = None) -> Tensor:
    """The fused SpMSpV: ``semiring_spmspv_padded``'s function on its
    operands; y [mb·bm], or [chunks, mb·bm/chunks] chunk-major."""
    name = "semiring_spmspv_fused_padded"
    check_tile_operands(name, tiles, meta, 1 + 2 * tiles.shape[1], x, sr)
    check_chunks(name, tiles.shape[0], chunks)
    if tiles.device.type == "cpu":
        return chunk_major(ref.spmspv_padded_ref(tiles, meta, x, sr), chunks)
    y = launch_tile_kernel("spmspv_fused.cu", name, tiles, (meta,), x, sr, *tiles.shape[:2])
    semiring_spmspv_fused_padded.launches += 1
    return chunk_major(y, chunks)


semiring_spmspv_fused_padded.launches = 0
