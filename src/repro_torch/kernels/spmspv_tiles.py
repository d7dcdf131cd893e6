"""Wrapper of the CUDA tile SpMSpV kernel (``csrc/spmspv_tiles.cu``), the
port of the TPU kernel ``repro.kernels.spmspv_tiles.semiring_spmspv_padded``.

meta layout (int32 [mb, 1 + 2T], built by ``ops._spmspv_meta``):
    meta[i, 0]         = n_active_i
    meta[i, 1 : 1+T]   = slot permutation (active slots first)
    meta[i, 1+T : ]    = tile-column index per *permuted* slot
Only the first n_active_i permuted slots of block row i are ⊕-folded.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``.
``semiring_spmspv_padded.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.semiring_spmv import check_tile_operands, launch_tile_kernel

Tensor = torch.Tensor


def semiring_spmspv_padded(tiles: Tensor, meta: Tensor, x: Tensor, *,
                           sr: Semiring) -> Tensor:
    """y [mb·bm] over the active slots only. tiles [mb, T, bm, bn]
    (unpermuted); meta as above; x densified [nb·bn]."""
    check_tile_operands("semiring_spmspv_padded", tiles, meta, 1 + 2 * tiles.shape[1], x, sr)
    if tiles.device.type == "cpu":
        return ref.spmspv_padded_ref(tiles, meta, x, sr)
    y = launch_tile_kernel("spmspv_tiles.cu", "semiring_spmspv_padded", tiles, meta, x, sr)
    semiring_spmspv_padded.launches += 1
    return y


semiring_spmspv_padded.launches = 0
