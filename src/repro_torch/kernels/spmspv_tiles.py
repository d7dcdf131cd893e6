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

``semiring_spmspv_padded_batch`` (``csrc/spmspv_tiles.cu``) is the unfused
kernel over a block of B vectors, each with its own meta [B, mb, 1+2T]:
what the JAX package runs as ``jax.vmap`` of ``semiring_spmspv_padded``.
On the card it launches over the metas' union per group of 32 vectors
(``ops._spmspv_union_batch``), built on the device with no host read.

On a CUDA tensor a wrapper launches its kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``.
Each wrapper's ``.launches`` counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import ref
from repro_torch.kernels.semiring_spmv import (
    check_block_operands, check_chunks, check_tile_operands, chunk_major, launch_block_kernel,
    launch_tile_kernel,
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


def semiring_spmspv_padded_batch(tiles: Tensor, meta: Tensor, xs: Tensor, *,
                                 sr: Semiring) -> Tensor:
    """ys [B, mb·bm]: row b = ``semiring_spmspv_padded(tiles, meta[b],
    xs[b])``. meta int32 [B, mb, 1+2T], one per vector (as
    ``ops._spmspv_meta_batch`` builds them); xs [B, nb·bn] densified."""
    name = "semiring_spmspv_padded_batch"
    mb, t = tiles.shape[:2]
    check_block_operands(name, tiles, meta, (xs.shape[0], mb, 1 + 2 * t), xs, sr)
    if tiles.device.type == "cpu":
        return ref.spmspv_padded_batch_ref(tiles, meta, xs, sr)
    from repro_torch.kernels.ops import _spmspv_union_batch     # ops imports this module

    ys = launch_block_kernel("spmspv_tiles.cu", name, tiles, _spmspv_union_batch(meta), xs, sr)
    semiring_spmspv_padded_batch.launches += 1
    return ys


semiring_spmspv_padded_batch.launches = 0
