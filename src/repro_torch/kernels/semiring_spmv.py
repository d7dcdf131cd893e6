"""Wrapper of the CUDA tile SpMV kernel (``csrc/semiring_spmv.cu``), the
port of the TPU kernel ``repro.kernels.semiring_spmv.semiring_spmv_padded``.

y = A ⊕.⊗ x over the ELL-of-tiles layout: for each block row, every one of
the T slots (pads included) is ⊕-folded in slot order.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``.
``semiring_spmv_padded.launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import _build, ref

Tensor = torch.Tensor


def check_tile_operands(name: str, tiles: Tensor, index: Tensor, index_cols: int,
                        x: Tensor, sr: Semiring) -> None:
    """Raise unless the operands are what a tile kernel takes: one device,
    contiguous, ``sr.dtype`` payloads, an int32 index of ``index_cols``
    columns per block row, and x a whole number of column blocks."""
    if tiles.dim() != 4:
        raise ValueError(f"{name}: tiles must be [mb, T, bm, bn], got {tuple(tiles.shape)}")
    mb, _, _, bn = tiles.shape
    if tiles.dtype != sr.dtype or x.dtype != sr.dtype:
        raise TypeError(f"{name}: tiles and x must be {sr.dtype} for {sr.name}, "
                        f"got {tiles.dtype} and {x.dtype}")
    if index.dtype != torch.int32 or tuple(index.shape) != (mb, index_cols):
        raise ValueError(f"{name}: index must be int32 [{mb}, {index_cols}], "
                         f"got {index.dtype} {tuple(index.shape)}")
    if x.dim() != 1 or x.shape[0] % bn:
        raise ValueError(f"{name}: x must be 1-D with a multiple of bn={bn} entries, "
                         f"got {tuple(x.shape)}")
    if not (tiles.device == index.device == x.device):
        raise ValueError(f"{name}: operands on {tiles.device}, {index.device}, {x.device}")
    if not (tiles.is_contiguous() and index.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")
    if max(tiles.shape) >= 2**31 or index.numel() >= 2**31:
        raise ValueError(f"{name}: shapes exceed the kernel's int32 arguments")


def launch_tile_kernel(source: str, symbol: str, tiles: Tensor, index: Tensor,
                       x: Tensor, sr: Semiring) -> Tensor:
    """Allocate y and launch a tile kernel on the tensors' current stream."""
    if tiles.device.type != "cuda":
        raise ValueError(f"{symbol}: no kernel for device {tiles.device}")
    mb, t, bm, bn = tiles.shape
    y = torch.empty(mb * bm, dtype=sr.dtype, device=tiles.device)
    fn = _build.tile_kernel(source, symbol)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tiles.data_ptr(), index.data_ptr(), x.data_ptr(), y.data_ptr(),
                 mb, t, bm, bn, sr.code, stream)
    if err:
        raise RuntimeError(f"{symbol}: kernel launch failed with cudaError_t {err}")
    return y


def semiring_spmv_padded(tiles: Tensor, tile_cols: Tensor, x: Tensor, *,
                         sr: Semiring) -> Tensor:
    """y [mb·bm] = A ⊕.⊗ x. tiles [mb, T, bm, bn]; tile_cols int32 [mb, T];
    x [nb·bn], all of dtype ``sr.dtype`` and on one device."""
    check_tile_operands("semiring_spmv_padded", tiles, tile_cols, tiles.shape[1], x, sr)
    if tiles.device.type == "cpu":
        return ref.spmv_padded_ref(tiles, tile_cols, x, sr)
    y = launch_tile_kernel("semiring_spmv.cu", "semiring_spmv_padded", tiles, tile_cols, x, sr)
    semiring_spmv_padded.launches += 1
    return y


semiring_spmv_padded.launches = 0
