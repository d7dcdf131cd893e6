"""Wrappers of the CUDA tile SpMV kernels, the ports of the TPU kernels in
``repro.kernels.semiring_spmv``:

* ``semiring_spmv_padded`` (``csrc/semiring_spmv.cu``): y = A ⊕.⊗ x over
  the ELL-of-tiles layout; every one of a block row's T slots, pads
  included, is ⊕-folded in slot order.
* ``semiring_spmv_fused_padded`` (``csrc/semiring_spmv_fused.cu``): the
  same layout, only the first n_real slots of each row.
* ``semiring_spmv_sell`` (``csrc/semiring_spmv_sell.cu``): the sell-C-σ
  layout, each row's real tiles only, written to its permuted output block.
* ``semiring_spmv_padded_batch`` (``csrc/semiring_spmv.cu``): kernel 1 over
  a block of B vectors, [B, nb·bn] -> [B, mb·bm], what the JAX package runs
  as ``jax.vmap`` of ``semiring_spmv_padded``; row b equals kernel 1 on
  x[b] bit for bit.

On a CUDA tensor a wrapper launches its kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``.
Each wrapper's ``.launches`` counts its kernel launches. With ``chunks=d``
the fused wrappers return the output chunk-major, [d, m/d]: the flat
output's memory order, viewed.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import _build, ref

Tensor = torch.Tensor


def _check_payload(name: str, tiles: Tensor, indices: tuple[Tensor, ...], x: Tensor) -> None:
    bn = tiles.shape[-1]
    if x.dim() != 1 or x.shape[0] % bn:
        raise ValueError(f"{name}: x must be 1-D with a multiple of bn={bn} entries, "
                         f"got {tuple(x.shape)}")
    tensors = (tiles, *indices, x)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: operands on {', '.join(str(t.device) for t in tensors)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if max(tiles.shape) >= 2**31 or max(i.numel() for i in indices) >= 2**31:
        raise ValueError(f"{name}: shapes exceed the kernel's int32 arguments")


def _check_dtypes(name: str, tiles: Tensor, x: Tensor, sr: Semiring) -> None:
    if tiles.dtype != sr.dtype or x.dtype != sr.dtype:
        raise TypeError(f"{name}: tiles and x must be {sr.dtype} for {sr.name}, "
                        f"got {tiles.dtype} and {x.dtype}")


def _check_index(name: str, label: str, index: Tensor, shape: tuple[int, ...]) -> None:
    if index.dtype != torch.int32 or tuple(index.shape) != shape:
        raise ValueError(f"{name}: {label} must be int32 {list(shape)}, "
                         f"got {index.dtype} {tuple(index.shape)}")


def check_tile_operands(name: str, tiles: Tensor, index: Tensor, index_cols: int,
                        x: Tensor, sr: Semiring) -> None:
    """Raise unless the operands are what an ELL-of-tiles kernel takes: one
    device, contiguous, ``sr.dtype`` payloads [mb, T, bm, bn], an int32
    index of ``index_cols`` columns per block row, and x a whole number of
    column blocks."""
    if tiles.dim() != 4:
        raise ValueError(f"{name}: tiles must be [mb, T, bm, bn], got {tuple(tiles.shape)}")
    _check_dtypes(name, tiles, x, sr)
    _check_index(name, "index", index, (tiles.shape[0], index_cols))
    _check_payload(name, tiles, (index,), x)


def check_chunks(name: str, mb: int, chunks: int | None) -> None:
    if chunks is not None and (chunks < 1 or mb % chunks):
        raise ValueError(f"{name}: chunks={chunks} must divide the {mb} block rows")


def chunk_major(y: Tensor, chunks: int | None) -> Tensor:
    """The flat output [mb·bm] as [chunks, mb·bm/chunks] (same memory)."""
    return y if chunks is None else y.view(chunks, -1)


def check_block_operands(name: str, tiles: Tensor, index: Tensor, index_shape: tuple[int, ...],
                         xs: Tensor, sr: Semiring) -> None:
    """``check_tile_operands`` for a block of vectors: xs [B, nb·bn] and an
    int32 index of ``index_shape``."""
    if tiles.dim() != 4:
        raise ValueError(f"{name}: tiles must be [mb, T, bm, bn], got {tuple(tiles.shape)}")
    if xs.dim() != 2:
        raise ValueError(f"{name}: xs must be [B, n], got {tuple(xs.shape)}")
    _check_dtypes(name, tiles, xs, sr)
    _check_index(name, "index", index, index_shape)
    _check_payload(name, tiles, (index,), xs[0] if xs.shape[0] else xs.new_empty(0))
    if xs.device != tiles.device or not xs.is_contiguous():
        raise ValueError(f"{name}: xs must be contiguous and on {tiles.device}")
    if xs.shape[0] >= 2**31:
        raise ValueError(f"{name}: a block of {xs.shape[0]} vectors exceeds int32")


def launch_block_kernel(source: str, symbol: str, tiles: Tensor, index: Tensor, xs: Tensor,
                        sr: Semiring) -> Tensor:
    """Allocate ys [B, mb·bm] and launch a tile fold over the block xs on
    the tensors' current stream."""
    if tiles.device.type != "cuda":
        raise ValueError(f"{symbol}: no kernel for device {tiles.device}")
    mb, t, bm, bn = tiles.shape
    b, x_len = xs.shape
    ys = torch.empty((b, mb * bm), dtype=sr.dtype, device=tiles.device)
    fn = _build.tile_batch_kernel(source, symbol)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tiles.data_ptr(), index.data_ptr(), xs.data_ptr(), ys.data_ptr(), mb, t, bm,
                 bn, x_len, b, sr.code, stream)
    if err:
        raise RuntimeError(f"{symbol}: kernel launch failed with cudaError_t {err}")
    return ys


def launch_tile_kernel(source: str, symbol: str, tiles: Tensor, indices: tuple[Tensor, ...],
                       x: Tensor, sr: Semiring, mb: int, t: int) -> Tensor:
    """Allocate y [mb·bm] and launch a tile kernel on the tensors' current
    stream; ``t`` is the kernel's slot argument (T, or slot_total)."""
    if tiles.device.type != "cuda":
        raise ValueError(f"{symbol}: no kernel for device {tiles.device}")
    bm, bn = tiles.shape[-2:]
    y = torch.empty(mb * bm, dtype=sr.dtype, device=tiles.device)
    fn = _build.tile_kernel(source, symbol, len(indices))
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tiles.data_ptr(), *(i.data_ptr() for i in indices), x.data_ptr(),
                 y.data_ptr(), mb, t, bm, bn, sr.code, stream)
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
    y = launch_tile_kernel("semiring_spmv.cu", "semiring_spmv_padded", tiles, (tile_cols,), x,
                           sr, *tiles.shape[:2])
    semiring_spmv_padded.launches += 1
    return y


semiring_spmv_padded.launches = 0


def semiring_spmv_fused_padded(tiles: Tensor, meta: Tensor, x: Tensor, *, sr: Semiring,
                               chunks: int | None = None) -> Tensor:
    """y = A ⊕.⊗ x over the first n_real slots of each block row only.
    tiles [mb, T, bm, bn]; meta int32 [mb, 1+T] = (n_real | tile_cols), as
    ``ops._spmv_fused_meta`` builds it; y [mb·bm], or [chunks, mb·bm/chunks]."""
    name = "semiring_spmv_fused_padded"
    check_tile_operands(name, tiles, meta, 1 + tiles.shape[1], x, sr)
    check_chunks(name, tiles.shape[0], chunks)
    if tiles.device.type == "cpu":
        return chunk_major(ref.spmv_fused_padded_ref(tiles, meta, x, sr), chunks)
    y = launch_tile_kernel("semiring_spmv_fused.cu", name, tiles, (meta,), x, sr,
                           *tiles.shape[:2])
    semiring_spmv_fused_padded.launches += 1
    return chunk_major(y, chunks)


semiring_spmv_fused_padded.launches = 0


def semiring_spmv_sell(tiles: Tensor, tile_cols: Tensor, row_meta: Tensor, x: Tensor, *,
                       sr: Semiring, chunks: int | None = None) -> Tensor:
    """y = A ⊕.⊗ x over the sell-C-σ layout: tiles [slot_total, bm, bn];
    tile_cols int32 [slot_total]; row_meta int32 [mb, 3] = (out_block,
    base, n_real) in compute order, as ``core.formats.build_sell`` builds
    it. y comes back in the original row order: [mb·bm], or chunk-major."""
    name = "semiring_spmv_sell"
    if tiles.dim() != 3:
        raise ValueError(f"{name}: tiles must be [slot_total, bm, bn], got {tuple(tiles.shape)}")
    _check_dtypes(name, tiles, x, sr)
    _check_index(name, "tile_cols", tile_cols, (tiles.shape[0],))
    _check_index(name, "row_meta", row_meta, (row_meta.shape[0], 3))
    _check_payload(name, tiles, (tile_cols, row_meta), x)
    mb = row_meta.shape[0]
    check_chunks(name, mb, chunks)
    if tiles.device.type == "cpu":
        return chunk_major(ref.spmv_sell_ref(tiles, tile_cols, row_meta, x, sr), chunks)
    y = launch_tile_kernel("semiring_spmv_sell.cu", name, tiles, (tile_cols, row_meta), x, sr,
                           mb, tiles.shape[0])
    semiring_spmv_sell.launches += 1
    return chunk_major(y, chunks)


semiring_spmv_sell.launches = 0


def semiring_spmv_padded_batch(tiles: Tensor, tile_cols: Tensor, xs: Tensor, *,
                               sr: Semiring) -> Tensor:
    """ys [B, mb·bm]: row b = ``semiring_spmv_padded(tiles, tile_cols,
    xs[b])``. xs [B, nb·bn] of dtype ``sr.dtype``, on the tiles' device;
    on the card each group of 32 vectors shares every tile load."""
    name = "semiring_spmv_padded_batch"
    check_block_operands(name, tiles, tile_cols, tuple(tiles.shape[:2]), xs, sr)
    if tiles.device.type == "cpu":
        return ref.spmv_padded_batch_ref(tiles, tile_cols, xs, sr)
    ys = launch_block_kernel("semiring_spmv.cu", name, tiles, tile_cols, xs, sr)
    semiring_spmv_padded_batch.launches += 1
    return ys


semiring_spmv_padded_batch.launches = 0
