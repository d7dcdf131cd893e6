"""Wrapper of the CUDA masked tile SpGEMM (``csrc/spgemm_tiles.cu``), the
port of the TPU kernel ``repro.kernels.spgemm_tiles.semiring_spgemm_padded``:

    C = (A ⊕.⊗ B) ⊙ mask

with A in the ELL-of-tiles layout, B and the mask dense. Layout, as the
TPU kernel's:

    tiles [mb, T, bm, bk]   A's tiles; pad slots hold the ⊕-identity tile
                            and point at tile-column 0
    meta  [mb, T + nb] i32  meta[i, :T] = tile-columns,
                            meta[i, T+j] = 1 iff mask tile (i, j) is non-empty
    b     [kb·bk, nb·bn]    dense right operand
    mask  [mb·bm, nb·bn]    structural mask (≠ ⊕-identity ⇒ keep)
    out   [mb·bm, nb·bn]

The kernel folds each block row's real slots (``ref.ell_n_real``) and then,
for its pad slots, the pad row P[c] = ⊕_{k<bk} (zero ⊗ b[k, c]) that every
pad slot adds to output column c (``ref.pad_row``): the TPU kernel's function
exactly, pads included. ``ref.spgemm_pad_row_ref`` is this decomposition in
plain PyTorch. Each CUDA block takes up to ``group_size(bm)`` active output
tiles of one block row, which it finds from the mask-tile flags itself; it
also counts the row's real slots and computes P. So the wrapper prepares
nothing and never waits on the card: one fill of the output, one launch.
Every semiring folds on the CUDA cores, ⟨+,×⟩ in fp32.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``.
``.launches`` counts its kernel launches; ``.paths`` counts the (output
tile, slot) pairs the kernel reported folding as real slots (``real``)
and as the pad row (``pad``). Its values are 0-d int64 tensors on the
card once a launch has added to them (no host sync per call): read them
with ``int()``.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import _build, ref
from repro_torch.kernels.semiring_spmv import _check_index

Tensor = torch.Tensor

# The CUDA kernel keeps a group's output tiles in registers.
MAX_BLOCK = 128
# what the kernel reports, in the order of its counts
PATHS = ("real", "pad")


def _check_operands(name: str, tiles: Tensor, meta: Tensor, b: Tensor, mask: Tensor,
                    sr: Semiring, bn: int) -> None:
    """Raise unless the operands are what the masked tile SpGEMM takes: one
    device, contiguous, ``sr.dtype`` tiles [mb, T, bm, bk] with square
    output tiles bn = bm ≤ 128 and bk ≤ 128, b [kb·bk, nb·bn], mask
    [mb·bm, nb·bn] and an int32 meta [mb, T + nb]."""
    if tiles.dim() != 4:
        raise ValueError(f"{name}: tiles must be [mb, T, bm, bk], got {tuple(tiles.shape)}")
    mb, t, bm, bk = tiles.shape
    if bn != bm or not (1 <= bm <= MAX_BLOCK and 1 <= bk <= MAX_BLOCK):
        raise ValueError(f"{name}: the kernel takes bn = bm ≤ {MAX_BLOCK} and bk ≤ {MAX_BLOCK}, "
                         f"got bm={bm}, bk={bk}, bn={bn}")
    if b.dim() != 2 or b.shape[0] % bk or b.shape[1] % bn:
        raise ValueError(f"{name}: b must be [kb·{bk}, nb·{bn}], got {tuple(b.shape)}")
    if tuple(mask.shape) != (mb * bm, b.shape[1]):
        raise ValueError(f"{name}: mask must be {[mb * bm, b.shape[1]]}, got {tuple(mask.shape)}")
    if tiles.dtype != sr.dtype or b.dtype != sr.dtype or mask.dtype != sr.dtype:
        raise TypeError(f"{name}: tiles, b and mask must be {sr.dtype} for {sr.name}, "
                        f"got {tiles.dtype}, {b.dtype} and {mask.dtype}")
    _check_index(name, "meta", meta, (mb, t + b.shape[1] // bn))
    tensors = (tiles, meta, b, mask)
    if len({x.device for x in tensors}) != 1:
        raise ValueError(f"{name}: operands on {', '.join(str(x.device) for x in tensors)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    if max(mb * t, meta.numel(), mb * b.shape[1] // bn) >= 2**31:
        raise ValueError(f"{name}: shapes exceed the kernel's int32 arguments")


def group_size(bm: int) -> int:
    """Output tiles of one block row that one CUDA block computes together,
    sharing each A tile it stages (``spgemm_tiles_group_size`` in the
    source, which refuses a launch that disagrees): 256 output columns up
    to 64 rows (16, 8, 4 tiles up to 16, 32, 64 rows), 1 tile above."""
    return 16 if bm <= 16 else 8 if bm <= 32 else 4 if bm <= 64 else 1


def semiring_spgemm_padded(tiles: Tensor, meta: Tensor, b: Tensor, mask: Tensor, *,
                           sr: Semiring, bn: int) -> Tensor:
    """C [mb·bm, nb·bn] = (A ⊕.⊗ B) ⊙ mask over the padded ELL-of-tiles
    layout. ``bn`` is the output tile width; b's and the mask's column
    counts are multiples of it."""
    name = "semiring_spgemm_padded"
    _check_operands(name, tiles, meta, b, mask, sr, bn)
    if tiles.device.type == "cpu":
        return ref.spgemm_padded_ref(tiles, meta, b, mask, sr, bn)
    if tiles.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tiles.device}")
    mb, t, bm, bk = tiles.shape
    out = torch.full((mb * bm, b.shape[1]), sr.zero, dtype=sr.dtype, device=tiles.device)
    _launch(tiles, meta, b, mask, out, sr)
    return out


def _launch(tiles: Tensor, meta: Tensor, b: Tensor, mask: Tensor, out: Tensor,
            sr: Semiring) -> None:
    """One launch of the kernel on the current stream into ``out`` (filled
    with the ⊕-identity); adds one to ``semiring_spgemm_padded.launches``
    and the kernel's counts to its ``.paths``; raises if the launch is
    refused."""
    mb, t, bm, bk = tiles.shape
    counts = torch.zeros(len(PATHS), dtype=torch.int64, device=tiles.device)
    fn = _build.spgemm_kernel(sr.code)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tiles.data_ptr(), meta.data_ptr(), b.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), counts.data_ptr(), t, mb, b.shape[1] // bm, bm, bk,
                 group_size(bm), sr.code, stream)
    if err:
        raise RuntimeError(f"semiring_spgemm_padded: kernel launch failed with cudaError_t {err}")
    semiring_spgemm_padded.launches += 1
    paths = semiring_spgemm_padded.paths
    for k, v in zip(PATHS, counts):
        paths[k] = paths[k] + v


semiring_spgemm_padded.launches = 0
semiring_spgemm_padded.paths = dict.fromkeys(PATHS, 0)
