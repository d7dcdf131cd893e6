"""Wrapper of the tensor-core masked tile SpGEMM for 0/1 operands
(``csrc/spgemm_binary.cu``), the variant of kernel 6
(``kernels/spgemm_tiles.py``) that the front door takes for ⟨+,∧⟩ and
⟨∨,∧⟩ when every value of A's tiles and of B is 0 or 1 and bm and bk are
multiples of 16:

    C = (A · B) ⊙ mask          ⟨+,∧⟩
    C = (A · B > 0) ⊙ mask      ⟨∨,∧⟩

It takes kernel 6's operands (tiles [mb, T, bm, bk], meta [mb, T + nb]
= tile-columns | mask-tile flags, b [kb·bk, nb·bn], mask [mb·bm, nb·bn])
and gives kernel 6's result on them, folding only each block row's real
slots. The wrapper packs A and B to int8 once per call (B transposed to
[N, K]), groups the active output tiles of each block row by
``group_size(bm)`` and orders the groups by tile-column
(``group_tiles``, on the card with no host sync). It does not look
at the values: that they are 0 or 1 is the caller's promise, which the
front door checks.

On a CUDA tensor the wrapper launches the kernel on the current stream or
raises; on a CPU tensor it runs the plain version from ``kernels/ref.py``.
``.launches`` counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import _build, ref
from repro_torch.kernels.spgemm_tiles import MAX_BLOCK, _check_operands

Tensor = torch.Tensor

# the semirings whose ⊗ is ∧: min on {0, 1} is the product
SEMIRINGS = ("plus_and", "bool_or_and")
# bm and bk are multiples of this: the mma's m and the 16-byte copies
ALIGN = 16


def group_size(bm: int) -> int:
    """Output tiles of one block row that one CUDA block computes together,
    sharing each A tile it loads (``spgemm_binary_group_size`` in the
    source): 8 up to 32 rows, 4 up to 64, 1 up to 128."""
    return 8 if bm <= 32 else 4 if bm <= 64 else 1


def takes(sr: Semiring, bm: int, bk: int) -> bool:
    """Whether the variant takes this semiring and block shape (the values
    are the front door's test)."""
    return (sr.name in SEMIRINGS and bm % ALIGN == 0 and bk % ALIGN == 0
            and bm <= MAX_BLOCK and bk <= MAX_BLOCK)


def pack(tiles: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """int8 copies of A's tiles as they are ([mb, T, bm, bk], k already
    contiguous) and of B transposed to [N, K]: 8-bit mma operands are
    K-major only. On the card B goes through the source's pack kernel (a
    tiled transpose), on the host through ``ref.pack_binary_ref``."""
    if b.device.type == "cpu":
        return ref.pack_binary_ref(tiles, b)
    if b.data_ptr() % 16:
        raise ValueError("semiring_spgemm_binary: b must be 16-byte aligned")
    bt8 = torch.empty((b.shape[1], b.shape[0]), dtype=torch.int8, device=b.device)
    with torch.cuda.device(b.device):
        err = _build.spgemm_binary_pack()(b.data_ptr(), bt8.data_ptr(), b.shape[0], b.shape[1],
                                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"semiring_spgemm_binary: pack launch failed with cudaError_t {err}")
    return tiles.to(torch.int8), bt8


def group_tiles(meta: Tensor, t: int, g: int) -> tuple[Tensor, Tensor]:
    """The active output tiles and their groups, built on the device with
    no host sync. Block row i has Q = ceil(nb / g) groups; group (i, q)
    holds its row's active tiles of ranks q·g to q·g + g − 1.
    ``active`` int32 [mb·Q·g, 2]: entry (i·Q + q)·g + r is (i, j) of the
    r-th tile of group (i, q), j = −1 past the row's active tiles.
    ``groups`` int32 [mb·Q, 2] = (first, count): active[first : first +
    count] are the group's tiles. Groups with a tile go first, ordered by
    the tile-column of their first tile (then block row), so that groups
    running together read the same column strips of B; the empty ones
    (count 0, whose CUDA block returns at once) go last."""
    mb = meta.shape[0]
    flags = meta[:, t:] > 0                                        # [mb, nb]
    nb = flags.shape[1]
    q = -(-nb // g)
    dev = meta.device
    rank = torch.cumsum(flags, dim=1) - 1
    slot = torch.where(flags, rank, q * g)                         # q·g: a spare column
    cols = torch.full((mb, q * g + 1), -1, dtype=torch.int32, device=dev)
    cols.scatter_(1, slot, torch.arange(nb, dtype=torch.int32, device=dev).expand(mb, nb)
                  .contiguous())
    cols = cols[:, :q * g]
    count = (flags.sum(dim=1, keepdim=True) - g * torch.arange(q, device=dev)).clamp(0, g)
    rows = torch.arange(mb, device=dev)[:, None]
    key = torch.where(count > 0, cols[:, ::g].long() * mb + rows, mb * nb)
    order = torch.argsort(key.flatten(), stable=True)
    active = torch.stack([rows.expand(mb, q * g).to(torch.int32), cols], dim=2).view(-1, 2)
    groups = torch.stack([order * g, count.flatten()[order]], dim=1)
    return active.contiguous(), groups.to(torch.int32).contiguous()


def semiring_spgemm_binary(tiles: Tensor, meta: Tensor, b: Tensor, mask: Tensor, *,
                           sr: Semiring, bn: int) -> Tensor:
    """C [mb·bm, nb·bn] = (A ⊕.⊗ B) ⊙ mask for 0/1 operands under ⟨+,∧⟩ or
    ⟨∨,∧⟩, over each block row's real slots. ``bn`` is the output tile
    width (= bm)."""
    name = "semiring_spgemm_binary"
    _check_operands(name, tiles, meta, b, mask, sr, bn)
    mb, t, bm, bk = tiles.shape
    if not takes(sr, bm, bk):
        raise ValueError(f"{name}: takes {' and '.join(SEMIRINGS)} with bm and bk multiples of "
                         f"{ALIGN}, got {sr.name}, bm={bm}, bk={bk}")
    if tiles.device.type == "cpu":
        return ref.spgemm_binary_ref(tiles, meta, b, mask, sr, bn)
    if tiles.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tiles.device}")
    if mask.data_ptr() % 8:
        raise ValueError(f"{name}: the mask must be 8-byte aligned")
    out = torch.zeros((mb * bm, b.shape[1]), dtype=sr.dtype, device=tiles.device)
    active, groups = group_tiles(meta, t, group_size(bm))
    a8, bt8 = pack(tiles, b)
    _launch(a8, bt8, ref.ell_n_real(meta[:, :t]), active, groups, meta, mask, out, sr)
    return out


def _launch(a8: Tensor, bt8: Tensor, n_real: Tensor, active: Tensor, groups: Tensor,
            meta: Tensor, mask: Tensor, out: Tensor, sr: Semiring) -> None:
    """One launch of the kernel on packed operands (``pack``,
    ``group_tiles``) on the current stream; adds one to
    ``semiring_spgemm_binary.launches``; raises if it is refused."""
    mb, t, bm, bk = a8.shape
    fn = _build.spgemm_binary_kernel()
    with torch.cuda.device(a8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a8.data_ptr(), meta.data_ptr(), n_real.data_ptr(), bt8.data_ptr(),
                 mask.data_ptr(), active.data_ptr(), groups.data_ptr(), out.data_ptr(),
                 groups.shape[0], t, bt8.shape[0] // bm, bt8.shape[1] // bk, bm, bk,
                 group_size(bm), int(sr.name == "bool_or_and"), stream)
    if err:
        raise RuntimeError(f"semiring_spgemm_binary: kernel launch failed with cudaError_t {err}")
    semiring_spgemm_binary.launches += 1


semiring_spgemm_binary.launches = 0
