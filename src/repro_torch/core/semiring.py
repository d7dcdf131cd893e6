"""Algebraic semirings for linear-algebraic graph processing (paper §2.1, Table 1).

PyTorch counterpart of ``repro.core.semiring``: the same five semirings,
with ``torch`` elementwise ops in place of ``jnp``. Each semiring also
carries a small integer ``code`` so one CUDA template
(``kernels/csrc/tile_fold.cuh``) serves all five.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Semiring:
    """⟨S, ⊕, ⊗, zero, one⟩ with torch elementwise ops.

    ``zero`` is the ⊕-identity (and ⊗-annihilator), ``one`` the ⊗-identity.
    ``collective`` names the ⊕-reduction family ("psum", "pmin", "pmax",
    "por"), as in the JAX package. ``code`` selects the semiring inside the
    CUDA kernels (see ``kernels/csrc/tile_fold.cuh``).
    """

    name: str
    add: Callable[[Tensor, Tensor], Tensor]
    mul: Callable[[Tensor, Tensor], Tensor]
    zero: Any
    one: Any
    dtype: torch.dtype
    collective: str
    code: int

    @property
    def mxu_eligible(self) -> bool:
        """True iff ⟨⊕,⊗⟩ is ordinary ⟨+,×⟩, so the tile product may be
        written as a dot. ``collective == "psum"`` is not sufficient:
        ⟨+,∧⟩ sums but its ⊗ is min."""
        return self.add is torch.add and self.mul is torch.mul

    def add_reduce(self, x: Tensor, dim: int | tuple[int, ...]) -> Tensor:
        if self.collective == "psum":
            # the JAX sum keeps the dtype; torch.sum would widen int32 to int64
            return torch.sum(x, dim=dim, dtype=x.dtype)
        if self.collective == "pmin":
            return torch.amin(x, dim=dim)
        if self.collective == "pmax":
            return torch.amax(x, dim=dim)
        if self.collective == "por":
            return torch.any(x, dim=dim) if x.dtype == torch.bool else torch.amax(x, dim=dim)
        raise ValueError(self.collective)

    def scatter_mode(self) -> str:
        """``scatter_reduce_`` mode of ⊕: sum, amin or amax."""
        return {"psum": "sum", "pmin": "amin"}.get(self.collective, "amax")

    def segment_reduce(self, data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
        """⊕-reduce ``data`` into ``num_segments`` buckets. The output is
        seeded with the ⊕-identity, so empty segments come back as ``zero``;
        ids ``>= num_segments`` are dropped (one spill bucket, sliced off)."""
        out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), self.zero,
                         dtype=data.dtype, device=data.device)
        ids = segment_ids.long().clamp(max=num_segments)
        if data.dim() > 1:
            ids = ids.view(-1, *([1] * (data.dim() - 1))).expand_as(data)
        out.scatter_reduce_(0, ids, data, reduce=self.scatter_mode(), include_self=True)
        return out[:num_segments]

    def matvec(self, a_dense: Tensor, x: Tensor) -> Tensor:
        """Dense reference y_i = ⊕_j a_ij ⊗ x_j (oracle for tests)."""
        return self.add_reduce(self.mul(a_dense, x[None, :]), dim=1)


# BFS: boolean ⟨∨,∧⟩ over {0,1}, stored as int32 0/1.
BOOL_OR_AND = Semiring(
    name="bool_or_and", add=torch.maximum, mul=torch.minimum,
    zero=0, one=1, dtype=torch.int32, collective="por", code=0)

# SSSP: tropical ⟨min,+⟩ over ℝ∪{∞}. zero=+inf, one=0.
MIN_PLUS = Semiring(
    name="min_plus", add=torch.minimum, mul=torch.add,
    zero=float("inf"), one=0.0, dtype=torch.float32, collective="pmin", code=1)

# PPR / PageRank: standard arithmetic ⟨+,×⟩.
PLUS_TIMES = Semiring(
    name="plus_times", add=torch.add, mul=torch.mul,
    zero=0.0, one=1.0, dtype=torch.float32, collective="psum", code=2)

# Connected components: ⟨min,×⟩ over ℝ₊∪{∞}; operands stay strictly positive.
MIN_TIMES = Semiring(
    name="min_times", add=torch.minimum, mul=torch.mul,
    zero=float("inf"), one=1.0, dtype=torch.float32, collective="pmin", code=3)

# Triangle counting: ⟨+,∧⟩ over {0,1}⊂ℤ; ∧ is min, ⊕ a plain sum.
PLUS_AND = Semiring(
    name="plus_and", add=torch.add, mul=torch.minimum,
    zero=0, one=1, dtype=torch.int32, collective="psum", code=4)

SEMIRINGS: dict[str, Semiring] = {
    s.name: s for s in (BOOL_OR_AND, MIN_PLUS, PLUS_TIMES, MIN_TIMES, PLUS_AND)
}


def get(name: str) -> Semiring:
    """The semiring called ``name``; KeyError for an unknown name."""
    return SEMIRINGS[name]
