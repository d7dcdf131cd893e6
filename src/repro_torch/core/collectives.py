"""Interconnect-aware Merge collectives (paper §7's hardware ask, in software).

PyTorch counterpart of ``repro.core.collectives``. The flat merge is the
paper's host-mediated pattern: one bulk exchange with no topology
structure. The direct-network alternatives are explicit neighbour-exchange
schedules, each landing the ⊕-reduced chunk *g* on device *g* as the flat
merge does, so they interchange:

    flat     — one ``all_to_all`` and a ⊕-fold of the d received chunks.
    ring     — d-1 ``ppermute`` steps, each shipping one M/d chunk to the
               next neighbour and folding the local contribution in.
    tree     — radix stages over the mesh axes' prime factors (recursive
               halving when d is a power of two), Σ(fᵢ-1) exchanges with
               shrinking blocks.
    staged2d — reduce-scatter along ``axis_r`` then ``axis_c``
               (``order="rc"``), or the transpose order (``"cr"``) plus one
               layout-fix ``ppermute``; for the 2d strategy, whose Merge
               spans ``axis_c`` only, the radix schedule over that axis.

The plans (:class:`MergeStage`, :class:`MergePlan`, :func:`plan_merge`)
are a copy of the JAX package's. The schedules run on the stacked
``[D, ...]`` tensors of ``core/mesh.py`` and use only its primitives
(``all_to_all``, ``ppermute``, ``axis_index``, ``take``), so a
process-group mesh can run them unchanged. Each device folds the same
operands in the same order as the JAX schedule: the ring's running chunk
``(i - 2 - s) mod d`` is a per-device index (``Mesh.take``), not a slice.
Where the reference leaves the order to XLA (``psum_scatter``, the
``add_reduce`` after ``all_to_all``), the flat merge folds the received
chunks with ``sr.add`` in sender position order, left to right:
``((c_0 ⊕ c_1) ⊕ c_2) ⊕ …``. Nothing here reduces with ``torch.sum`` or
``amin`` over the device axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.core.mesh import Mesh
from repro_torch.core.semiring import Semiring
from repro_torch.obs import trace

Tensor = torch.Tensor

#: The merge-collective families, flat (the baseline) first — cost-model
#: candidate sweeps preserve this order so exact ties resolve to flat.
MERGE_FAMILIES = ("flat", "ring", "tree", "staged2d")

#: Stage orders a staged2d merge can run in (see plan_merge).
STAGED_ORDERS = ("rc", "cr")


def prime_factors(n: int) -> Tuple[int, ...]:
    """Ascending prime factorization (2s first ⇒ the tree schedule is pure
    recursive halving on power-of-two axes and degrades gracefully off it)."""
    fs, p = [], 2
    while p * p <= n:
        while n % p == 0:
            fs.append(p)
            n //= p
        p += 1
    if n > 1:
        fs.append(n)
    return tuple(fs)


@dataclasses.dataclass(frozen=True)
class MergeStage:
    """One groupwise exchange round-set: devices whose index on
    ``axis_name`` shares every digit but ``(idx // place) % factor``
    exchange sub-blocks and ⊕-fold, resolving that digit of the final
    chunk id. ``factor - 1`` ppermutes of ``block/factor`` elements."""

    axis_name: str
    axis_size: int      # full size of the named mesh axis (perm domain)
    factor: int         # group size resolved by this stage
    place: int          # digit place value within the axis index


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """A compiled-schedule description for one Merge: which topology, over
    which mesh axis (or axis tuple), in which staged decomposition.

    Invariant shared by every topology: input is the per-device partial of
    ``axis_size * m`` elements along the merge dim; output is the
    ⊕-reduced chunk ``g`` of ``m`` elements on flat device ``g`` — the
    identical contract (and bit-identical results on order-exact data) as
    the flat ``psum_scatter`` / ``all_to_all`` merge.
    """

    topology: str                       # member of MERGE_FAMILIES
    axis_name: Any                      # name or tuple naming the merge axis
    axis_size: int                      # total devices reduced over
    stages: Tuple[MergeStage, ...] = ()
    # Post-stage layout-fix permutation over the *flat* merge axis
    # (staged2d order="cr" transposes chunk ids; one extra ppermute).
    fixup: Optional[Tuple[Tuple[int, int], ...]] = None
    order: str = "rc"

    def __post_init__(self):
        if self.topology not in MERGE_FAMILIES:
            raise ValueError(f"unknown merge topology {self.topology!r}; "
                             f"expected one of {MERGE_FAMILIES}")

    # Self-describing accounting: the plan knows its own α (steps) and β
    # (elements-on-wire) shape, so the tracing layer can annotate Merge
    # spans without reaching up into graphs.cost_model (which prices the
    # same quantities *with* hop/link weights — merge_wire_cost's
    # unit-weight path must agree with these, pinned in tests/test_obs.py).

    @property
    def n_steps(self) -> int:
        """Latency rounds this schedule executes (the α count: ppermute
        round-sets for ring/tree/staged, one bulk exchange for flat)."""
        if self.topology == "flat":
            return 1
        if self.topology == "ring":
            return self.axis_size - 1
        steps = sum(st.factor - 1 for st in self.stages)
        return steps + (1 if self.fixup is not None else 0)

    def wire_elements(self, m: float) -> float:
        """Elements each device ships over the fabric to merge an
        ``m``-element per-device partial under this schedule (the β term,
        hop-unweighted: every reduce-scatter moves ``(1-1/d)·m`` plus the
        staged-order fixup's relayout chunk; flat's host bounce doubling
        is the cost model's hop weight, not the element count)."""
        d = self.axis_size
        if self.topology in ("flat", "ring"):
            return (d - 1) / d * float(m)
        wire, live = 0.0, float(m)
        for st in self.stages:
            wire += (st.factor - 1) / st.factor * live
            live /= st.factor
        if self.fixup is not None:
            wire += live
        return wire


def _axis_radix_stages(axis_name: str, axis_size: int) -> list[MergeStage]:
    """Prime-radix stage list for one mesh axis, most-significant digit
    first (big-endian nesting ⇒ final chunk offsets compose to the flat
    device index)."""
    stages = []
    place = axis_size
    for f in prime_factors(axis_size):
        place //= f
        stages.append(MergeStage(axis_name, axis_size, f, place))
    return stages


def plan_merge(strategy: str, mesh_shape: Tuple[int, int],
               topology: str = "flat",
               axis_names: Sequence[str] = ("dr", "dc"),
               order: str = "rc") -> Optional[MergePlan]:
    """Build the MergePlan for one Fig.-3 strategy on an (R, C) mesh.

    * ``row``  — no Merge phase at all: returns None for every topology
      (the output is born row-sharded).
    * ``col``  — Merge spans the full flat axis (R·C devices). staged2d
      uses the mesh's two axes as the hierarchy: ``order="rc"`` reduces
      along ``axis_r`` first (the canonical big-endian nesting, no fixup),
      ``order="cr"`` the transpose order plus one chunk-relayout ppermute.
    * ``2d``   — Merge spans ``axis_c`` only (the Load already gathered
      over ``axis_r``); staged2d degenerates to the radix schedule over
      that single axis (== tree).

    With a tracer installed (repro_torch.obs.trace), each planning call
    records a ``collective/plan_merge`` span carrying the schedule's
    self-reported accounting (axis size, step count); the *execution* cost
    of the collective is observed by the ``phase/retrieve_merge`` span of
    the closure it runs inside.
    """
    t = trace.active()
    if t is None:
        return _build_merge_plan(strategy, mesh_shape, topology, axis_names,
                                 order)
    with t.span("collective/plan_merge", strategy=strategy,
                topology=topology, order=order) as sp:
        plan = _build_merge_plan(strategy, mesh_shape, topology, axis_names,
                                 order)
        if plan is not None:
            sp.set(axis_size=plan.axis_size, steps=plan.n_steps)
    return plan


def _build_merge_plan(strategy: str, mesh_shape: Tuple[int, int],
                      topology: str, axis_names: Sequence[str],
                      order: str) -> Optional[MergePlan]:
    if strategy == "row":
        return None
    if topology not in MERGE_FAMILIES:
        raise ValueError(f"unknown merge topology {topology!r}; "
                         f"expected one of {MERGE_FAMILIES}")
    if order not in STAGED_ORDERS:
        raise ValueError(f"unknown staged order {order!r}; "
                         f"expected one of {STAGED_ORDERS}")
    ar, ac = axis_names
    r_parts, c_parts = mesh_shape
    if strategy == "col":
        axis, d = (ar, ac), r_parts * c_parts
        if topology in ("flat", "ring"):
            return MergePlan(topology, axis, d)
        if topology == "tree":
            stages = (_axis_radix_stages(ar, r_parts)
                      + _axis_radix_stages(ac, c_parts))
            return MergePlan(topology, axis, d, tuple(stages))
        # staged2d: one full-axis stage per mesh axis, in `order`.
        r_stage = MergeStage(ar, r_parts, r_parts, 1)
        c_stage = MergeStage(ac, c_parts, c_parts, 1)
        if order == "rc":
            return MergePlan(topology, axis, d, (r_stage, c_stage),
                             order=order)
        # cr resolves the c digit first, landing chunk c*R + r on flat
        # device r*C + c; a final transpose ppermute restores chunk g at
        # device g (priced as one extra M/d hop by the cost model).
        fixup = tuple((r * c_parts + c, c * r_parts + r)
                      for r in range(r_parts) for c in range(c_parts))
        return MergePlan(topology, axis, d, (c_stage, r_stage),
                         fixup=fixup, order=order)
    if strategy == "2d":
        if topology == "flat":
            return MergePlan(topology, ac, c_parts)
        if topology == "ring":
            return MergePlan(topology, ac, c_parts)
        # tree and (degenerate single-axis) staged2d share the radix form
        return MergePlan(topology, ac, c_parts,
                         tuple(_axis_radix_stages(ac, c_parts)))
    raise ValueError(f"unknown strategy {strategy!r}")


# ---------------------------------------------------------------------------
# Execution on the stacked [D, ...] tensors of core/mesh.py
# ---------------------------------------------------------------------------

def _fold_in_order(x: Tensor, sr: Semiring) -> Tensor:
    """⊕ over dim 1 of x [D, S, ...] in position order, left to right."""
    acc = x[:, 0]
    for p in range(1, x.shape[1]):
        acc = sr.add(acc, x[:, p])
    return acc


def _chunked(x: Tensor, d: int) -> Tensor:
    """x [D, d·m, ...] as [D, d, m, ...] (same memory)."""
    if x.shape[1] % d:
        raise ValueError(f"merge dim of {x.shape[1]} does not split into {d} chunks")
    return x.view(x.shape[0], d, x.shape[1] // d, *x.shape[2:])


def _flat_reduce_scatter(mesh: Mesh, chunks: Tensor, sr: Semiring, axis_name) -> Tensor:
    """The one-shot merge (the paper's host-mediated pattern): exchange
    the chunks (the Retrieve), then ⊕ them in sender order (the Merge)."""
    return _fold_in_order(mesh.all_to_all(chunks, axis_name), sr)


def _ring_reduce_scatter(mesh: Mesh, chunks: Tensor, sr: Semiring, axis_name) -> Tensor:
    """Neighbour-only ring ⊕-reduce-scatter: d-1 ppermute steps of one M/d
    chunk each. After step s, device i carries chunk (i-2-s) mod d with s+2
    contributions; the last hop lands the fully ⊕-reduced chunk i on
    device i."""
    d = chunks.shape[1]
    i = mesh.axis_index(axis_name)
    perm = [(j, (j + 1) % d) for j in range(d)]
    acc = mesh.take(chunks, (i - 1) % d)
    for s in range(d - 1):
        acc = mesh.ppermute(acc, axis_name, perm)
        acc = sr.add(acc, mesh.take(chunks, (i - 2 - s) % d))
    return acc


def _run_stage(mesh: Mesh, block: Tensor, sr: Semiring, st: MergeStage) -> Tensor:
    """One radix/staged exchange: split the live block into ``factor``
    sub-blocks; every device keeps the one indexed by its digit and ships
    each other sub-block straight to the group peer owning that digit
    (factor-1 ppermutes), ⊕-folding what it receives."""
    f, p = st.factor, st.place
    if f == 1:
        return block
    sub = _chunked(block, f)
    a = (mesh.axis_index(st.axis_name) // p) % f
    acc = mesh.take(sub, a)
    for delta in range(1, f):
        perm = []
        for j in range(st.axis_size):
            aj = (j // p) % f
            perm.append((j, j + ((((aj + delta) % f) - aj) * p)))
        payload = mesh.take(sub, (a + delta) % f)
        acc = sr.add(acc, mesh.ppermute(payload, st.axis_name, perm))
    return acc


def merge_chunks(mesh: Mesh, y_chunks: Tensor, sr: Semiring, plan: MergePlan) -> Tensor:
    """Merge partials that arrive **already chunk-major**, y_chunks
    [D, d, m/d, ...]: the layout the fused kernels write with ``chunks=d``.
    Ring and flat consume the chunks as they are; the radix schedules view
    them flat ([d, m/d] row-major is [m]) and share :func:`merge`'s path,
    so every topology gives the bits of its unfused form."""
    d = plan.axis_size
    if y_chunks.shape[1] != d:
        raise ValueError(f"expected {d} chunks, got {tuple(y_chunks.shape)}")
    if plan.topology == "ring":
        return _ring_reduce_scatter(mesh, y_chunks, sr, plan.axis_name)
    if plan.topology == "flat":
        return _flat_reduce_scatter(mesh, y_chunks, sr, plan.axis_name)
    return merge(mesh, y_chunks.flatten(1, 2), sr, plan)


def merge(mesh: Mesh, y_partial: Tensor, sr: Semiring, plan: Optional[MergePlan],
          *, axis: int = 0) -> Tensor:
    """⊕-reduce-scatter the per-device partials y_partial [D, ...] along
    the per-device dim ``axis`` per ``plan``: the Merge phase's single
    entry point.

    ``plan=None`` (the row strategy) is the identity. ``axis`` selects the
    merge dimension (0 for vectors and SpGEMM row blocks, 1 for the
    batched [B, d·m] layout); it shrinks by ``plan.axis_size`` and every
    other dimension is untouched. Device g ends holding ⊕-reduced chunk g
    under every topology, so topologies interchange bit for bit on
    order-exact (integer-valued) data.
    """
    if plan is None:
        return y_partial
    if axis != 0:
        y = y_partial.movedim(axis + 1, 1)
        return merge(mesh, y, sr, plan).movedim(1, axis + 1)
    d = plan.axis_size
    if plan.topology == "flat":
        return _flat_reduce_scatter(mesh, _chunked(y_partial, d), sr, plan.axis_name)
    if plan.topology == "ring":
        return _ring_reduce_scatter(mesh, _chunked(y_partial, d), sr, plan.axis_name)
    # tree / staged2d: chained radix stages (+ optional layout fixup)
    block = y_partial
    for st in plan.stages:
        block = _run_stage(mesh, block, sr, st)
    if plan.fixup is not None:
        block = mesh.ppermute(block, plan.axis_name, list(plan.fixup))
    return block
