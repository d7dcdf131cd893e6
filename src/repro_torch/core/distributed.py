"""Distributed semiring SpMV/SpMSpV/SpGEMM over a device mesh (paper §4.1.1
+ §6.3), on the D virtual devices of ``core/mesh.py``.

PyTorch counterpart of ``repro.core.distributed``. The paper's four phases:

    Load     : all-gather of the input vector onto the devices that need it
    Kernel   : local semiring SpMV / SpMSpV, once per device on its slice
    Retrieve : moving partial outputs (the exchange of the ⊕-reduce-scatter)
    Merge    : the ⊕-reduction itself (``core/collectives.py``)

Strategies (paper Fig. 3):
    row   — A row-sharded over the flat axis; Load = all-gather(x); the
            output lands sharded; no Retrieve/Merge.
    col   — A col-sharded; no Load; the Kernel emits full-length partials;
            Retrieve+Merge = ⊕-reduce-scatter over the flat axis.
    2d    — A tiled over (axis_r, axis_c); Load = all-gather(x) over
            axis_r; Retrieve+Merge = ⊕-reduce-scatter over axis_c.

``topology`` picks the Merge collective (``flat``/``ring``/``tree``/
``staged2d``); every topology lands the same layout, and the same bits on
order-exact data.

Every sharded tensor carries a leading device axis: x and y are
``[D, n_per]`` in the plan's canonical layouts (input chunk ``g = c*R +
r`` holds piece *r* of column band *c*; output chunk ``g = r*C + c`` holds
piece *c* of row band *r*), shard and unshard them with the plan
(``core/partition.py``). On a ``core/rank_mesh.py`` mesh every rank holds
its own block, [1, ...], of x, y and the partition (``partition(...,
part=rank)``): the Kernel phase loops over the blocks the mesh holds,
never over the plan's device count. On either mesh the 2d layout move is
a ``ppermute`` (``to_2d_layout``). On the virtual mesh a collective is
one indexing copy over the device axis; the Load's gathered input is a
real copy, with a device time of its own. The Kernel phase runs the
local body once per virtual device on its slice of the stacked
partition, contiguous views, so one Kernel phase is D kernel launches on
one stream, in device order. No matvec phase reads
from the card: the front doors build their metadata on the device, and the
mesh keeps its index tables there. The SpGEMM path does read: the front
door's 0/1 test (``kernels/ops.py``) and the wrappers' ``torch.nonzero``
over the mask tiles. ``chip_smoke.py`` (phase 16) counts one read per
device a call on the kernel-6 path and two on the kernel-6b path (8 and 16
at D = 8).

Each strategy's phases are defined once (``_phases``): a matvec runs them
in order, and ``build_phase_fns`` exposes each as its own closure. The
closures never synchronise: the caller picks the schedule
(``core/pipeline.py``).

The JAX package's ``named_sharding`` has no counterpart: a virtual device's
block is its slice of the stacked tensor, and no sharding object exists.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.collectives import merge as merge_collective
from repro_torch.core.collectives import merge_chunks, plan_merge
from repro_torch.core.mesh import Mesh
from repro_torch.core.partition import PartitionedMatrix, device_part
from repro_torch.core.pipeline import _synchronize, run_phases_once
from repro_torch.core.semiring import Semiring
from repro_torch.core.spgemm import apply_mask, spgemm_masked
from repro_torch.core.spmspv import Frontier, frontier_from_dense, spmspv_batch
from repro_torch.core.spmspv import spmspv as _spmspv
from repro_torch.core.spmv import spmv as _spmv
from repro_torch.core.spmv import spmv_batch
from repro_torch.obs import trace

Tensor = torch.Tensor


def _merge_plans(mesh: Mesh, axis_names: Sequence[str], topology: str,
                 merge_order: str):
    """(col_plan, col2d_plan) for this mesh: the MergePlans the col and 2d
    strategies' Retrieve+Merge route through (collectives.plan_merge)."""
    ar, ac = axis_names
    shape = (mesh.shape[ar], mesh.shape[ac])
    return (plan_merge("col", shape, topology, axis_names, merge_order),
            plan_merge("2d", shape, topology, axis_names, merge_order))


def _local_matvec(a_local, x_full: Tensor, sr: Semiring, kernel: str, impl: str) -> Tensor:
    if kernel == "spmv":
        return _spmv(a_local, x_full, sr, impl=impl)
    f = frontier_from_dense(x_full, sr)
    return _spmspv(a_local, f, sr, impl=impl)


def _per_device(parts, xs: Tensor, body) -> Tensor:
    """The Kernel phase: ``body(device g's part, xs[g])`` for every device
    in order, on contiguous views, stacked over the device axis."""
    return torch.stack([body(device_part(parts, g), xs[g]) for g in range(xs.shape[0])])


def _check_fused(pm: PartitionedMatrix) -> None:
    if pm.fmt != "bsr":
        raise ValueError(
            f"fused=True streams ELL-of-tiles shards and needs fmt='bsr'; "
            f"this partition holds fmt={pm.fmt!r}")


def _fused_partials(parts, xs: Tensor, sr: Semiring, kernel: str, d: int):
    """Fused Load+Kernel partials for a merge over ``d`` chunks. When the
    block-row count divides evenly the kernel writes its output
    chunk-major ([D, d, m/d]) for merge_chunks; otherwise flat ([D, m]).
    Returns (partials, chunked?)."""
    from repro_torch.kernels import ops  # deferred: ops imports core

    chunks = d if parts.tiles.shape[1] % d == 0 else None

    def body(a_local, x):
        if kernel == "spmv":
            return ops.semiring_spmv_fused(a_local, x, sr, chunks=chunks)
        return ops.semiring_spmspv_fused(a_local, frontier_from_dense(x, sr), sr,
                                         chunks=chunks)

    return _per_device(parts, xs, body), chunks is not None


def _fused_merge(mesh: Mesh, parts, xs: Tensor, sr: Semiring, kernel: str, mp) -> Tensor:
    """Kernel + Retrieve + Merge of the fused path: the chunk-major
    partials go straight into merge_chunks."""
    y_partial, chunked = _fused_partials(parts, xs, sr, kernel, mp.axis_size)
    if chunked:
        return merge_chunks(mesh, y_partial, sr, mp)
    return merge_collective(mesh, y_partial, sr, mp)


def _compress(x: Tensor, sr: Semiring, f_max: int):
    """``frontier_from_dense(x[g], sr, f_max)`` for every row of x [D, n]
    at once: (indices [D, f], values [D, f], count [D])."""
    n = x.shape[1]
    is_nz = x != sr.zero
    count = is_nz.to(torch.int32).sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~is_nz).to(torch.int8), dim=1, stable=True)
    ar = torch.arange(n, device=x.device)
    idx = torch.where(ar[None, :] < count[:, None], order, n)[:, :f_max].to(torch.int32)
    ok = idx < n
    vals = torch.where(ok, torch.gather(x, 1, torch.where(ok, idx, 0).long()).to(sr.dtype),
                       sr.zero)
    return idx, vals, torch.clamp(count, max=f_max)


def gather_frontier(mesh: Mesh, x_local: Tensor, sr: Semiring, f_local: int,
                    axis_name) -> Frontier:
    """The paper's compressed Load phase: each device compresses its slice
    of the input vector to an (indices, values) frontier of capacity
    ``f_local`` and only that crosses the fabric: Load traffic drops from
    n_per to 2*f_local per peer (§4.1/§6.2).

    Returns the gathered frontier of every device stacked: indices and
    values [D, S·f_local], count [D], over a vector of S·n_per entries
    (S the axis size); device g's is :func:`frontier_of` (…, g). A device
    holding more than ``f_local`` nonzeros truncates (callers size
    f_local from the density bound, as the paper sizes its DPU buffers)."""
    n_per = x_local.shape[1]
    idx, vals, _ = _compress(x_local, sr, f_local)
    idx_g = mesh.all_gather(idx, axis_name)                     # on the wire
    val_g = mesh.all_gather(vals, axis_name)
    s = mesh.axis_size(axis_name)
    f = idx.shape[1]
    offs = (torch.arange(s, dtype=torch.int32, device=idx.device) * n_per).repeat_interleave(f)
    ok = idx_g < n_per                                          # pad index = n_per
    gidx = torch.where(ok, idx_g + offs[None, :], s * n_per).to(torch.int32)
    return Frontier(gidx, val_g.to(sr.dtype), ok.to(torch.int32).sum(dim=1, dtype=torch.int32),
                    s * n_per)


def frontier_of(f: Frontier, g: int) -> Frontier:
    """Device g's frontier out of :func:`gather_frontier`'s stacked one."""
    return Frontier(f.indices[g], f.values[g], f.count[g], f.n)


def _check_plan(pm: PartitionedMatrix, strategy: str) -> None:
    """A strategy only makes sense on a matching grid: the plan's split
    axes must line up with the collectives the strategy issues."""
    r_parts, c_parts = pm.grid
    if strategy == "row" and c_parts != 1:
        raise ValueError(f"row strategy needs a (D, 1) grid, got {pm.grid}")
    if strategy == "col" and r_parts != 1:
        raise ValueError(f"col strategy needs a (1, D) grid, got {pm.grid}")
    if strategy not in ("row", "col", "2d"):
        raise ValueError(strategy)


def _check_mesh(mesh: Mesh, pm: PartitionedMatrix, strategy: str,
                axis_names: Sequence[str]) -> None:
    ar, ac = axis_names
    if mesh.n_devices != pm.n_devices:
        raise ValueError(f"mesh of {mesh.n_devices} devices, partition of {pm.n_devices}")
    if strategy == "2d" and pm.grid != (mesh.shape[ar], mesh.shape[ac]):
        raise ValueError(f"2d grid {pm.grid} != mesh {(mesh.shape[ar], mesh.shape[ac])}")


def _phases(mesh: Mesh, pm: PartitionedMatrix, sr: Semiring, strategy: str, kernel: str,
            impl: str, axis_names: Sequence[str], f_local: int | None, topology: str,
            merge_order: str, fused: bool) -> dict:
    """The Load, Kernel and Retrieve+Merge closures of one strategy, the
    one definition that make_distributed_matvec runs in sequence and
    build_phase_fns exposes: load (parts, xs) -> xf (None: no Load),
    kernel (parts, xs, xf) -> partials, retrieve_merge (parts, ys) ->
    merged output (None: no Retrieve+Merge, or folded into a fused
    kernel)."""
    _check_plan(pm, strategy)
    _check_mesh(mesh, pm, strategy, axis_names)
    if fused:
        _check_fused(pm)
    ar, ac = axis_names
    col_mp, col2d_mp = _merge_plans(mesh, axis_names, topology, merge_order)
    loc_impl = "fused" if fused else impl

    if strategy == "row":
        load = lambda parts, xs: mesh.all_gather(xs, (ar, ac))            # noqa: E731
        axis, mp = (ar, ac), None
    else:
        # 2d: with the 2d input layout (device (r, c) holds chunk c*R + r),
        # the gather over axis_r assembles column band c on every grid row.
        load = None if strategy == "col" else (
            lambda parts, xs: mesh.all_gather(to_2d_layout(mesh, xs, pm.grid, axis_names), ar))
        axis, mp = ar, (col_mp if strategy == "col" else col2d_mp)
    retrieve_merge = None if mp is None else (
        lambda parts, ys: merge_collective(mesh, ys, sr, mp))

    if f_local is not None and kernel == "spmspv" and strategy != "col":
        # the compressed Load: each device's frontier crosses the fabric
        def c_load(parts, xs):
            x = xs if strategy == "row" else to_2d_layout(mesh, xs, pm.grid, axis_names)
            return gather_frontier(mesh, x, sr, f_local, axis)

        def c_kernel(parts, xs, f):
            return torch.stack([_spmspv(device_part(parts, g), frontier_of(f, g), sr,
                                        impl=loc_impl) for g in range(f.indices.shape[0])])
        return {"load": c_load, "kernel": c_kernel, "retrieve_merge": retrieve_merge}
    if fused and mp is not None:
        # the fused kernels write chunk-major partials that the Merge folds
        # as they are: Kernel and Retrieve+Merge are one closure
        return {"load": load, "retrieve_merge": None,
                "kernel": lambda parts, xs, xf: _fused_merge(mesh, parts, xf, sr, kernel, mp)}
    return {"load": load, "retrieve_merge": retrieve_merge,
            "kernel": lambda parts, xs, xf: _per_device(
                parts, xf, lambda a, x: _local_matvec(a, x, sr, kernel, loc_impl))}


def make_distributed_matvec(
    mesh: Mesh,
    pm: PartitionedMatrix,
    sr: Semiring,
    strategy: str,
    kernel: str = "spmv",
    impl: str = "auto",
    axis_names: Sequence[str] = ("dr", "dc"),
    f_local: int | None = None,
    topology: str = "flat",
    merge_order: str = "rc",
    fused: bool = False,
) -> Callable[[object, Tensor], Tensor]:
    """Build ``fn(parts, x_sharded) -> y_sharded``.

    x/y are the canonical flat layouts [D, n_per] (``shard_tensor`` /
    ``unshard_tensor`` of the plan; for ``balance="rows"`` plain row-major
    chunks, so an iteration can feed y back in when the padded shape is
    square). With ``balance="nnz"`` the input and output chunkings differ,
    so chaining iterations needs an unshard/reshard between steps.

    ``f_local`` (SpMSpV on row and 2d) switches the Load phase to the
    paper's compressed form (see gather_frontier).

    ``topology`` picks the Merge collective family (``merge_order`` is the
    staged2d stage order); the row strategy has no Merge.

    ``fused=True`` (fmt="bsr" only) runs the local compute through the
    fused kernels (3 for spmv, 5 for spmspv), which read only each block
    row's real or frontier-active slots; where the block-row count divides
    by the merge's chunk count they also write their partials chunk-major,
    so the Merge starts from the kernel's own output (merge_chunks).
    Bit-identical to ``fused=False`` wherever pad ⊗ x is the ⊕-identity.

    The call runs the strategy's phases in order (``run_phases_once``),
    nothing synchronised.
    """
    phases = _phases(mesh, pm, sr, strategy, kernel, impl, axis_names, f_local, topology,
                     merge_order, fused)
    return lambda parts, x: run_phases_once(phases, parts, x)


def make_distributed_spmv(mesh: Mesh, pm: PartitionedMatrix, sr: Semiring,
                          strategy: str, **kwargs) -> Callable[[object, Tensor], Tensor]:
    """make_distributed_matvec pinned to the dense-input SpMV kernel."""
    return make_distributed_matvec(mesh, pm, sr, strategy, kernel="spmv", **kwargs)


def make_distributed_spmspv(mesh: Mesh, pm: PartitionedMatrix, sr: Semiring,
                            strategy: str, **kwargs) -> Callable[[object, Tensor], Tensor]:
    """make_distributed_matvec pinned to the sparse-frontier SpMSpV kernel."""
    return make_distributed_matvec(mesh, pm, sr, strategy, kernel="spmspv", **kwargs)


def make_distributed_batched_matvec(
    mesh: Mesh,
    pm: PartitionedMatrix,
    sr: Semiring,
    strategy: str,
    kernel: str = "spmv",
    impl: str = "auto",
    axis_names: Sequence[str] = ("dr", "dc"),
    topology: str = "flat",
    merge_order: str = "rc",
) -> Callable[[object, Tensor], Tensor]:
    """[B, n]-block counterpart of make_distributed_matvec: the adjacency
    shards as in the unbatched path while every Load/Retrieve/Merge
    carries the whole query block. Each device runs ``spmv_batch`` /
    ``spmspv_batch`` on its slice, so on BSR parts kernels 1 and 2 run
    over the block (1b, 2b), and row b equals the unbatched call on
    x[:, b].

    x/y layout: [D, B, n_per] (``shard_tensor(plan, xs, fill, dim=1)``,
    ``unshard_tensor(plan, ys, dim=1)``). The compressed Load stays
    single-query only.
    """
    _check_plan(pm, strategy)
    _check_mesh(mesh, pm, strategy, axis_names)
    ar, ac = axis_names
    flat = (ar, ac)
    col_mp, col2d_mp = _merge_plans(mesh, axis_names, topology, merge_order)

    def local(a_local, xs_full: Tensor) -> Tensor:
        if kernel == "spmv":
            return spmv_batch(a_local, xs_full, sr, impl=impl)
        return spmspv_batch(a_local, xs_full, sr, impl=impl)

    def compute(parts, xf):
        return _per_device(parts, xf, local)

    if strategy == "row":
        return lambda parts, x: compute(parts, mesh.all_gather(x, flat, dim=2))
    if strategy == "col":
        return lambda parts, x: merge_collective(mesh, compute(parts, x), sr, col_mp, axis=1)

    def fn(parts, x):
        y_partial = compute(parts, mesh.all_gather(to_2d_layout(mesh, x, pm.grid, axis_names),
                                                   ar, dim=2))
        return merge_collective(mesh, y_partial, sr, col2d_mp, axis=1)
    return fn


def make_distributed_spgemm(
    mesh: Mesh,
    pm: PartitionedMatrix,
    sr: Semiring,
    strategy: str,
    axis_names: Sequence[str] = ("dr", "dc"),
    topology: str = "flat",
    merge_order: str = "rc",
) -> Callable[..., Tensor]:
    """Partitioned masked SpGEMM C = (A ⊕.⊗ B) ⊙ M over the Fig.-3
    strategies, with B's rows in the input-vector role:

        row — A row-sharded; Load = all-gather(B rows); C lands
              row-sharded; no Retrieve/Merge.
        col — A col-sharded; B rows stay sharded (no Load); each device
              emits a full-height partial C; Retrieve+Merge =
              ⊕-reduce-scatter of C row blocks over the flat axis.
        2d  — A tiled (R, C); Load = all-gather(B row chunks) over axis_r;
              Retrieve+Merge = ⊕-reduce-scatter of C rows over axis_c.

    Returns ``fn(parts, b_sharded, mask_sharded=None) -> c_sharded``: B is
    [D, k_per, N], C and the mask [D, m_per, N] (``shard_tensor`` with
    ``side="output"`` for the mask). Each device runs the SpGEMM front door
    (``core.spgemm.spgemm_masked``, which takes kernel 6 or, for 0/1
    operands under ⟨+,∧⟩/⟨∨,∧⟩, kernel 6b). The mask is structural and
    applied after the Merge, on output rows already in place."""
    _check_plan(pm, strategy)
    _check_mesh(mesh, pm, strategy, axis_names)
    ar, ac = axis_names
    flat = (ar, ac)
    col_mp, col2d_mp = _merge_plans(mesh, axis_names, topology, merge_order)

    def compute(parts, bf):
        return _per_device(parts, bf, lambda a, b: spgemm_masked(a, b, sr))

    def fn(parts, b, mask=None):
        if strategy == "row":
            c = compute(parts, mesh.all_gather(b, flat))                  # Load, Kernel
        elif strategy == "col":
            c = merge_collective(mesh, compute(parts, b), sr, col_mp)
        else:
            b2 = to_2d_layout(mesh, b, pm.grid, axis_names)
            c = merge_collective(mesh, compute(parts, mesh.all_gather(b2, ar)), sr, col2d_mp)
        if mask is None:
            return c
        if tuple(mask.shape) != tuple(c.shape):
            raise ValueError(f"mask must be {list(c.shape)}, got {tuple(mask.shape)}")
        return apply_mask(c, mask, sr)
    return fn


def _traced_phase(fn, name: str, attrs: dict):
    """Wrap one phase closure for observability (repro_torch.obs.trace).

    Tracing off (the default): one module-global None check, then straight
    through to the closure, nothing synchronised. Tracing on: the call runs
    inside a span and synchronises inside it, so the span measures the
    phase's device time (the paper's blocking-DMA accounting). The sync
    moves host timing only; values are the same bits either way."""
    if fn is None:
        return None

    def run(*args):
        t = trace.active()
        if t is None:
            return fn(*args)
        with t.span(name, **attrs):
            return _synchronize(fn(*args))
    return run


def build_phase_fns(mesh: Mesh, pm: PartitionedMatrix, sr: Semiring,
                    strategy: str, kernel: str, f_local: int | None = None,
                    donate: bool = False, topology: str = "flat",
                    merge_order: str = "rc", fused: bool = False):
    """Per-phase closures for one Fig.-3 strategy. Returns a dict:

        load           : (parts, xs) -> gathered input   (None: no Load)
        kernel         : (parts, xs, xf) -> partials     (None: compressed Load)
        retrieve_merge : (parts, ys) -> merged output    (None: no R+M)
        feedback       : ys -> xs-layout output          (None: identity)
        e2e            : (parts, xs) -> output, the phases in order (the
                         make_distributed_matvec call)

    No closure synchronises; the schedule (blocking or pipelined) is the
    caller's (core.pipeline). ``feedback`` is None for every strategy: the
    merged output [D, out_per] is already in device order, which is the
    canonical layout (the JAX package needs a reshape for 2d). Chaining
    iterations assumes the input and output chunkings coincide, which
    holds for ``balance="rows"`` on a square padded shape.

    ``f_local`` switches SpMSpV to the compressed Load; the ``load``
    closure then returns the stacked gathered frontier's (indices, values)
    and ``kernel`` is None (run_phases_once falls back to ``e2e``, which
    runs the frontier's Kernel).

    ``donate=True`` is accepted and inert: the merge reads the partials
    through indexing copies and never writes them, so there is no buffer to
    hand over (as on the JAX CPU backend). Repeated ``retrieve_merge``
    calls on the same partials are safe either way.

    ``fused=True`` (fmt="bsr" only): for col and 2d the Kernel and
    Retrieve+Merge run as one closure (the fused kernels write chunk-major
    partials that merge_chunks folds), so ``retrieve_merge`` is None and
    ``kernel`` returns merged output.
    """
    del donate
    d = pm.n_devices
    phases = _phases(mesh, pm, sr, strategy, kernel, "auto", ("dr", "dc"), f_local, topology,
                     merge_order, fused)
    fns = {**phases, "feedback": None,
           "e2e": lambda parts, xs: run_phases_once(phases, parts, xs)}
    compressed = f_local is not None and kernel == "spmspv" and strategy != "col"
    if compressed:
        # the Load's output on the wire; the Kernel runs only inside e2e
        fns["load"] = lambda parts, xs: (lambda f: (f.indices, f.values))(
            phases["load"](parts, xs))
        fns["kernel"] = None

    # Observability wrap: each closure a _traced_phase, a blocking span
    # named phase/<name> when a tracer is installed. The attrs carry the
    # wire accounting inline: Load bytes are the elements each device
    # assembles, Merge bytes and steps come from the MergePlan.
    m_pad, n_pad = pm.shape
    r_parts, c_parts = pm.grid
    elem = torch.empty((), dtype=sr.dtype).element_size()
    load_elems = {"row": n_pad, "col": 0, "2d": n_pad // c_parts}[strategy]
    if compressed:
        load_elems = 2 * f_local * (d if strategy == "row" else r_parts)
    mp = plan_merge(strategy, (r_parts, c_parts), topology, ("dr", "dc"), merge_order)
    m_merge = {"row": 0, "col": m_pad, "2d": m_pad // r_parts}[strategy]
    wire = mp.wire_elements(m_merge) if strategy != "row" else 0.0
    steps = mp.n_steps if strategy != "row" else 0
    base = {"strategy": strategy, "kernel": kernel, "topology": topology,
            "devices": d, "fused": fused}
    attrs = {
        "load": {**base, "phase": "load", "bytes": load_elems * elem},
        "kernel": {**base, "phase": "kernel"},
        "retrieve_merge": {**base, "phase": "retrieve_merge",
                           "bytes": wire * elem, "steps": steps},
        "feedback": {**base, "phase": "feedback"},
        "e2e": {**base, "phase": "e2e", "bytes": (load_elems + wire) * elem},
    }
    for name in ("load", "kernel", "retrieve_merge", "feedback", "e2e"):
        fns[name] = _traced_phase(fns[name], f"phase/{name}", attrs[name])
    return fns


def vec_to_2d_layout(x: Tensor, grid) -> Tensor:
    """Canonical [D, ...] (chunk g at device g) → the 2d input layout:
    device (r, c), flat r*C + c, holds chunk c*R + r. One permuting copy:
    the paper's inter-iteration vector reload through the host CPU."""
    r_parts, c_parts = grid
    return x.reshape(c_parts, r_parts, *x.shape[1:]).transpose(0, 1).reshape(x.shape)


def to_2d_layout(mesh: Mesh, x: Tensor, grid, axis_names: Sequence[str] = ("dr", "dc")) -> Tensor:
    """``vec_to_2d_layout`` on ``mesh``'s blocks: a ``ppermute`` over the
    flat axis, device c*R + r sending its chunk to device r*C + c (on the
    virtual mesh one permuting copy, across ranks a send and a receive)."""
    r_parts, c_parts = grid
    perm = [(c * r_parts + r, r * c_parts + c) for r in range(r_parts) for c in range(c_parts)]
    return mesh.ppermute(x, tuple(axis_names), perm)
