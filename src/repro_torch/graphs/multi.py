"""Batched multi-source traversals: BFS/SSSP/PPR over a [B, n] frontier
block (the paper's §4 linear-algebra iteration, lifted to many queries).

One loop advances all B queries in lockstep. The JAX package's
``lax.while_loop`` is a host loop here, as in graphs/bfs.py: each level
syncs once for the stopping test (``all(done)``), plus the adaptive
switch's count and the capacity rung's live count. Per-query adaptive
SpMSpV↔SpMV switching is data flow on the device (core.adaptive
.adaptive_matvec_batch); a query that converges is frozen, its state rows
and its trace stop moving, so every row of the batched result equals the
single-source run, with its iteration count and kernel trace. On the tile
route the block goes through kernels 1 and 2 over [B, n]
(kernels/ops.py), row for row bit-identical to the single-vector
launches.

``mesh``/``axis_name`` row-shard the [B, n] block (the JAX package's
``P(axis_name, None)``): position i along ``axis_name`` (one axis or a
tuple of them) owns rows [i·c, (i+1)·c) with c = ⌈B / S⌉ for an axis of
S positions, so when S does not divide B the last positions hold fewer
rows, or none, as XLA pads an uneven split (``Mesh.row_shares``). A
runner builds state for the rows its mesh holds and launches the block
kernels once a level per position that holds rows, on its rows alone, so
the adaptive switch and kernel 2's capacity rung decide from one
position's rows; since every row is computed on its own, no answer moves.
The level loop is one host loop for the whole batch: it stops when every
row of every position is done (``Mesh.all_true``, the reference's scalar
convergence reduction), and the result rows, iteration counts and traces
are then gathered into the whole batch (``Mesh.gather_rows``).

* On a ``core.mesh.Mesh`` of virtual devices on one card the mesh holds
  every position: the state is one [B, n] tensor per array, whose row
  blocks in position order are the devices' blocks, and devices that
  differ only along the other axes hold copies, which share that tensor.
  The stopping test is one host read a level and the gather is nothing.
* On a ``core.rank_mesh.RankMesh`` (one rank per device) a rank holds its
  own position's rows alone, c_r × n, and launches only on them; ranks
  that differ only along the other axes hold the same rows and compute
  them, as copies do on the virtual mesh. Every rank takes the whole
  inputs (sources; for relax, the whole ``dist0``/``changed0``), as the
  reference takes one global array. The stopping test is one all-gather
  of a flag a position along ``axis_name`` and one host read a level, the
  result one all-gather at the end, so every rank returns the
  ``*BatchResult`` of the ``mesh=None`` run, and every rank runs the same
  number of levels and issues the same collectives in the same order. A
  rank whose share is empty (B = 6 on 8 positions) launches nothing but
  joins every collective.

``traverse_multi_buckets`` drains several source buckets through
core.pipeline.pipeline_buckets, in order on one thread, so on a
``RankMesh`` every rank issues and materialises its buckets in the same
order. ``partitioned_matvec`` partitions a graph's transposed adjacency
over a mesh as the cost-model planner picks and builds its distributed
matvec (the Fig.-3 path); on a ``RankMesh`` a rank builds its own part.
"""
from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core.adaptive import select_kernel_batch
from repro_torch.core.pipeline import pipeline_buckets
from repro_torch.core.rank_mesh import RankMesh
from repro_torch.core.semiring import BOOL_OR_AND, MIN_PLUS, PLUS_TIMES, Semiring
from repro_torch.graphs.engine import GraphEngine, density_of_batch

Tensor = torch.Tensor


class BFSBatchResult(NamedTuple):
    levels: Tensor       # int32 [B, n_true]; -1 = unreached
    iterations: Tensor   # int32 [B]
    densities: Tensor    # f32 [B, max_iters]
    kernel_used: Tensor  # int32 [B, max_iters]; 0 = SpMSpV, 1 = SpMV, -1 unused


class SSSPBatchResult(NamedTuple):
    dist: Tensor         # f32 [B, n_true]; +inf = unreachable
    iterations: Tensor
    densities: Tensor
    kernel_used: Tensor


class PPRBatchResult(NamedTuple):
    rank: Tensor         # f32 [B, n_true]
    iterations: Tensor
    densities: Tensor
    kernel_used: Tensor
    residual: Tensor     # f32 [B]


def _kernel_codes(policy: str, densities: Tensor, threshold: float) -> Tensor:
    """Per-query kernel trace codes, matching the single-source recording."""
    if policy == "spmv":
        return torch.ones(densities.shape, dtype=torch.int32, device=densities.device)
    if policy == "spmspv":
        return torch.zeros(densities.shape, dtype=torch.int32, device=densities.device)
    return select_kernel_batch(densities, threshold)


def _masked_trace_update(trace: Tensor, it: int, active: Tensor, value: Tensor) -> None:
    """trace[:, it] = value where the query is still active (in place)."""
    trace[:, it] = torch.where(active, value, trace[:, it])


def _check_semiring(engine: GraphEngine, want: Semiring, app: str) -> Semiring:
    if engine.sr.name != want.name:
        raise ValueError(f"{app} needs the {want.name} semiring, not {engine.sr.name}")
    return engine.sr


def _traces(b: int, max_iters: int, dev) -> tuple[Tensor, Tensor, Tensor]:
    """(iterations [B], densities [B, max_iters], kernel_used [B, max_iters])."""
    return (torch.zeros(b, dtype=torch.int32, device=dev),
            torch.full((b, max_iters), -1.0, dtype=torch.float32, device=dev),
            torch.full((b, max_iters), -1, dtype=torch.int32, device=dev))


def _constrain_block(engine: GraphEngine, policy: str, batch: int, mesh, axis_name):
    """The counterpart of the reference's row-sharding constraint:
    ``(lo, hi, step, all_true, gather)``, how a runner holds its [B, n]
    block. It holds rows [lo, hi) of the batch; ``step(xs, densities)``
    runs on them, ``all_true(flags)`` is the stopping test over every row
    of the batch (one host read), ``gather(tensors)`` the result rows as
    the whole batch. Without a mesh: every row, the engine's batched step.
    With one: the rows of the positions along ``axis_name`` that the mesh
    holds (``mesh.row_shares``: all of them on a ``Mesh``, the rank's own
    on a ``RankMesh``), the step run once per position that holds rows,
    on its rows alone (a position with none launches nothing), and the
    mesh's ``all_true`` and ``gather_rows``. Holds the step and the mesh,
    not the engine."""
    step = engine.batch_step_fn(policy)
    if mesh is None:
        return 0, batch, step, lambda f: bool(f.all()), list
    if mesh.device.type != engine.device.type:
        raise ValueError(f"the mesh is on {mesh.device}, the engine on {engine.device}")
    shares = mesh.row_shares(batch, axis_name)
    lo, hi = shares[0][0], shares[-1][1]
    held = [(a - lo, b - lo) for a, b in shares if b > a]
    if not held:
        own = lambda xs, _d: torch.empty_like(xs)  # noqa: E731
    elif len(held) == 1:
        own = step
    else:
        own = lambda xs, d: torch.cat([step(xs[a:b], d[a:b]) for a, b in held])  # noqa: E731
    return (lo, hi, own, lambda f: mesh.all_true(f, axis_name),
            lambda ts: mesh.gather_rows(ts, batch, axis_name))


def make_bfs_multi(engine: GraphEngine, batch: int, max_iters: int = 64,
                   policy: str = "adaptive", mesh=None,
                   axis_name="batch") -> Callable[[Tensor], BFSBatchResult]:
    """Build a runner: sources [B] (int64 on the engine's device) ->
    BFSBatchResult. Like every runner here it holds the engine's batched
    step and sizes, not the engine (see GraphEngine.batch_step_fn); with
    a ``mesh`` it runs the rows the mesh holds (see the module)."""
    sr = _check_semiring(engine, BOOL_OR_AND, "bfs_multi")
    n, n_true, threshold, dev = engine.n, engine.n_true, engine.threshold, engine.device
    lo, hi, step, all_true, gather = _constrain_block(engine, policy, batch, mesh, axis_name)
    b = hi - lo

    def run(sources: Tensor) -> BFSBatchResult:
        sources = sources[lo:hi]
        rows = torch.arange(b, device=dev)
        frontier = torch.zeros((b, n), dtype=sr.dtype, device=dev)
        frontier[rows, sources] = 1
        visited = torch.zeros((b, n), dtype=torch.int32, device=dev)
        visited[rows, sources] = 1
        levels = torch.full((b, n), -1, dtype=torch.int32, device=dev)
        levels[rows, sources] = 0
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        iters, dens, kern = _traces(b, max_iters, dev)

        it = 0
        while it < max_iters and not all_true(done):
            active = ~done
            density = density_of_batch(frontier, sr, n_true)
            used = _kernel_codes(policy, density, threshold)
            y = step(frontier, density)
            nf = ((y != sr.zero) & (visited == 0) & active[:, None]).to(sr.dtype)
            levels = torch.where((nf != 0) & (levels < 0), it + 1, levels)
            visited = torch.where(nf != 0, 1, visited)
            iters = torch.where(active, it + 1, iters)
            _masked_trace_update(dens, it, active, density)
            _masked_trace_update(kern, it, active, used)
            done = done | ~(nf != 0).any(dim=1)
            frontier = nf
            it += 1
        return BFSBatchResult(*gather([levels[:, :n_true], iters, dens, kern]))

    return run


def _relax_block(sr: Semiring, n_true: int, threshold: float, block, policy: str,
                 max_iters: int, dist: Tensor, changed: Tensor) -> SSSPBatchResult:
    """The ⟨min,+⟩ re-relaxation loop over a [B, n] state block (the rows
    ``block``, ``_constrain_block``'s tuple, holds), shared by the cold-start SSSP runner and the
    warm-start resume runner: relax only from rows' ``changed`` frontiers
    until no distance improves. Any (dist, changed) with dist ≥ the true
    fixpoint pointwise and every possible improvement reachable from a
    changed vertex converges to the exact fixpoint, the property
    graphs/dynamic.py's incremental recompute is built on."""
    _, _, step, all_true, gather = block
    b, dev = dist.shape[0], dist.device
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    iters, dens, kern = _traces(b, max_iters, dev)

    it = 0
    while it < max_iters and not all_true(done):
        active = ~done
        density = density_of_batch(changed, sr, n_true)
        used = _kernel_codes(policy, density, threshold)
        cand = step(changed, density)
        new_dist = torch.minimum(dist, cand)
        new_changed = torch.where((new_dist < dist) & active[:, None], new_dist, inf)
        dist = torch.where(active[:, None], new_dist, dist)
        iters = torch.where(active, it + 1, iters)
        _masked_trace_update(dens, it, active, density)
        _masked_trace_update(kern, it, active, used)
        done = done | ~(new_changed != inf).any(dim=1)
        changed = new_changed
        it += 1
    return SSSPBatchResult(*gather([dist[:, :n_true], iters, dens, kern]))


def make_sssp_multi(engine: GraphEngine, batch: int, max_iters: int = 64,
                    policy: str = "adaptive", mesh=None,
                    axis_name="batch") -> Callable[[Tensor], SSSPBatchResult]:
    """Build a runner: sources [B] -> SSSPBatchResult."""
    sr = _check_semiring(engine, MIN_PLUS, "sssp_multi")
    n, n_true, threshold, dev = engine.n, engine.n_true, engine.threshold, engine.device
    block = _constrain_block(engine, policy, batch, mesh, axis_name)
    lo, hi = block[:2]

    def run(sources: Tensor) -> SSSPBatchResult:
        rows = torch.arange(hi - lo, device=dev)
        dist = torch.full((hi - lo, n), float("inf"), dtype=torch.float32, device=dev)
        dist[rows, sources[lo:hi]] = 0.0
        return _relax_block(sr, n_true, threshold, block, policy, max_iters, dist, dist.clone())

    return run


def make_relax_multi(engine: GraphEngine, batch: int, max_iters: int = 64,
                     policy: str = "adaptive", mesh=None, axis_name="batch"
                     ) -> Callable[[Tensor, Tensor], SSSPBatchResult]:
    """Build a warm-start runner: (dist0, changed0) [B, n_true] f32 blocks
    -> SSSPBatchResult. Seeding ``dist0`` with the previous distances (stale
    entries reset to +inf) and ``changed0`` with the delta frontier (finite
    only where re-relaxation must start) is the incremental BFS/SSSP path of
    graphs/dynamic.py; seeding the cold start (source rows 0, the rest +inf)
    gives :func:`make_sssp_multi`'s result bit for bit: the same loop. With
    a mesh the caller passes the whole blocks and the runner takes its rows."""
    sr = _check_semiring(engine, MIN_PLUS, "relax_multi")
    n, n_true, threshold = engine.n, engine.n_true, engine.threshold
    block = _constrain_block(engine, policy, batch, mesh, axis_name)
    lo, hi = block[:2]

    def run(dist0: Tensor, changed0: Tensor) -> SSSPBatchResult:
        pad = (0, n - dist0.shape[1])
        dist = torch.nn.functional.pad(dist0[lo:hi], pad, value=float("inf"))
        changed = torch.nn.functional.pad(changed0[lo:hi], pad, value=float("inf"))
        return _relax_block(sr, n_true, threshold, block, policy, max_iters, dist, changed)

    return run


def make_ppr_multi(engine: GraphEngine, batch: int, alpha: float = 0.85,
                   max_iters: int = 50, tol: float = 1e-6,
                   policy: str = "adaptive", mesh=None,
                   axis_name="batch") -> Callable[[Tensor], PPRBatchResult]:
    """Build a runner: sources [B] -> PPRBatchResult. Each row's residual
    is summed on its own, as a [n] vector like the single-source run's, so
    a row stops where the single-source run stops: a sum over the [B, n]
    block's rows may round differently and move a stop near ``tol``."""
    sr = _check_semiring(engine, PLUS_TIMES, "ppr_multi")
    n, n_true, threshold, dev = engine.n, engine.n_true, engine.threshold, engine.device
    lo, hi, step, all_true, gather = _constrain_block(engine, policy, batch, mesh, axis_name)
    b = hi - lo
    tol_t = torch.tensor(tol, dtype=torch.float32, device=dev)

    def run(sources: Tensor) -> PPRBatchResult:
        rows = torch.arange(b, device=dev)
        e_s = torch.zeros((b, n), dtype=torch.float32, device=dev)
        e_s[rows, sources[lo:hi]] = 1.0
        r = e_s
        res = torch.full((b,), float("inf"), dtype=torch.float32, device=dev)
        iters, dens, kern = _traces(b, max_iters, dev)

        it = 0
        while it < max_iters and not all_true(~(res > tol_t)):
            active = res > tol_t
            density = density_of_batch(r, sr, n_true)
            used = _kernel_codes(policy, density, threshold)
            pr = step(r, density)
            r_new = (1.0 - alpha) * e_s + alpha * pr
            res_new = torch.stack([torch.sum(torch.abs(r_new[i] - r[i]))
                                   for i in range(b)]) if b else res      # an empty share
            r = torch.where(active[:, None], r_new, r)
            res = torch.where(active, res_new, res)
            iters = torch.where(active, it + 1, iters)
            _masked_trace_update(dens, it, active, density)
            _masked_trace_update(kern, it, active, used)
            it += 1
        return PPRBatchResult(*gather([r[:, :n_true], iters, dens, kern, res]))

    return run


_MAKERS = {"bfs": make_bfs_multi, "sssp": make_sssp_multi,
           "ppr": make_ppr_multi, "relax": make_relax_multi}

# Runners are built under one module lock: two threads draining servers
# that share an engine must not race to build (and cache) one runner twice.
_runner_lock = threading.Lock()


def _cached_runner(engine: GraphEngine, alg: str, batch: int, mesh=None,
                   axis_name="batch", **kwargs):
    """One runner per (engine, alg, batch, mesh, axis, options), kept in
    the engine instance's __dict__ (GraphEngine is an unhashable
    dataclass). On a ``Mesh`` a runner depends on the mesh only through
    its layout, so the key holds the layout (axis names, shape, device).
    A ``RankMesh``'s runner issues collectives over that mesh's process
    groups and runs its rank's rows, so its key adds the class, backend,
    rank and the mesh itself: it never shares a runner with a ``Mesh``
    of the same layout, nor with another ``RankMesh``."""
    layout = None if mesh is None else (type(mesh).__name__, mesh.axis_names, mesh.grid,
                                        str(mesh.device))
    if isinstance(mesh, RankMesh):
        layout += (mesh.backend, mesh.rank, id(mesh))
    axis = axis_name if isinstance(axis_name, str) else tuple(axis_name)
    key = (alg, batch, layout, axis, tuple(sorted(kwargs.items())))
    cache = engine.__dict__.setdefault("_multi_runners", {})
    if key not in cache:
        with _runner_lock:
            if key not in cache:      # double-checked: a lost race reuses
                cache[key] = _MAKERS[alg](engine, batch, mesh=mesh, axis_name=axis, **kwargs)
    return cache[key]


def _as_sources(sources, device) -> Tensor:
    src = np.asarray(sources.cpu() if isinstance(sources, Tensor) else sources)
    if src.ndim != 1:
        raise ValueError(f"sources must be a flat [B] list or array, got shape {src.shape}")
    return torch.as_tensor(src.astype(np.int64), device=device)


def _block(engine: GraphEngine, dist) -> Tensor:
    """A [B, n_true] f32 state block on the engine's device."""
    if isinstance(dist, Tensor):
        return dist.to(device=engine.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(dist, np.float32), device=engine.device)


def bfs_multi(engine: GraphEngine, sources, max_iters: int = 64,
              policy: str = "adaptive", mesh=None, axis_name="batch") -> BFSBatchResult:
    """Multi-source BFS; row b equals bfs(engine, sources[b])."""
    src = _as_sources(sources, engine.device)
    run = _cached_runner(engine, "bfs", int(src.shape[0]), mesh, axis_name,
                         max_iters=max_iters, policy=policy)
    return run(src)


def sssp_multi(engine: GraphEngine, sources, max_iters: int = 64,
               policy: str = "adaptive", mesh=None, axis_name="batch") -> SSSPBatchResult:
    """Multi-source SSSP; row b equals sssp(engine, sources[b])."""
    src = _as_sources(sources, engine.device)
    run = _cached_runner(engine, "sssp", int(src.shape[0]), mesh, axis_name,
                         max_iters=max_iters, policy=policy)
    return run(src)


def relax_multi(engine: GraphEngine, dist0, changed0, max_iters: int = 64,
                policy: str = "adaptive", mesh=None, axis_name="batch") -> SSSPBatchResult:
    """Warm-start ⟨min,+⟩ re-relaxation from explicit [B, n_true] state
    blocks (the delta-frontier path of graphs/dynamic.py): ``dist0`` holds
    the surviving distances (+inf where stale or unknown), ``changed0`` the
    seed frontier (+inf everywhere relaxation need not start). Runs the
    loop of :func:`sssp_multi`."""
    d0, c0 = _block(engine, dist0), _block(engine, changed0)
    if d0.dim() != 2 or d0.shape != c0.shape:
        raise ValueError(f"dist0 and changed0 must be equal [B, n] blocks, got "
                         f"{tuple(d0.shape)} and {tuple(c0.shape)}")
    run = _cached_runner(engine, "relax", int(d0.shape[0]), mesh, axis_name,
                         max_iters=max_iters, policy=policy)
    return run(d0, c0)


def ppr_multi(engine: GraphEngine, sources, alpha: float = 0.85,
              max_iters: int = 50, tol: float = 1e-6,
              policy: str = "adaptive", mesh=None, axis_name="batch") -> PPRBatchResult:
    """Multi-source PPR; row b equals ppr(engine, sources[b])."""
    src = _as_sources(sources, engine.device)
    run = _cached_runner(engine, "ppr", int(src.shape[0]), mesh, axis_name, alpha=alpha,
                         max_iters=max_iters, tol=tol, policy=policy)
    return run(src)


def _synchronize(engine: GraphEngine, result):
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return result


def traverse_multi_buckets(engine: GraphEngine, alg: str, buckets,
                           pipeline_depth: int = 2, mesh=None, axis_name="batch",
                           materialize=None, pad_to: int | None = None, **kwargs) -> list:
    """Run several source buckets through the cached batched runners,
    keeping up to ``pipeline_depth`` buckets in flight
    (core.pipeline.pipeline_buckets).

    ``materialize(bucket, result) -> value`` runs in submission order and
    receives the bucket as submitted; the default waits for the device
    and returns the *BatchResult. ``pad_to`` pads every issued bucket to
    that batch size by repeating its last source (one runner for all
    buckets; result rows past the bucket's length are padding).
    ``pipeline_depth=0`` is the strictly sequential drain; the results are
    the same at any depth. ``mesh``/``axis_name`` row-shard each bucket
    as the runners do. ``kwargs`` are the runner options (max_iters,
    policy, alpha, tol). Returns one value per bucket, in order.
    """
    def issue(bucket):
        sources = list(bucket)
        if pad_to is not None and len(sources) < pad_to:
            sources = sources + [sources[-1]] * (pad_to - len(sources))
        src = _as_sources(sources, engine.device)
        run = _cached_runner(engine, alg, int(src.shape[0]), mesh, axis_name, **kwargs)
        return run(src)

    if materialize is None:
        materialize = lambda _b, res: _synchronize(engine, res)  # noqa: E731
    return pipeline_buckets(issue, materialize, buckets, depth=pipeline_depth)


def partitioned_matvec(graph, sr: Semiring, mesh, strategy: str = "auto",
                       balance: str | None = None, kernel: str = "spmv",
                       fmt: str | None = None, frontier_density: float = 1.0,
                       weighted: bool = False, normalize: bool = False,
                       seed: int = 0, batched: bool = False,
                       topology: str = "auto", merge_order: str | None = None):
    """Partition ``graph``'s transposed adjacency over ``mesh`` (axes
    ``dr``/``dc``, a ``core.mesh.Mesh`` or a ``RankMesh``, whose rank
    builds its own part alone) and build its distributed matvec, with the
    partition decided by the cost-model planner.

    ``strategy="auto"`` lets ``graphs.cost_model.choose_partition`` pick
    strategy+balance from the graph's degree histogram and
    ``frontier_density``; a fixed ``"row"``/``"col"``/``"2d"`` (optionally
    suffixed ``:rows``/``:nnz``, or with an explicit ``balance``) pins it
    while still producing the planner's cost table. ``topology="auto"``
    takes the Merge collective the planner priced cheapest; a fixed name
    pins it (``merge_order`` selects the staged-2D order, default "rc").

    Returns ``(pm, fn, choice)``: the PartitionedMatrix on the mesh's device
    (its ``plan`` carries the layouts; on a ``RankMesh`` its parts are the
    rank's, ``[1, ...]``), the matvec (``batched=True``
    builds the [B, n]-block variant), and the PlannerChoice.
    """
    from repro_torch.core.distributed import (
        make_distributed_batched_matvec, make_distributed_matvec,
    )
    from repro_torch.core.partition import partition
    from repro_torch.graphs.cost_model import candidate_space, parse_strategy, plan_for_graph
    from repro_torch.graphs.engine import edge_values

    strategy, balance = parse_strategy(strategy, balance)
    strategies, balances = candidate_space(strategy, balance)
    grid2d = (mesh.shape["dr"], mesh.shape["dc"])
    choice = plan_for_graph(graph, n_devices=mesh.n_devices, grid2d=grid2d,
                            kernel=kernel, frontier_density=frontier_density,
                            strategies=strategies, balances=balances)
    vals = edge_values(graph, sr, weighted, seed, normalize)
    fmt = fmt or ("csc" if kernel == "spmspv" else "csr")
    rows = graph.cols.astype(np.int64)   # transposed: pull from in-neighbours
    cols = graph.rows.astype(np.int64)
    # a rank builds its own part alone
    part = mesh.rank if isinstance(mesh, RankMesh) else None
    pm = partition(rows, cols, vals, choice.plan.shape, choice.grid, fmt, sr,
                   plan=choice.plan, device=mesh.device, part=part)
    if topology == "auto":
        topology, merge_order = choice.merge, choice.merge_order
    maker = make_distributed_batched_matvec if batched else make_distributed_matvec
    fn = maker(mesh, pm, sr, choice.strategy, kernel=kernel,
               topology=topology, merge_order=merge_order or "rc")
    return pm, fn, choice
