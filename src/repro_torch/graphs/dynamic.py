"""Streaming graph updates: versioned snapshots and incremental recompute.

PyTorch counterpart of ``repro.graphs.dynamic``. Recomputing from scratch
on every edge change ships the whole graph through the kernels again for a
delta that touched a handful of vertices (the paper's §5 data-movement
accounting). This module re-derives the new snapshot's answers from the
delta instead, equal to a cold run:

* :class:`DynamicGraph`: a store over immutable canonical
  :class:`~repro_torch.graphs.datasets.Graph` snapshots. Each applied
  :class:`~repro_torch.core.delta.EdgeDelta` gives a new snapshot whose
  edge list is the one a from-scratch construction over the updated edge
  set builds, under a versioned fingerprint (``v<k>:<content-hash>``).
* BFS / SSSP: delta-frontier re-relaxation. Retained distances stay;
  vertices a deletion may have invalidated (everything in the new-graph
  components of deleted-edge endpoints, a sound superset) reset to +inf;
  re-relaxation seeds only from the touched vertices and the stale region
  (graphs/multi.py:relax_multi, the loop of cold SSSP). BFS runs the same
  machinery over a unit-weight ⟨min,+⟩ engine: levels are unit distances,
  small integers, exact in f32.
* Connected components: old components containing a deleted-edge
  endpoint reset to own-id labels, the rest keep theirs, then the
  min-label flood (graphs/analytics.py) converges.
* PageRank: warm restart from the previous rank vector
  (graphs/ppr.py:pagerank(r0=...)), the same fixpoint in fewer iterations.

Exactness needs edge values that are functions of the graph's content, not
of edge-list position: SSSP engines over delta snapshots are built with
``content_keyed=True`` (graphs/engine.py:content_keyed_weights).
``traffic_of`` counts the frontier elements each kernel call consumed, the
Load-phase currency the paper budgets. Results come back as numpy arrays
or as the runners' tensors, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.delta import (
    EdgeDelta, apply_edge_delta, canonicalize, touched_vertices,
)
from repro_torch.core.semiring import MIN_PLUS, MIN_TIMES
from repro_torch.graphs.analytics import CCResult, connected_components
from repro_torch.graphs.datasets import Graph
from repro_torch.graphs.engine import GraphEngine
from repro_torch.graphs.multi import SSSPBatchResult, relax_multi
from repro_torch.graphs.ppr import PPRResult, pagerank


def _np(a) -> np.ndarray:
    """A host numpy copy of a tensor on any device, or the array itself."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class DynamicGraph:
    """Versioned store over immutable Graph snapshots.

    ``apply(delta)`` advances to a new snapshot (set semantics, canonical
    edge order, see core/delta.py) and bumps the version; every snapshot
    handed out stays valid, so queries in flight keep running against the
    graph they were submitted under while new queries see the new one."""

    def __init__(self, graph: Graph, version: int = 0):
        self._graph = graph
        self.version = version

    @property
    def snapshot(self) -> Graph:
        return self._graph

    @property
    def fingerprint(self) -> str:
        """Versioned content fingerprint: the version orders successive
        fingerprints even across an apply/undo cycle that returns to an
        earlier edge set."""
        return f"v{self.version}:{self._graph.fingerprint()}"

    def apply(self, delta: EdgeDelta) -> Graph:
        """Apply one delta batch; returns (and switches to) the new
        immutable snapshot. A no-op delta still bumps the version."""
        rows, cols = apply_edge_delta(self._graph.rows, self._graph.cols, self._graph.n, delta)
        self._graph = dataclasses.replace(self._graph, rows=rows, cols=cols)
        self.version += 1
        return self._graph


def traffic_of(result) -> float:
    """Element traffic of one batched traversal: the frontier nonzeros the
    kernel consumed, summed over queries and iterations (the densities
    trace × the true vertex count)."""
    dens = _np(result.densities).astype(np.float64)
    n_true = None
    for field in ("levels", "dist", "rank"):   # the [B, n_true] payload
        arr = getattr(result, field, None)
        if arr is not None:
            n_true = arr.shape[-1]
            break
    if n_true is None:
        raise ValueError("result carries no per-vertex payload")
    return float(np.sum(np.where(dens >= 0, dens, 0.0)) * n_true)


class DeltaRepair(NamedTuple):
    """The delta's blast radius, computed once per (snapshot, delta) and
    shared by every incremental traversal that follows."""

    touched: np.ndarray        # sorted unique endpoints of the delta
    stale: np.ndarray | None   # bool [n_true] possibly-invalidated set
    traffic: float             # reachability-pass element traffic


def plan_repair(engine: GraphEngine, delta: EdgeDelta,
                max_iters: int | None = None) -> DeltaRepair:
    """The delta's repair plan against the **new** snapshot's ⟨min,+⟩
    engine (unit or weighted: only finiteness is read).

    Insert-only deltas invalidate nothing: old distances remain valid
    upper bounds, improvable only through the new edges. A deletion may
    invalidate any vertex whose old shortest path crossed a deleted edge;
    every such vertex lies in the new-graph component of some deleted-edge
    endpoint, so one multi-seed reachability relax from all deleted
    endpoints marks that superset."""
    if engine.sr.name != MIN_PLUS.name:
        raise ValueError(f"plan_repair needs a {MIN_PLUS.name} engine, not {engine.sr.name}")
    n_true = engine.n_true
    delta = canonicalize(delta, n_true)
    touched = touched_vertices(delta)
    if delta.n_deletes == 0:
        return DeltaRepair(touched, None, 0.0)
    seeds = np.unique(np.concatenate([delta.delete_rows, delta.delete_cols]))
    d0 = np.full((1, n_true), np.inf, np.float32)
    d0[0, seeds] = 0.0
    # the reach pass must run to its fixpoint (a truncated stale set would
    # leave invalid distances in place): cap at n_true, the hop bound
    res = relax_multi(engine, d0, d0.copy(), max_iters=max_iters or n_true)
    stale = np.isfinite(_np(res.dist[0]))
    return DeltaRepair(touched, stale, traffic_of(res))


class IncrementalTraversal(NamedTuple):
    values: np.ndarray         # levels int32 / dist f32, [B, n_true]
    result: SSSPBatchResult    # the relax result (iterations, traces)
    traffic: float             # relax traffic (the shared repair pass excluded)
    repair: DeltaRepair


def _incremental_relax(engine: GraphEngine, sources, old_dist: np.ndarray,
                       delta: EdgeDelta, repair: DeltaRepair | None,
                       max_iters: int, policy: str) -> IncrementalTraversal:
    """Shared BFS/SSSP delta-frontier re-relaxation: reset the stale
    region, restore the sources' zeros, seed ``changed`` from the touched
    vertices plus the stale region, relax to the fixpoint."""
    n_true = engine.n_true
    delta = canonicalize(delta, n_true)
    if repair is None:
        repair = plan_repair(engine, delta)
    d0 = np.array(old_dist, np.float32, copy=True)
    src = np.asarray(sources, np.int64).reshape(-1)
    if d0.ndim != 2 or d0.shape != (src.shape[0], n_true):
        raise ValueError(f"old values must be [{src.shape[0]}, {n_true}], got {d0.shape}")
    seed = np.zeros(n_true, bool)
    seed[repair.touched] = True
    if repair.stale is not None:
        d0[:, repair.stale] = np.inf
        seed |= repair.stale
    d0[np.arange(d0.shape[0]), src] = 0.0   # the source is right in every epoch
    changed0 = np.where(seed[None, :] & np.isfinite(d0), d0,
                        np.float32(np.inf)).astype(np.float32)
    res = relax_multi(engine, d0, changed0, max_iters=max_iters, policy=policy)
    return IncrementalTraversal(_np(res.dist), res, traffic_of(res), repair)


def sssp_incremental(engine: GraphEngine, sources, old_dist,
                     delta: EdgeDelta, repair: DeltaRepair | None = None,
                     max_iters: int = 64, policy: str = "adaptive"
                     ) -> IncrementalTraversal:
    """Incremental SSSP: ``old_dist`` [B, n_true] from the previous
    snapshot (+inf = unreachable), ``engine`` a **content-keyed** weighted
    ⟨min,+⟩ engine over the new snapshot. Equal to a cold sssp_multi on the
    new snapshot: the warm state is pointwise ≥ the fixpoint with every
    improvement reachable from a seeded vertex, and the ⟨min,+⟩ fixpoint
    over integer weights is unique and exact in f32."""
    return _incremental_relax(engine, sources, _np(old_dist), delta, repair, max_iters, policy)


def bfs_incremental(engine: GraphEngine, sources, old_levels,
                    delta: EdgeDelta, repair: DeltaRepair | None = None,
                    max_iters: int = 64, policy: str = "adaptive"
                    ) -> IncrementalTraversal:
    """Incremental BFS as unit-weight incremental SSSP: ``old_levels``
    [B, n_true] ints (-1 = unreached) from the previous snapshot,
    ``engine`` a unit-weight ⟨min,+⟩ engine (build_engine(g, MIN_PLUS,
    weighted=False)) over the new snapshot. ``values`` are BFS levels
    (int32, -1 unreached), equal to a cold bfs_multi on the new snapshot."""
    lev = _np(old_levels)
    old_dist = np.where(lev < 0, np.float32(np.inf), lev.astype(np.float32))
    out = _incremental_relax(engine, sources, old_dist, delta, repair, max_iters, policy)
    levels = np.where(np.isfinite(out.values), out.values, -1.0).astype(np.int32)
    return IncrementalTraversal(levels, out.result, out.traffic, out.repair)


def cc_incremental(engine: GraphEngine, old_labels, delta: EdgeDelta,
                   max_iters: int | None = None) -> CCResult:
    """Incremental connected-components label repair. Inserts only merge
    components, and min-flooding the old labels over the new graph resolves
    a merge exactly, so old labels flow through. Deletes can split: every
    old component containing a deleted-edge endpoint resets to own-id
    labels and recomputes. Untouched components are unchanged whole
    components, so the flood converges in rounds ~ the repaired region's
    radius, equal to the cold run (integer labels, exact in f32)."""
    if engine.sr.name != MIN_TIMES.name:
        raise ValueError(f"cc_incremental needs a {MIN_TIMES.name} engine, not {engine.sr.name}")
    n_true = engine.n_true
    delta = canonicalize(delta, n_true)
    labels = _np(old_labels)
    if labels.shape != (n_true,):
        raise ValueError(f"old_labels must have {n_true} entries, got {labels.shape}")
    if delta.n_deletes:
        cut = np.unique(np.concatenate([delta.delete_rows, delta.delete_cols]))
        stale = np.isin(labels, labels[cut])
        seed = np.where(stale, np.arange(n_true, dtype=labels.dtype), labels)
    else:
        seed = labels
    return connected_components(engine, max_iters=max_iters, labels0=seed)


def pagerank_warm(engine: GraphEngine, old_rank, alpha: float = 0.85,
                  max_iters: int = 50, tol: float = 1e-6,
                  policy: str = "spmv") -> PPRResult:
    """Warm-restart PageRank on the new snapshot from the previous rank
    vector: the fixpoint is a property of the graph, so starting near it
    (small deltas move it little) takes fewer iterations to the same ε."""
    return pagerank(engine, alpha=alpha, max_iters=max_iters, tol=tol,
                    policy=policy, r0=_np(old_rank))
