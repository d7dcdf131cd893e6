"""Edge-delta batches for streaming graph updates.

A copy of the JAX package's ``repro.core.delta``, which uses numpy only:
the port keeps its own.

ALPHA-PIM's bottom line is that graph workloads live and die by data
movement (§5): the Load/Retrieve phases dominate, so the bytes shipped to
the compute cores are the budget. A *static* store spends that budget in
the worst way on every edge change — full re-ingest, full re-partition,
cold recompute. This module is the arithmetic of doing better: a batched
edge delta (:class:`EdgeDelta`) plus exact set-algebra helpers that turn
"the graph changed" into "these edges appeared, these disappeared, these
vertices were touched" — the inputs every incremental path upstream
(graphs/dynamic.py re-relaxation, core/partition.py plan repair,
serve/graph_engine.py selective cache invalidation) keys off.

Canonical form matches graphs/datasets.py exactly: directed edge lists
with both directions present, no self loops, no duplicates, sorted by
``row * n + col`` (the ``_dedup`` key order). Applying a canonicalized
delta to a canonical edge list therefore yields bit-for-bit the edge list
a from-scratch datasets-style construction over the updated edge set
would produce.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _as_idx(a) -> np.ndarray:
    return np.asarray(a, dtype=np.int64).reshape(-1)


def edge_keys(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Sorted unique ``row * n + col`` keys — the datasets._dedup order."""
    return np.unique(_as_idx(rows) * n + _as_idx(cols))


def keys_to_edges(keys: np.ndarray, n: int):
    """Inverse of :func:`edge_keys`: (rows, cols) int32, key-sorted."""
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """One batch of undirected edge mutations in COO form.

    ``insert_*``/``delete_*`` list the edges as the *user* states them —
    one direction, possibly with duplicates or self loops.
    :func:`canonicalize` applies the datasets.py conventions (drop self
    loops, add both directions, dedup) before any set algebra runs, so a
    delta is interpreted exactly the way a from-scratch construction
    would interpret the same edge list. Set semantics throughout:
    inserting a present edge and deleting an absent one are no-ops.
    """

    insert_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    insert_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    delete_rows: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    delete_cols: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))

    def __post_init__(self):
        for name in ("insert_rows", "insert_cols", "delete_rows",
                     "delete_cols"):
            object.__setattr__(self, name, _as_idx(getattr(self, name)))
        if (self.insert_rows.shape != self.insert_cols.shape
                or self.delete_rows.shape != self.delete_cols.shape):
            raise ValueError("row/col arrays of a delta must pair up")

    @property
    def n_inserts(self) -> int:
        return int(self.insert_rows.shape[0])

    @property
    def n_deletes(self) -> int:
        return int(self.delete_rows.shape[0])


def _symmetric_keys(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Canonical directed-key set of an undirected edge list: both
    directions, self loops dropped, deduped (datasets._symmetrize)."""
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    sel = r != c
    if not sel.any():
        return np.zeros(0, np.int64)
    return edge_keys(r[sel], c[sel], n)


def canonicalize(delta: EdgeDelta, n: int) -> EdgeDelta:
    """Delta with both edge sets in canonical directed form. Indices must
    lie in ``[0, n)`` (the vertex set is fixed; deltas mutate edges)."""
    for a in (delta.insert_rows, delta.insert_cols,
              delta.delete_rows, delta.delete_cols):
        if a.size and (a.min() < 0 or a.max() >= n):
            raise ValueError(f"delta vertex ids must be in [0, {n})")
    ins = _symmetric_keys(delta.insert_rows, delta.insert_cols, n)
    dels = _symmetric_keys(delta.delete_rows, delta.delete_cols, n)
    ir, ic = keys_to_edges(ins, n)
    dr, dc = keys_to_edges(dels, n)
    return EdgeDelta(ir, ic, dr, dc)


def apply_edge_delta(rows: np.ndarray, cols: np.ndarray, n: int,
                     delta: EdgeDelta):
    """Apply one delta to a canonical edge list: deletes, then inserts,
    set-semantically. Returns (rows, cols) int32 in canonical key order —
    identical to rebuilding from scratch over the updated edge set."""
    d = canonicalize(delta, n)
    keys = edge_keys(rows, cols, n)
    if d.n_deletes:
        keys = np.setdiff1d(
            keys, edge_keys(d.delete_rows, d.delete_cols, n),
            assume_unique=True)
    if d.n_inserts:
        keys = np.union1d(keys, edge_keys(d.insert_rows, d.insert_cols, n))
    return keys_to_edges(keys, n)


def edge_diff(rows0: np.ndarray, cols0: np.ndarray,
              rows1: np.ndarray, cols1: np.ndarray, n: int) -> EdgeDelta:
    """The *effective* canonical delta between two edge lists: edges of
    graph1 absent from graph0 as inserts, edges of graph0 absent from
    graph1 as deletes. Folding several deltas and diffing snapshots drops
    every no-op (insert-existing / delete-absent / insert-then-delete), so
    downstream consumers (cache invalidation, plan repair) only ever see
    edges that actually changed."""
    k0 = edge_keys(rows0, cols0, n)
    k1 = edge_keys(rows1, cols1, n)
    ins = np.setdiff1d(k1, k0, assume_unique=True)
    dels = np.setdiff1d(k0, k1, assume_unique=True)
    ir, ic = keys_to_edges(ins, n)
    dr, dc = keys_to_edges(dels, n)
    return EdgeDelta(ir, ic, dr, dc)


def touched_vertices(delta: EdgeDelta) -> np.ndarray:
    """Sorted unique endpoints of every edge in the delta — the vertices
    incremental recompute must treat as potentially stale."""
    return np.unique(np.concatenate([
        delta.insert_rows, delta.insert_cols,
        delta.delete_rows, delta.delete_cols])).astype(np.int64)
