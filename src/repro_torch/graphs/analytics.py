"""Whole-graph analytics on the semiring engine (paper §5.1's application
families beyond frontier traversal).

PyTorch counterpart of ``repro.graphs.analytics``. Where BFS/SSSP/PPR push
a sparse frontier, these apps iterate over the *entire* vertex set (dense
vectors, SpMV every round) or multiply the adjacency by itself (masked
SpGEMM):

* ``connected_components`` — min-label flooding over ⟨min,×⟩:
  l ← l ⊕ (Aᵀ ⊕.⊗ l) until fixpoint; labels are component minima.
* ``pagerank``            — full power iteration over ⟨+,×⟩ (re-exported
  from graphs/ppr.py).
* ``triangle_count``      — C = (L ⊕.⊗ Lᵀ) ⊙ L over ⟨+,∧⟩ with L the
  strict lower triangle; Σ C counts each triangle once. On the tile route
  the product is the masked tile SpGEMM kernel.
* ``kcore``               — iterative degree peel via masked SpMV over
  ⟨+,×⟩.

The JAX package's ``while_loop``s are host loops here, with one host sync
per round, and give the same ``iterations``. Every app has the sequential
numpy reference of the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.core.device import resolve_device
from repro_torch.core.semiring import MIN_TIMES, PLUS_AND, PLUS_TIMES
from repro_torch.core.spgemm import spgemm_masked
from repro_torch.graphs.datasets import Graph
from repro_torch.graphs.engine import GraphEngine
from repro_torch.graphs.ppr import PPRResult, pagerank, pagerank_reference  # noqa: F401

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Connected components
# ---------------------------------------------------------------------------

class CCResult(NamedTuple):
    labels: Tensor        # int32 [n]; label = smallest vertex id in component
    n_components: Tensor  # 0-dim int32
    iterations: int


def connected_components(engine: GraphEngine, max_iters: int | None = None,
                         labels0=None) -> CCResult:
    """Min-label propagation: every vertex starts labelled with its own id
    (1-based: ⟨min,×⟩ operands must stay strictly positive) and repeatedly
    ⊕-absorbs its neighbours' labels, to the component minimum in
    O(diameter) rounds. The SpMV kernel runs every round.

    ``labels0`` seeds the flood with 0-based labels ([n_true] ints) instead
    of each vertex's own id (incremental label repair). The seed must be
    pointwise ≥ the true component minima with every merged region reset
    to own ids; then the fixpoint is the cold-start answer."""
    sr = engine.sr
    if sr.name != MIN_TIMES.name:
        raise ValueError(f"connected_components needs the {MIN_TIMES.name} semiring, "
                         f"not {sr.name}")
    n, n_true = engine.n, engine.n_true
    # labels live in the semiring's float32 domain: beyond 2^24 distinct
    # ids they would silently collide
    if n_true > 2 ** 24:
        raise ValueError(f"float32 labels cap CC at 2^24 vertices, got {n_true}")
    max_iters = max_iters or n_true
    dev = engine.device

    if labels0 is None:
        l0 = torch.arange(1, n_true + 1, dtype=sr.dtype, device=dev)
    else:
        seed = np.asarray(labels0)
        if seed.shape != (n_true,):
            raise ValueError(f"labels0 must have {n_true} entries, got {seed.shape}")
        l0 = torch.as_tensor(seed + 1, device=dev).to(sr.dtype)
    lab = torch.nn.functional.pad(l0, (0, n - n_true), value=sr.zero)

    it, done = 0, False
    while not done and it < max_iters:
        new = torch.minimum(lab, engine.spmv_fn(lab))
        done = torch.equal(new, lab)
        lab, it = new, it + 1
    labels = lab[:n_true].to(torch.int32) - 1
    n_components = (labels == torch.arange(n_true, dtype=torch.int32, device=dev)).sum()
    return CCResult(labels, n_components.to(torch.int32), it)


def cc_reference(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Sequential union-find; returns per-vertex min-id component labels."""
    parent = np.arange(n, dtype=np.int64)

    def find(v: int) -> int:
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:           # path compression
            parent[v], v = root, parent[v]
        return root

    for u, v in zip(rows.tolist(), cols.tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)  # min-id root ⇒ min-id label
    return np.array([find(v) for v in range(n)], dtype=np.int32)


# ---------------------------------------------------------------------------
# Triangle counting
# ---------------------------------------------------------------------------

class TriangleResult(NamedTuple):
    total: Tensor     # 0-dim int32 triangle count (int32, as the JAX package's)
    per_edge: Tensor  # int32 [n, n] masked wedge counts (C = L·Lᵀ ⊙ L)


def lower_triangle(g: Graph):
    """Strict lower triangle of the (symmetric) adjacency as an edge list."""
    sel = g.rows > g.cols
    return g.rows[sel].astype(np.int32), g.cols[sel].astype(np.int32)


def _dense_ones(rows: np.ndarray, cols: np.ndarray, shape: tuple[int, int],
                device: torch.device) -> Tensor:
    """int32 zeros of ``shape`` on ``device`` with ones at (rows, cols),
    written by one scatter there: no n × n array is built on the host."""
    out = torch.zeros(shape, dtype=torch.int32, device=device)
    out[torch.from_numpy(rows).to(device).long(), torch.from_numpy(cols).to(device).long()] = 1
    return out


def triangle_problem(g: Graph, impl: str = "csr", block: tuple[int, int] = (64, 64),
                     device=None):
    """The matrix-load phase: returns ``(a, b, mask, impl_kw)`` ready for
    spgemm_masked on ``device`` (the CUDA card unless named): L in the
    container ``impl`` selects ("csr", "bsr", "bsr_ref", "dense"), Lᵀ
    dense, and L itself dense as the structural mask."""
    if impl not in ("csr", "bsr", "bsr_ref", "dense"):
        raise ValueError(impl)
    device = resolve_device(device)
    sr = PLUS_AND
    n = g.n
    lr, lc = lower_triangle(g)
    ones = np.ones(lr.shape[0], np.int32)
    if impl == "csr":
        return (formats.build_csr(lr, lc, ones, (n, n), sr, device=device),
                _dense_ones(lc, lr, (n, n), device), _dense_ones(lr, lc, (n, n), device),
                "auto")
    if impl == "dense":
        mask = _dense_ones(lr, lc, (n, n), device)
        return mask, _dense_ones(lc, lr, (n, n), device), mask, "auto"
    a = formats.build_bsr_padded(lr, lc, ones, (n, n), sr, block=block, device=device)
    return (a, _dense_ones(lc, lr, (a.shape[1], n), device),
            _dense_ones(lr, lc, (a.shape[0], n), device),
            "ref" if impl == "bsr_ref" else "auto")


def triangle_count(g: Graph, impl: str = "csr", block: tuple[int, int] = (64, 64),
                   device=None) -> TriangleResult:
    """Masked SpGEMM triangle count: C[i,j] = |{k : k<j<i, (i,k),(j,k)∈E}|
    for every edge (i,j) of L, so ΣC counts each triangle (k<j<i) once.
    ``impl`` picks L's container: "csr" (element path), "bsr"/"bsr_ref"
    (the tile kernel / its plain version), "dense" (blocked reference)."""
    a, b, mask, impl_kw = triangle_problem(g, impl, block, device)
    c = spgemm_masked(a, b, PLUS_AND, mask, impl=impl_kw)[: g.n]
    # int32 like the JAX sum with x64 off; torch.sum widens to int64
    return TriangleResult(torch.sum(c).to(torch.int32), c)


def triangle_reference(rows: np.ndarray, cols: np.ndarray, n: int) -> int:
    """Sequential counter: per L-edge (i,j), intersect the lower-neighbour
    sets of i and j (the classic merge-based algorithm, int64-exact)."""
    lower: list[set] = [set() for _ in range(n)]
    for u, v in zip(rows.tolist(), cols.tolist()):
        if u > v:
            lower[u].add(v)
    total = 0
    for u in range(n):
        for v in lower[u]:
            total += len(lower[u] & lower[v])
    return total


# ---------------------------------------------------------------------------
# k-core decomposition
# ---------------------------------------------------------------------------

class KCoreResult(NamedTuple):
    coreness: Tensor   # int32 [n]; max k s.t. vertex survives the k-peel
    max_core: Tensor   # 0-dim int32
    iterations: int    # total SpMV peel rounds across all k


def kcore(engine: GraphEngine, max_k: int | None = None) -> KCoreResult:
    """Degree peel via masked SpMV over ⟨+,×⟩ with unit weights: one SpMV
    of the alive indicator gives every vertex its alive-degree; the alive
    mask filters the result; vertices under k drop and the peel repeats
    until stable (at least one round per k). Survivors get coreness k; k
    then increments until no vertex survives. One host sync per round
    reads both whether the round changed anything and whether any vertex
    is still alive."""
    sr = engine.sr
    if sr.name != PLUS_TIMES.name:
        raise ValueError(f"kcore needs the {PLUS_TIMES.name} semiring, not {sr.name}")
    n, n_true = engine.n, engine.n_true
    max_k = max_k or n_true
    dev = engine.device

    alive = torch.nn.functional.pad(torch.ones(n_true, dtype=sr.dtype, device=dev),
                                    (0, n - n_true), value=sr.zero)
    core = torch.zeros(n_true, dtype=torch.int32, device=dev)
    k, it, any_alive = 1, 0, n_true > 0
    while any_alive and k <= max_k:
        changed = True
        while changed:
            deg = engine.spmv_fn(alive)
            # `keep` both applies the alive mask and peels under-k vertices
            keep = (alive != 0) & (deg >= float(k))
            new_alive = torch.where(keep, alive, sr.zero)
            changed, any_alive = torch.stack([(new_alive != alive).any(),
                                              (new_alive != 0).any()]).tolist()
            alive, it = new_alive, it + 1
        core = torch.where(alive[:n_true] != 0, k, core)
        k += 1
    return KCoreResult(core, core.max(), it)


def kcore_reference(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Sequential peel with the same round structure (recompute alive
    degrees, drop everything under k, repeat; then k += 1)."""
    coreness = np.zeros(n, np.int32)
    alive = np.ones(n, bool)
    k = 1
    while alive.any():
        while True:
            sel = alive[rows] & alive[cols]
            deg = np.bincount(rows[sel], minlength=n)
            drop = alive & (deg < k)
            if not drop.any():
                break
            alive &= ~drop
        coreness[alive] = k
        k += 1
    return coreness
