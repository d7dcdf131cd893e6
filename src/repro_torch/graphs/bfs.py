"""Breadth-First Search over the ⟨∨,∧⟩ semiring (paper §5.1, Table 1).

Level-synchronous pull BFS: fₖ₊₁ = (Aᵀ ⊕.⊗ fₖ) ∧ ¬visited. The frontier
density is read every level and the adaptive policy switches SpMSpV→SpMV
once it crosses the decision-tree threshold (§4.2). The JAX package's
``lax.while_loop`` is a host loop here; each level syncs once for the
stopping test (plus the kernel choice and the capacity rung).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.semiring import BOOL_OR_AND
from repro_torch.graphs.engine import GraphEngine, density_of, kernel_code

Tensor = torch.Tensor


class BFSResult(NamedTuple):
    levels: Tensor      # int32 [n]; -1 = unreached
    iterations: int
    densities: Tensor   # f32 [max_iters] frontier density trace (Fig 4)
    kernel_used: Tensor  # int32 [max_iters]; 0 = SpMSpV, 1 = SpMV, -1 = unused


def bfs(engine: GraphEngine, source: int, max_iters: int = 64,
        policy: str = "adaptive") -> BFSResult:
    sr = engine.sr
    if sr.name != BOOL_OR_AND.name:
        raise ValueError(f"bfs needs the {BOOL_OR_AND.name} semiring, not {sr.name}")
    n, dev = engine.n, engine.device
    step = engine.step_fn(policy)

    frontier = torch.zeros(n, dtype=sr.dtype, device=dev)
    frontier[source] = 1
    visited = torch.zeros(n, dtype=torch.int32, device=dev)
    visited[source] = 1
    levels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    levels[source] = 0
    dens = torch.full((max_iters,), -1.0, dtype=torch.float32, device=dev)
    kern = torch.full((max_iters,), -1, dtype=torch.int32, device=dev)

    it, done = 0, False
    while not done and it < max_iters:
        density = density_of(frontier, sr, engine.n_true)
        kern[it] = kernel_code(policy, density, engine.threshold)
        dens[it] = density
        y = step(frontier, density)
        frontier = ((y != sr.zero) & (visited == 0)).to(sr.dtype)
        levels = torch.where((frontier != 0) & (levels < 0), it + 1, levels)
        visited = torch.where(frontier != 0, 1, visited)
        done = not bool(frontier.any())
        it += 1
    return BFSResult(levels[: engine.n_true], it, dens, kern)


def bfs_reference(rows: np.ndarray, cols: np.ndarray, n: int, source: int) -> np.ndarray:
    """CPU oracle: classic queue BFS over the directed edge list."""
    adj_ptr = np.zeros(n + 1, np.int64)
    np.add.at(adj_ptr, rows + 1, 1)
    adj_ptr = np.cumsum(adj_ptr)
    order = np.argsort(rows, kind="stable")
    adj = cols[order]
    levels = np.full(n, -1, np.int32)
    levels[source] = 0
    q = [source]
    while q:
        nq = []
        for u in q:
            for v in adj[adj_ptr[u]: adj_ptr[u + 1]]:
                if levels[v] < 0:
                    levels[v] = levels[u] + 1
                    nq.append(int(v))
        q = nq
    return levels
