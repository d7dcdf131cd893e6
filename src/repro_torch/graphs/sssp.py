"""Single-Source Shortest Path over the ⟨min,+⟩ semiring (Table 1).

Bellman-Ford with frontier pruning: each iteration relaxes only from
vertices whose distance changed last round (the sparse frontier), i.e.
cand = Aᵀ ⊕.⊗ changed, dist' = min(dist, cand). The changed-set density
drives the adaptive SpMSpV↔SpMV switch exactly as in BFS.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.semiring import MIN_PLUS
from repro_torch.graphs.engine import GraphEngine, density_of, kernel_code

Tensor = torch.Tensor


class SSSPResult(NamedTuple):
    dist: Tensor        # f32 [n]; +inf = unreachable
    iterations: int
    densities: Tensor
    kernel_used: Tensor


def sssp(engine: GraphEngine, source: int, max_iters: int = 64,
         policy: str = "adaptive") -> SSSPResult:
    sr = engine.sr
    if sr.name != MIN_PLUS.name:
        raise ValueError(f"sssp needs the {MIN_PLUS.name} semiring, not {sr.name}")
    n, dev = engine.n, engine.device
    step = engine.step_fn(policy)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)

    dist = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    dist[source] = 0.0
    changed = dist.clone()
    dens = torch.full((max_iters,), -1.0, dtype=torch.float32, device=dev)
    kern = torch.full((max_iters,), -1, dtype=torch.int32, device=dev)

    it, done = 0, False
    while not done and it < max_iters:
        density = density_of(changed, sr, engine.n_true)
        kern[it] = kernel_code(policy, density, engine.threshold)
        dens[it] = density
        cand = step(changed, density)          # cand[v] = min_u changed[u] + w(u,v)
        new_dist = torch.minimum(dist, cand)
        changed = torch.where(new_dist < dist, new_dist, inf)
        dist = new_dist
        done = not bool((changed != inf).any())
        it += 1
    return SSSPResult(dist[: engine.n_true], it, dens, kern)


def sssp_reference(rows: np.ndarray, cols: np.ndarray, weights: np.ndarray,
                   n: int, source: int) -> np.ndarray:
    """CPU oracle: scipy Dijkstra on the directed weighted edge list."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    a = sp.csr_matrix((weights, (rows, cols)), shape=(n, n))
    return csgraph.dijkstra(a, indices=source, directed=True)
