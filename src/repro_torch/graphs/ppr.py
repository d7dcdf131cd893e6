"""Personalized PageRank over ⟨+,×⟩ (Table 1).

Power iteration on the column-stochastic matrix P = Aᵀ D⁻¹:
    r ← (1−α)·e_s + α·(P ⊕.⊗ r)
The personalization vector e_s is a single vertex, so r starts maximally
sparse and densifies over iterations: the paper's motivating case for
adaptive SpMSpV→SpMV switching in PPR. The update keeps the JAX package's
f32 arithmetic: Python scalars times f32 tensors, never float64.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.semiring import PLUS_TIMES
from repro_torch.graphs.engine import GraphEngine, density_of, kernel_code

Tensor = torch.Tensor


class PPRResult(NamedTuple):
    rank: Tensor
    iterations: int
    densities: Tensor
    kernel_used: Tensor
    residual: Tensor


def _power_iteration(engine: GraphEngine, teleport: Tensor, start: Tensor,
                     alpha: float, max_iters: int, tol: float,
                     policy: str) -> PPRResult:
    """r ← (1−α)·teleport + α·(P ⊕.⊗ r) from ``start`` until the L1 change
    is at most ``tol`` (compared in f32 on the device) or max_iters."""
    sr = engine.sr
    if sr.name != PLUS_TIMES.name:
        raise ValueError(f"ppr needs the {PLUS_TIMES.name} semiring, not {sr.name}")
    dev = engine.device
    step = engine.step_fn(policy)
    tol_t = torch.tensor(tol, dtype=torch.float32, device=dev)
    dens = torch.full((max_iters,), -1.0, dtype=torch.float32, device=dev)
    kern = torch.full((max_iters,), -1, dtype=torch.int32, device=dev)

    r, it = start, 0
    res = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    while it < max_iters and bool(res > tol_t):
        density = density_of(r, sr, engine.n_true)
        kern[it] = kernel_code(policy, density, engine.threshold)
        dens[it] = density
        pr = step(r, density)
        r_new = (1.0 - alpha) * teleport + alpha * pr
        res = torch.sum(torch.abs(r_new - r))
        r = r_new
        it += 1
    return PPRResult(r[: engine.n_true], it, dens, kern, res)


def ppr(engine: GraphEngine, source: int, alpha: float = 0.85,
        max_iters: int = 50, tol: float = 1e-6,
        policy: str = "adaptive") -> PPRResult:
    e_s = torch.zeros(engine.n, dtype=torch.float32, device=engine.device)
    e_s[source] = 1.0
    return _power_iteration(engine, e_s, e_s, alpha, max_iters, tol, policy)


def pagerank(engine: GraphEngine, alpha: float = 0.85, max_iters: int = 50,
             tol: float = 1e-6, policy: str = "spmv",
             r0=None) -> PPRResult:
    """Global PageRank, uniform teleport. r starts dense (1/n everywhere),
    so SpMV is the natural kernel for the whole run. ``r0`` ([n_true])
    warm-starts the iteration from a previous rank vector."""
    e = torch.full((engine.n,), 1.0 / engine.n_true, dtype=torch.float32,
                   device=engine.device)
    e[engine.n_true:] = 0.0
    if r0 is None:
        start = e
    else:
        r0 = torch.as_tensor(np.asarray(r0, np.float32), device=engine.device)
        if tuple(r0.shape) != (engine.n_true,):
            raise ValueError(f"r0 must have {engine.n_true} entries, got {tuple(r0.shape)}")
        start = torch.nn.functional.pad(r0, (0, engine.n - engine.n_true))
    return _power_iteration(engine, e, start, alpha, max_iters, tol, policy)


def _transition(rows: np.ndarray, cols: np.ndarray, n: int, sparse: bool):
    """P = Aᵀ D⁻¹ in float64, dense or as a scipy CSR matrix."""
    deg = np.maximum(np.bincount(rows, minlength=n), 1).astype(np.float64)
    if sparse:
        import scipy.sparse as sp

        return sp.csr_matrix((1.0 / deg[rows], (cols, rows)), shape=(n, n))
    p = np.zeros((n, n))
    p[cols, rows] = 1.0 / deg[rows]
    return p


def pagerank_reference(rows: np.ndarray, cols: np.ndarray, n: int,
                       alpha: float = 0.85, iters: int = 50,
                       sparse: bool = False) -> np.ndarray:
    """numpy oracle in float64; ``sparse=True`` holds P in a scipy CSR
    matrix instead of the JAX package's dense n×n one, as ppr_reference."""
    p = _transition(rows, cols, n, sparse)
    e = np.full(n, 1.0 / n)
    r = e.copy()
    for _ in range(iters):
        r_new = (1 - alpha) * e + alpha * (p @ r)
        if np.abs(r_new - r).sum() <= 1e-6:
            return r_new
        r = r_new
    return r


def ppr_reference(rows: np.ndarray, cols: np.ndarray, n: int, source: int,
                  alpha: float = 0.85, iters: int = 50, sparse: bool = False) -> np.ndarray:
    """numpy oracle: the same power iteration in float64. The dense n×n
    matrix is the JAX package's form; ``sparse=True`` holds P in a scipy
    CSR matrix instead, for graphs whose dense matrix does not fit."""
    p = _transition(rows, cols, n, sparse)
    e = np.zeros(n)
    e[source] = 1.0
    r = e.copy()
    for _ in range(iters):
        r_new = (1 - alpha) * e + alpha * (p @ r)
        if np.abs(r_new - r).sum() <= 1e-6:
            r = r_new
            break
        r = r_new
    return r
