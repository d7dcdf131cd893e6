"""Traversal engine: builds matvec closures over a graph and runs the
adaptive SpMSpV↔SpMV iteration skeleton shared by BFS/SSSP/PPR (§4.2).

Apps are written against two closures (spmv_fn, spmspv_fn), both taking and
returning *dense* vectors; the SpMSpV branch compresses internally. The
JAX package's ``lax.cond``/``lax.switch`` become host branches on values
computed on the device, so each level costs a few host syncs.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import formats
from repro_torch.core.adaptive import (
    DecisionStump, adaptive_matvec, adaptive_matvec_batch, select_kernel,
)
from repro_torch.core.device import resolve_device
from repro_torch.core.semiring import Semiring
from repro_torch.core.spmspv import frontier_from_dense, spmspv, spmspv_batch, spmspv_batch_union
from repro_torch.core.spmv import spmv, spmv_batch
from repro_torch.graphs.datasets import Graph

Tensor = torch.Tensor
MatvecFn = Callable[[Tensor], Tensor]


@dataclasses.dataclass
class GraphEngine:
    """Per-(graph, semiring) state: the transposed adjacency in the formats
    the two kernels want, plus the adaptive switch threshold.

    ``spmv_batch_fn``/``spmspv_batch_fn`` are the [B, n]-block counterparts
    of the single-vector closures over the same adjacency, the substrate of
    the multi-source traversals in graphs/multi.py."""

    spmv_fn: MatvecFn
    spmspv_fn: MatvecFn
    n: int                 # padded vector length
    n_true: int
    threshold: float
    graph_class: str
    sr: Semiring
    device: torch.device
    spmv_batch_fn: MatvecFn | None = None
    spmspv_batch_fn: MatvecFn | None = None

    def adaptive_fn(self, x: Tensor, density: Tensor) -> Tensor:
        """One adaptive matvec: SpMV above the density threshold else SpMSpV."""
        return adaptive_matvec(self.spmspv_fn, self.spmv_fn, x, density, self.threshold)

    def step_fn(self, policy: str) -> Callable[[Tensor, Tensor], Tensor]:
        if policy == "spmv":
            return lambda x, _d: self.spmv_fn(x)
        if policy == "spmspv":
            return lambda x, _d: self.spmspv_fn(x)
        if policy == "adaptive":
            return self.adaptive_fn
        raise ValueError(policy)

    def adaptive_batch_fn(self, xs: Tensor, densities: Tensor) -> Tensor:
        """Per-query adaptive matvec over a [B, n] block (see
        core.adaptive.adaptive_matvec_batch)."""
        return adaptive_matvec_batch(self.spmspv_batch_fn, self.spmv_batch_fn, xs, densities,
                                     self.threshold, zero=self.sr.zero)

    def batch_step_fn(self, policy: str) -> Callable[[Tensor, Tensor], Tensor]:
        """[B, n]-block counterpart of step_fn: fn(xs, densities) -> ys.
        The function holds the batched closures and the threshold, not the
        engine, so the runners graphs/multi.py caches in the engine make no
        reference cycle: the engine and its matrices are freed as soon as
        the last reference to the engine goes."""
        mv, msv = self.spmv_batch_fn, self.spmspv_batch_fn
        if mv is None or msv is None:
            raise ValueError("engine was built without batched closures")
        if policy == "spmv":
            return lambda xs, _d: mv(xs)
        if policy == "spmspv":
            return lambda xs, _d: msv(xs)
        if policy == "adaptive":
            threshold, zero = self.threshold, self.sr.zero
            return lambda xs, d: adaptive_matvec_batch(msv, mv, xs, d, threshold, zero=zero)
        raise ValueError(policy)


def content_keyed_weights(rows: np.ndarray, cols: np.ndarray,
                          seed: int = 0) -> np.ndarray:
    """Deterministic per-edge weights in {1..9} keyed on the edge's
    endpoints (splitmix-style integer hash), so untouched edges keep their
    weights across graph snapshots."""
    seed_mix = np.uint64((seed * 0xD6E8FEB86659FD93) % (1 << 64))
    h = (np.asarray(rows, np.uint64) * np.uint64(0x9E3779B97F4A7C15)
         ^ np.asarray(cols, np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F)
         ^ seed_mix)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(29)
    return (1 + (h % np.uint64(9))).astype(np.float32)


def edge_values(g: Graph, sr: Semiring, weighted: bool, seed: int = 0,
                normalize: bool = False,
                content_keyed: bool = False) -> np.ndarray:
    if sr.name == "bool_or_and":
        return np.ones(g.nnz, np.int32)
    if weighted:
        if content_keyed:
            vals = content_keyed_weights(g.rows, g.cols, seed)
        else:
            rng = np.random.default_rng(seed)
            vals = rng.integers(1, 10, g.nnz).astype(np.float32)
    else:
        vals = np.ones(g.nnz, np.float32)
    if normalize:  # column-stochastic for PPR: weight(u→v) = 1/outdeg(u)
        deg = np.maximum(g.out_degrees(), 1)
        vals = vals / deg[g.rows]
    return vals


def build_engine(g: Graph, sr: Semiring, stump: DecisionStump | None = None,
                 fmt_spmv: str = "csr", fmt_spmspv: str = "csc",
                 weighted: bool = False, normalize: bool = False,
                 seed: int = 0, f_max: int | None = None,
                 content_keyed: bool = False, device=None) -> GraphEngine:
    """Build single-device closures over the *transposed* adjacency
    (traversals compute y = Aᵀ ⊕.⊗ x: pull from in-neighbours), on
    ``device`` (the CUDA card unless named). With ``fmt_spmv ==
    fmt_spmspv`` the matrix is built once and shared by both closures."""
    device = resolve_device(device)
    stump = stump or DecisionStump()
    vals = edge_values(g, sr, weighted, seed, normalize, content_keyed)
    rows, cols = g.cols.astype(np.int32), g.rows.astype(np.int32)
    shape = (g.n, g.n)

    def build(fmt):
        if fmt == "coo":
            return formats.build_coo(rows, cols, vals, shape, sr, device=device)
        if fmt == "csr":
            return formats.build_csr(rows, cols, vals, shape, sr, device=device)
        if fmt == "csc":
            return formats.build_csc(rows, cols, vals, shape, sr, device=device)
        if fmt == "bsr":
            return formats.build_bsr_padded(rows, cols, vals, shape, sr,
                                            block=(128, 128), device=device)
        raise ValueError(fmt)

    a_mv = build(fmt_spmv)
    a_msv = a_mv if fmt_spmspv == fmt_spmv else build(fmt_spmspv)
    n_pad = max(a_mv.shape[0], a_msv.shape[0])

    def spmv_fn(x: Tensor) -> Tensor:
        xp = _pad(x, a_mv.shape[1], sr)
        return _pad(spmv(a_mv, xp, sr)[: shape[0]], n_pad, sr)

    # Frontier capacity ladder, as in the JAX package (there it keeps
    # SpMSpV's work tracking the density under static shapes): the rung is
    # the smallest capacity that holds the live count, read on the host.
    if f_max:
        buckets = [min(f_max, g.n)]
    else:
        buckets = sorted({max(64, g.n // 16), max(128, g.n // 4), g.n})

    def msv_at(fmax):
        def fn(x: Tensor) -> Tensor:
            f = frontier_from_dense(x[: shape[1]], sr, f_max=fmax)
            y = spmspv(a_msv, f, sr)
            return _pad(y[: shape[0]], n_pad, sr)
        return fn

    branches = [msv_at(b) for b in buckets]

    def spmspv_fn(x: Tensor) -> Tensor:
        if len(branches) == 1:
            return branches[0](x)
        nnz = int((x[: shape[1]] != sr.zero).sum())
        sel = min(bisect.bisect_left(buckets, nnz), len(branches) - 1)
        return branches[sel](x)

    # Batched closures. The capacity ladder survives batching as ONE rung
    # for the whole block: the rung's capacity covers every row, so each
    # row's result is the vector the single-source ladder gives it. CSC
    # engines take the union-frontier path (one shared column gather and
    # one B-lane ⊕-segment-reduce, core.spmspv.spmspv_batch_union) keyed
    # on the union's live count; other formats (the tile route: kernels 1
    # and 2 over the block) are keyed on the largest live count of any row.
    def spmv_batch_fn(xs: Tensor) -> Tensor:
        xp = _pad_cols(xs, a_mv.shape[1], sr)
        return _pad_cols(spmv_batch(a_mv, xp, sr)[:, : shape[0]], n_pad, sr)

    use_union = isinstance(a_msv, formats.CSCMatrix)
    elementwise_mv = isinstance(a_mv, (formats.COOMatrix, formats.CSRMatrix))

    def msv_batch_at(fmax):
        if not use_union:
            def fn(xs: Tensor) -> Tensor:
                y = spmspv_batch(a_msv, xs[:, : shape[1]], sr, f_max=fmax)
                return _pad_cols(y[:, : shape[0]], n_pad, sr)
            return fn
        # The paper's work model, per rung: a capacity-fmax CSC gather
        # touches fmax · max_col_nnz slots; once that reaches the matrix's
        # nnz, the dense-input SpMV computes the same vector for less work.
        # Union frontiers densify B times faster than single ones, so a
        # batched ladder crosses over on rungs a single source runs sparse.
        if fmax * a_msv.max_col_nnz >= g.nnz and elementwise_mv:
            return spmv_batch_fn

        def fn(xs: Tensor) -> Tensor:
            y = spmspv_batch_union(a_msv, xs[:, : shape[1]], sr, f_max=fmax)
            return _pad_cols(y[:, : shape[0]], n_pad, sr)
        return fn

    batch_branches = [msv_batch_at(b) for b in buckets]

    def spmspv_batch_fn(xs: Tensor) -> Tensor:
        if len(batch_branches) == 1:
            return batch_branches[0](xs)
        live = xs[:, : shape[1]] != sr.zero
        if use_union:
            nnz = int(live.any(dim=0).sum())
        else:
            nnz = int(live.sum(dim=1).max()) if xs.shape[0] else 0
        sel = min(bisect.bisect_left(buckets, nnz), len(batch_branches) - 1)
        return batch_branches[sel](xs)

    feats = g.features()
    return GraphEngine(
        spmv_fn=spmv_fn,
        spmspv_fn=spmspv_fn,
        n=n_pad,
        n_true=g.n,
        threshold=stump.switch_threshold(feats),
        graph_class=stump.classify(feats),
        sr=sr,
        device=device,
        spmv_batch_fn=spmv_batch_fn,
        spmspv_batch_fn=spmspv_batch_fn,
    )


def calibrate_threshold(engine: GraphEngine, probe_densities=(0.01, 0.05,
                        0.2, 0.5), iters: int = 3) -> float:
    """Measured switch point: times both kernels on the engine's device at a
    few densities and returns the highest density at which SpMSpV still
    wins (0.0 if it never does)."""
    rng = np.random.default_rng(0)

    def sync():
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)

    def t(fn, x):
        fn(x)
        sync()
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(x)
            sync()
            ts.append(time.perf_counter() - t0)
        return min(ts)

    last_spmspv_win = 0.0
    for d in sorted(probe_densities):
        nz = rng.random(engine.n) < d
        if engine.sr.name == "min_plus":
            xv = np.where(nz, rng.random(engine.n), np.inf).astype(np.float32)
        else:
            xv = (nz * rng.random(engine.n)).astype(np.float32)
        x = torch.from_numpy(xv).to(engine.device).to(engine.sr.dtype)
        if t(engine.spmspv_fn, x) < t(engine.spmv_fn, x):
            last_spmspv_win = d
    return last_spmspv_win


def _pad(x: Tensor, n: int, sr: Semiring) -> Tensor:
    if x.shape[0] == n:
        return x
    if x.shape[0] > n:
        return x[:n]
    return torch.nn.functional.pad(x, (0, n - x.shape[0]), value=sr.zero)


def _pad_cols(xs: Tensor, n: int, sr: Semiring) -> Tensor:
    """[B, m] -> [B, n]: slice or ⊕-zero-pad the trailing axis."""
    if xs.shape[1] == n:
        return xs
    if xs.shape[1] > n:
        return xs[:, :n]
    return torch.nn.functional.pad(xs, (0, n - xs.shape[1]), value=sr.zero)


def density_of(x: Tensor, sr: Semiring, n_true: int) -> Tensor:
    """Live fraction of the first n_true entries, as a 0-dim f32 tensor on
    x's device: the live count times the f32 reciprocal of n_true. That is
    the arithmetic XLA compiles the JAX package's traversal loops to (it
    turns the division by a constant into this product), and it can differ
    from the quotient in the last bit, which moves the kernel switch at the
    threshold. Written out so that CPU and CUDA compute the same."""
    nz = (x[:n_true] != sr.zero).to(torch.int32).sum()
    recip = 1.0 / torch.tensor(float(n_true), dtype=torch.float32, device=x.device)
    return nz.to(torch.float32) * recip


def density_of_batch(xs: Tensor, sr: Semiring, n_true: int) -> Tensor:
    """Per-row frontier densities of a [B, n] block -> [B] f32, with
    ``density_of``'s arithmetic: the live count times the f32 reciprocal of
    n_true."""
    nz = (xs[:, :n_true] != sr.zero).to(torch.int32).sum(dim=1)
    recip = 1.0 / torch.tensor(float(n_true), dtype=torch.float32, device=xs.device)
    return nz.to(torch.float32) * recip


def kernel_code(policy: str, density: Tensor, threshold: float) -> Tensor:
    """The kernel a level runs under ``policy``, as a 0-dim int32 tensor on
    the density's device: 0 = SpMSpV, 1 = SpMV."""
    if policy == "spmv":
        return torch.ones((), dtype=torch.int32, device=density.device)
    if policy == "spmspv":
        return torch.zeros((), dtype=torch.int32, device=density.device)
    return select_kernel(density, threshold)
