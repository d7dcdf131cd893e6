"""Adaptive SpMSpV↔SpMV switching (paper §4.2).

1. Offline, a decision stump classifies the graph from its average degree
   and degree std-dev into *regular* or *scale-free* (§4.2.1).
2. The class fixes the switch threshold: regular 20% input-vector density,
   scale-free 50%.
3. At run time the traversal reads the frontier density each iteration and
   runs SpMV once it exceeds the threshold. The density and the comparison
   are computed on the device in f32, as in the JAX package; the host reads
   only the boolean, to pick the branch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor

REGULAR_THRESHOLD = 0.20     # paper §4.2.1 observation ①
SCALE_FREE_THRESHOLD = 0.50  # paper §4.2.1 observation ②


@dataclasses.dataclass(frozen=True)
class GraphFeatures:
    avg_degree: float
    degree_std: float

    @staticmethod
    def from_degrees(deg: np.ndarray) -> "GraphFeatures":
        return GraphFeatures(float(deg.mean()), float(deg.std()))


@dataclasses.dataclass(frozen=True)
class DecisionStump:
    """Axis-aligned one-split tree over (avg_degree, degree_std, their ratio)."""

    feature: str = "cv"          # "avg", "std" or "cv"
    threshold: float = 1.0
    left_class: str = "regular"  # feature <= threshold
    right_class: str = "scale_free"

    def classify(self, f: GraphFeatures) -> str:
        val = {"avg": f.avg_degree, "std": f.degree_std,
               "cv": f.degree_std / max(f.avg_degree, 1e-9)}[self.feature]
        return self.left_class if val <= self.threshold else self.right_class

    def switch_threshold(self, f: GraphFeatures) -> float:
        return (REGULAR_THRESHOLD if self.classify(f) == "regular"
                else SCALE_FREE_THRESHOLD)


def fit_decision_stump(features: list[GraphFeatures], labels: list[str]) -> DecisionStump:
    """Tiny CART: exhaustive search over the three 1-D features for the split
    minimizing misclassification on the training corpus."""
    feats = {
        "avg": np.array([f.avg_degree for f in features]),
        "std": np.array([f.degree_std for f in features]),
        "cv": np.array([f.degree_std / max(f.avg_degree, 1e-9) for f in features]),
    }
    y = np.array([1 if lab == "scale_free" else 0 for lab in labels])
    best = (np.inf, None)
    for name, vals in feats.items():
        cand = np.unique(vals)
        thresholds = (cand[:-1] + cand[1:]) / 2 if cand.size > 1 else cand
        for t in thresholds:
            pred = (vals > t).astype(int)
            err = np.minimum((pred != y).sum(), (1 - pred != y).sum())
            if err < best[0]:
                flip = (pred != y).sum() > (1 - pred != y).sum()
                best = (err, DecisionStump(
                    feature=name, threshold=float(t),
                    left_class="scale_free" if flip else "regular",
                    right_class="regular" if flip else "scale_free"))
    if best[1] is None:
        raise ValueError("empty training corpus")
    return best[1]


def above_threshold(density: Tensor, threshold: float) -> Tensor:
    """``density > threshold`` on the density's device, compared in f32 (a
    Python-double comparison flips at the boundary)."""
    return density > torch.tensor(threshold, dtype=torch.float32, device=density.device)


def select_kernel(density: Tensor, threshold: float) -> Tensor:
    """0 = SpMSpV, 1 = SpMV, as an int32 tensor on the density's device."""
    return above_threshold(density, threshold).to(torch.int32)


def select_kernel_batch(densities: Tensor, threshold: float) -> Tensor:
    """Per-query kernel codes over a batch: [B] int32, 0 = SpMSpV, 1 = SpMV."""
    return above_threshold(densities, threshold).to(torch.int32)


def adaptive_matvec_batch(
    spmspv_batch_fn: Callable[[Tensor], Tensor],
    spmv_batch_fn: Callable[[Tensor], Tensor],
    x_block: Tensor,
    densities: Tensor,
    threshold: float,
    zero=0,
) -> Tensor:
    """One adaptive iteration over a [B, n] frontier block with a per-query
    kernel choice. The JAX package's three-way ``lax.switch`` is a host
    branch on one count read from the device: every row below the
    threshold runs the sparse kernel once, every row above runs SpMV once,
    and only a mixed block runs both and selects per row. Each row gets
    what the unbatched switch gives it.

    ``zero`` is the semiring zero: the mixed branch blanks the rows that
    chose SpMV before it calls the sparse kernel, so a batched capacity
    ladder (keyed on the largest live row) sizes itself from the
    sub-threshold rows only."""
    above = above_threshold(densities, threshold)
    n_above = int(above.sum())
    if n_above == 0:
        return spmspv_batch_fn(x_block)
    if n_above == densities.shape[0]:
        return spmv_batch_fn(x_block)
    blank = torch.tensor(zero, dtype=x_block.dtype, device=x_block.device)
    xs_sparse = torch.where(above[:, None], blank, x_block)
    return torch.where(above[:, None], spmv_batch_fn(x_block), spmspv_batch_fn(xs_sparse))


def adaptive_matvec(
    spmspv_fn: Callable[[Tensor], Tensor],
    spmv_fn: Callable[[Tensor], Tensor],
    x_dense: Tensor,
    density: Tensor,
    threshold: float,
) -> Tensor:
    """One adaptive iteration: a host branch on the device-computed switch.
    Both branches take and return the dense vector."""
    if bool(above_threshold(density, threshold)):
        return spmv_fn(x_dense)
    return spmspv_fn(x_dense)
