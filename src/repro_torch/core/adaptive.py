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
