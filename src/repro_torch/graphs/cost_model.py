"""Kernel-selection cost model (paper §4.2.1): a decision stump trained
offline on a labelled synthetic corpus. Two features, average degree and
degree std-dev, classify a graph as regular (switch at 20% density) or
scale-free (switch at 50%). Numpy only; the partition planner of the JAX
package's ``cost_model`` waits for the mesh slice of the port."""
from __future__ import annotations

import functools

from repro_torch.core.adaptive import DecisionStump, GraphFeatures, fit_decision_stump
from repro_torch.graphs import datasets


def training_corpus(seed: int = 0) -> tuple[list[GraphFeatures], list[str]]:
    """Labelled corpus: road/uniform generators → regular; R-MAT sweeps with
    graph500-grade skew → scale-free."""
    feats, labels = [], []
    for i in range(6):
        g = datasets.road_graph(4000 + 700 * i, 2.5 + 0.3 * i, seed=seed + i)
        feats.append(g.features()); labels.append("regular")
    for i in range(6):
        g = datasets.uniform_graph(3000 + 500 * i, (3000 + 500 * i) * (2 + i), seed=seed + i)
        feats.append(g.features()); labels.append("regular")
    for i in range(8):
        g = datasets.rmat_graph(4000 + 400 * i, 30000 + 8000 * i,
                                skew=0.55 + 0.02 * i, seed=seed + i)
        feats.append(g.features()); labels.append("scale_free")
    return feats, labels


@functools.lru_cache(maxsize=1)
def trained_stump(seed: int = 0) -> DecisionStump:
    feats, labels = training_corpus(seed)
    return fit_decision_stump(feats, labels)
