"""Kernel-selection cost model (paper §4.2.1): a decision stump trained
offline on a labelled synthetic corpus. Two features, average degree and
degree std-dev, classify a graph as regular (switch at 20% density) or
scale-free (switch at 50%). Plus ``kernel_stream_cost``, the bytes model
of the unfused against the fused tile SpMV. Numpy only; the partition
planner of the JAX package's ``cost_model`` waits for the mesh slice of
the port."""
from __future__ import annotations

import functools
from typing import Tuple

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


def kernel_stream_cost(mb: int, slots: int, real_slots: int,
                       block: Tuple[int, int], n: int, *,
                       elem_bytes: int = 4) -> dict:
    """Modelled device-memory bytes of the unfused against the fused tile
    SpMV, from aggregates: the unfused ELL kernel moves every slot's tile
    plus one x block per slot, the fused kernel the ``real_slots`` tiles
    and x once. ``kernels/ops.py``'s ``*_stream_stats`` count the same
    from a matrix's own metadata."""
    bm, bn = block
    y_bytes = mb * bm * elem_bytes
    unfused = mb * slots * (bm * bn + bn) * elem_bytes + y_bytes
    fused = (real_slots * bm * bn + n) * elem_bytes + y_bytes
    ops = 2 * real_slots * bm * bn
    return {
        "unfused_bytes": unfused,
        "fused_bytes": fused,
        "unfused_ai": ops / max(1, unfused),
        "fused_ai": ops / max(1, fused),
        "bytes_ratio": unfused / max(1, fused),
    }
