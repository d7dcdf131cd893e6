"""Cost models: kernel selection (paper §4.2.1) and the partition planner.

Kernel selection: a decision stump trained offline on a labelled synthetic
corpus. Two features, average degree and degree std-dev, classify a graph
as regular (switch at 20% density) or scale-free (switch at 50%).

Partition planning (the paper's "selecting optimal data partitioning
strategies across PIM cores"), a copy of the JAX package's planner:
:func:`choose_partition` estimates, for every Fig.-3 strategy × balance,
the per-device Load / Kernel / Retrieve element cost of one distributed
matvec (the accounting of ``core/distributed.py``), from the candidate
plan's exact ``tile_nnz``, and picks the lowest total; ties break toward
the lower imbalance. Every candidate also carries an α-β priced Merge:
:func:`merge_wire_cost` prices each ``core/collectives.py`` topology
(``flat`` crosses the host link twice per element, ``HOST_HOP``; the
direct-link topologies once, at more latency steps), and
:func:`choose_merge` keeps flat unless another scores strictly lower.

Plus ``kernel_stream_cost``, the bytes model of the unfused against the
fused tile SpMV. Numpy only.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from repro_torch.core.adaptive import DecisionStump, GraphFeatures, fit_decision_stump
from repro_torch.core.collectives import MERGE_FAMILIES, STAGED_ORDERS, plan_merge
from repro_torch.core.partition import BALANCES, PartitionPlan, plan_partition
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


# ---------------------------------------------------------------------------
# Partition planner (paper §4.1.1 / Fig. 3 strategy selection)
# ---------------------------------------------------------------------------

STRATEGIES = ("row", "col", "2d")


def strategy_grid(strategy: str, n_devices: int,
                  grid2d: Tuple[int, int] | None = None) -> Tuple[int, int]:
    """The (R, C) grid a Fig.-3 strategy uses on ``n_devices`` devices."""
    if strategy == "row":
        return (n_devices, 1)
    if strategy == "col":
        return (1, n_devices)
    if strategy == "2d":
        if grid2d is None:
            r = int(np.floor(np.sqrt(n_devices)))
            while n_devices % r:
                r -= 1
            return (r, n_devices // r)
        assert grid2d[0] * grid2d[1] == n_devices, (grid2d, n_devices)
        return tuple(grid2d)
    raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                     f"{STRATEGIES}")


def parse_strategy(spec: str, balance: str | None = None):
    """Parse a user-facing strategy spec: ``"auto"`` or one of
    ``row``/``col``/``2d``, optionally suffixed ``:rows``/``:nnz`` (the
    suffix and an explicit ``balance`` kwarg must agree).  Returns
    ``(strategy, balance)`` with ``balance=None`` meaning "planner's
    choice" (auto) / legacy ``"rows"`` (fixed strategies)."""
    if ":" in spec:
        spec, suffix = spec.split(":", 1)
        if balance is not None and balance != suffix:
            raise ValueError(f"strategy suffix {suffix!r} contradicts "
                             f"balance={balance!r}")
        balance = suffix
    if spec != "auto" and spec not in STRATEGIES:
        raise ValueError(f"unknown strategy {spec!r}; expected 'auto' or one "
                         f"of {STRATEGIES} (optionally ':rows'/':nnz')")
    if balance is not None and balance not in BALANCES:
        raise ValueError(f"balance must be one of {BALANCES}, got {balance!r}")
    return spec, balance


def candidate_space(strategy: str, balance: str | None):
    """The (strategies, balances) search space a parsed spec opens: auto
    sweeps everything unconstrained; a fixed strategy pins it; a fixed
    strategy without an explicit balance keeps the legacy ``"rows"``."""
    strategies = STRATEGIES if strategy == "auto" else (strategy,)
    if balance is not None:
        balances: tuple = (balance,)
    else:
        balances = BALANCES if strategy == "auto" else ("rows",)
    return strategies, balances


# ---------------------------------------------------------------------------
# Merge wire pricing (paper §7: direct inter-core interconnects)
# ---------------------------------------------------------------------------

#: Hop weight of the host-mediated path: a flat merge bounces every
#: element DPU→CPU→DPU, crossing the narrow host link twice.  Direct
#: neighbour links (ring/tree/staged2d) are weight 1.
HOST_HOP = 2.0

#: α term, in element-transfer equivalents per collective step — the
#: fixed launch/sync latency one ppermute round costs relative to moving
#: one element.  Small enough that β (bytes) dominates at real sizes,
#: large enough to break wire ties toward fewer steps (tree's prime-radix
#: schedule beats staged2d's full-axis one on composite axis sizes).
MERGE_ALPHA = 64.0

MERGE_TOPOLOGIES = MERGE_FAMILIES


def merge_wire_cost(strategy: str, mesh_grid: Tuple[int, int],
                    m_elems: float, topology: str = "flat",
                    order: str = "rc",
                    link_weights: Tuple[float, float] = (1.0, 1.0)) -> dict:
    """Price one Merge of ``m_elems`` per-device partial-output elements
    on an (R, C) mesh: ``wire`` (hop-weighted elements each device puts
    on the interconnect), ``steps`` (latency rounds), and the combined
    ``score = wire + MERGE_ALPHA * steps`` used for ranking.

    ``link_weights`` are the relative per-element costs of the two mesh
    axes' direct links (row axis, col axis); collectives that span the
    flattened mesh (flat/ring over a ``col`` merge) pay the wider of the
    two, since their neighbour hops cross both link kinds.
    """
    plan = plan_merge(strategy, mesh_grid, topology, order=order)
    if plan is None:                                   # row: no Merge phase
        return {"wire": 0.0, "steps": 0, "score": 0.0}
    w_r, w_c = (float(w) for w in link_weights)
    by_axis = {"dr": w_r, "dc": w_c}
    w_span = max(w_r, w_c) if isinstance(plan.axis_name, tuple) \
        else by_axis[plan.axis_name]
    d = plan.axis_size
    m = float(m_elems)
    if topology == "flat":
        wire, steps = HOST_HOP * w_span * (d - 1) / d * m, 1
    elif topology == "ring":
        wire, steps = w_span * (d - 1) / d * m, d - 1
    else:                                   # tree / staged2d: walk stages
        wire, steps, live = 0.0, 0, m
        for st in plan.stages:
            f = st.factor
            wire += by_axis[st.axis_name] * (f - 1) / f * live
            steps += f - 1
            live /= f
        if plan.fixup is not None:          # staged2d "cr" relayout hop
            wire += w_span * live
            steps += 1
    return {"wire": wire, "steps": steps,
            "score": wire + MERGE_ALPHA * steps}


def choose_merge(strategy: str, mesh_grid: Tuple[int, int], m_elems: float,
                 link_weights: Tuple[float, float] = (1.0, 1.0)
                 ) -> Tuple[str, str, dict]:
    """Pick the cheapest Merge collective for one strategy on one mesh:
    sweep every topology (and both staged2d orders), rank by the α-β
    score.  ``flat`` is evaluated first and replaced only on a strict
    ``<``, so ties — and the degenerate ``row`` strategy, which has no
    Merge at all — keep the host-path baseline."""
    best = None
    for topology in MERGE_FAMILIES:
        orders = STAGED_ORDERS if topology == "staged2d" else ("rc",)
        for order in orders:
            cost = merge_wire_cost(strategy, mesh_grid, m_elems,
                                   topology, order, link_weights)
            if best is None or cost["score"] < best[2]["score"]:
                best = (topology, order, cost)
    return best


def estimate_phase_costs(plan: PartitionPlan, strategy: str,
                         kernel: str = "spmv",
                         frontier_density: float = 1.0, *,
                         mesh_grid: Tuple[int, int] | None = None,
                         merge: str = "auto", merge_order: str = "rc",
                         link_weights: Tuple[float, float] = (1.0, 1.0),
                         elem_bytes: int = 4) -> dict:
    """Per-device Load/Kernel/Retrieve element costs of one distributed
    matvec under ``plan`` (see module docstring for the accounting),
    plus the Merge-collective pricing: ``merge``/``merge_order`` (the
    chosen or pinned topology), ``merge_wire``/``merge_steps`` (its
    hop-weighted element traffic and latency rounds), and ``wire_bytes``
    — total bytes each device puts on the wire per matvec (Load elements
    cross the host link once; Merge priced per topology).

    ``mesh_grid`` is the physical (R, C) device mesh the collectives'
    staged/tree schedules decompose over; it defaults to the square-ish
    2d grid for ``plan.n_devices`` (the same default the factories use).
    ``merge="auto"`` selects via :func:`choose_merge`; a fixed topology
    name prices that one.  The ``total`` ranking choose_partition sorts
    by is untouched — wire pricing refines the pick, never reorders it.
    """
    m_loc, n_loc = plan.local_shape
    m_pad, n_pad = plan.padded_shape
    density = float(np.clip(frontier_density, 0.0, 1.0))
    if strategy == "row":
        load, retrieve = n_pad * density, 0.0
    elif strategy == "col":
        load, retrieve = 0.0, float(m_pad)
    else:
        load, retrieve = n_loc * density, float(m_loc)
    kern = float(max(plan.tile_nnz, default=0))
    if kernel == "spmspv":
        kern *= density
    total = load + kern + retrieve
    if mesh_grid is None:
        mesh_grid = strategy_grid("2d", plan.n_devices)
    m_merge = {"row": 0.0, "col": float(m_pad), "2d": float(m_loc)}[strategy]
    if merge == "auto":
        topo, order, mc = choose_merge(strategy, mesh_grid, m_merge,
                                       link_weights)
    else:
        topo, order = merge, merge_order
        mc = merge_wire_cost(strategy, mesh_grid, m_merge, topo, order,
                             link_weights)
    return {"load": load, "kernel": kern, "retrieve": retrieve,
            "total": total, "imbalance": plan.imbalance(),
            "merge": topo, "merge_order": order,
            "merge_wire": mc["wire"], "merge_steps": mc["steps"],
            "wire_bytes": (load + mc["wire"]) * elem_bytes}


@dataclasses.dataclass(frozen=True, eq=False)
class PlannerChoice:
    """The planner's answer for one graph: the picked strategy+balance, its
    plan, the Merge collective priced cheapest for that pick
    (``merge``/``merge_order``, see :func:`choose_merge`), and the full
    per-candidate cost table (keyed (strategy, balance)) for reporting."""

    strategy: str
    balance: str
    grid: Tuple[int, int]
    plan: PartitionPlan
    costs: dict
    merge: str = "flat"
    merge_order: str = "rc"


def choose_partition(rows: np.ndarray, cols: np.ndarray,
                     shape: Tuple[int, int], n_devices: int = 8,
                     grid2d: Tuple[int, int] | None = None,
                     kernel: str = "spmv", frontier_density: float = 1.0,
                     strategies=STRATEGIES, balances=BALANCES
                     ) -> PlannerChoice:
    """Pick the (strategy, balance) with the lowest estimated per-device
    phase total for this edge list; ties break toward lower imbalance.
    ``rows``/``cols`` are the edges of the matrix that will be partitioned
    (for traversal engines that is the *transposed* adjacency)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    mesh_grid = strategy_grid("2d", n_devices, grid2d)
    table: dict = {}
    best = None
    for strategy in strategies:
        grid = strategy_grid(strategy, n_devices, grid2d)
        for balance in balances:
            plan = plan_partition(rows, cols, shape, grid, balance)
            cost = estimate_phase_costs(plan, strategy, kernel,
                                        frontier_density,
                                        mesh_grid=mesh_grid)
            table[(strategy, balance)] = cost
            key = (cost["total"], cost["imbalance"])
            if best is None or key < best[0]:
                best = (key, strategy, balance, grid, plan, cost)
    _, strategy, balance, grid, plan, cost = best
    return PlannerChoice(strategy=strategy, balance=balance, grid=grid,
                         plan=plan, costs=table,
                         merge=cost["merge"], merge_order=cost["merge_order"])


def plan_for_graph(graph, n_devices: int = 8,
                   grid2d: Tuple[int, int] | None = None,
                   kernel: str = "spmv", frontier_density: float = 1.0,
                   strategies=STRATEGIES, balances=BALANCES
                   ) -> PlannerChoice:
    """:func:`choose_partition` for a Graph's *transposed* adjacency (the
    matrix traversal engines multiply by), with the global shape padded to
    a multiple of 64 so every grid divides it — the same convention as
    benchmarks.phases.prep."""
    n_pad = -(-graph.n // 64) * 64
    return choose_partition(graph.cols, graph.rows, (n_pad, n_pad),
                            n_devices=n_devices, grid2d=grid2d,
                            kernel=kernel, frontier_density=frontier_density,
                            strategies=strategies, balances=balances)


def repair_choice(choice: PlannerChoice, graph, delta,
                  n_devices: int = 8,
                  grid2d: Tuple[int, int] | None = None,
                  kernel: str = "spmv", frontier_density: float = 1.0,
                  strategies=STRATEGIES, balances=BALANCES,
                  max_imbalance: float = 1.5
                  ) -> Tuple[PlannerChoice, bool]:
    """Incremental replan check after one *effective* edge delta
    (core.delta.edge_diff output — every listed edge really changed):
    patch the chosen plan's per-tile nnz in O(|delta|)
    (:meth:`~repro_torch.core.partition.PartitionPlan.apply_delta`, transposed
    like the plan itself) and keep the cuts — unless the patched
    imbalance has drifted past ``max_imbalance``, in which case the full
    planner reruns over ``graph`` (the *new* snapshot) and may change
    strategy/balance entirely. Returns ``(choice, replanned)``; the
    patched fast path refreshes the chosen candidate's cost-table entry
    so reported costs track the live nnz distribution."""
    patched = choice.plan.apply_delta(
        delta.insert_cols, delta.insert_rows,    # transposed adjacency
        delta.delete_cols, delta.delete_rows)
    if patched.imbalance() > max_imbalance:
        return plan_for_graph(graph, n_devices=n_devices, grid2d=grid2d,
                              kernel=kernel,
                              frontier_density=frontier_density,
                              strategies=strategies,
                              balances=balances), True
    costs = dict(choice.costs)
    costs[(choice.strategy, choice.balance)] = estimate_phase_costs(
        patched, choice.strategy, kernel, frontier_density,
        mesh_grid=strategy_grid("2d", n_devices, grid2d),
        merge=choice.merge, merge_order=choice.merge_order)
    return PlannerChoice(strategy=choice.strategy, balance=choice.balance,
                         grid=choice.grid, plan=patched, costs=costs,
                         merge=choice.merge,
                         merge_order=choice.merge_order), False


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
