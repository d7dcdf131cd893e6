"""Linear-algebraic graph applications on the core engine: frontier
traversals (BFS/SSSP/PPR), single- and multi-source (graphs/multi.py),
whole-graph analytics (CC / PageRank / triangle count / k-core,
graphs/analytics.py) and incremental recompute on dynamic graphs
(graphs/dynamic.py); the partition planner (graphs/cost_model.py) and
the partitioned matvec over a mesh (graphs/multi.py)."""
from repro_torch.graphs.analytics import (  # noqa: F401
    CCResult, KCoreResult, TriangleResult, cc_reference,
    connected_components, kcore, kcore_reference, triangle_count,
    triangle_reference,
)
from repro_torch.graphs.bfs import BFSResult, bfs, bfs_reference  # noqa: F401
from repro_torch.graphs.cost_model import (  # noqa: F401
    PlannerChoice, candidate_space, choose_merge, choose_partition,
    estimate_phase_costs, merge_wire_cost, parse_strategy, plan_for_graph,
    repair_choice, strategy_grid, trained_stump, training_corpus,
)
from repro_torch.graphs.datasets import (  # noqa: F401
    TABLE2, Graph, GraphSpec, generate, largest_component_source, rmat_graph,
    road_graph, uniform_graph,
)
from repro_torch.graphs.engine import GraphEngine, build_engine  # noqa: F401
from repro_torch.graphs.multi import (  # noqa: F401
    BFSBatchResult, PPRBatchResult, SSSPBatchResult, bfs_multi,
    make_bfs_multi, make_ppr_multi, make_sssp_multi, partitioned_matvec, ppr_multi,
    sssp_multi, traverse_multi_buckets,
)
from repro_torch.graphs.ppr import (  # noqa: F401
    PPRResult, pagerank, pagerank_reference, ppr, ppr_reference,
)
from repro_torch.graphs.sssp import SSSPResult, sssp, sssp_reference  # noqa: F401
