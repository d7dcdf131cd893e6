"""Linear-algebraic graph applications on the core engine: frontier
traversals (BFS/SSSP/PPR), single- and multi-source (graphs/multi.py),
whole-graph analytics (CC / PageRank / triangle count / k-core,
graphs/analytics.py) and incremental recompute on dynamic graphs
(graphs/dynamic.py)."""
from repro_torch.graphs.analytics import (  # noqa: F401
    CCResult, KCoreResult, TriangleResult, cc_reference,
    connected_components, kcore, kcore_reference, triangle_count,
    triangle_reference,
)
from repro_torch.graphs.bfs import BFSResult, bfs, bfs_reference  # noqa: F401
from repro_torch.graphs.cost_model import trained_stump, training_corpus  # noqa: F401
from repro_torch.graphs.datasets import (  # noqa: F401
    TABLE2, Graph, GraphSpec, generate, largest_component_source, rmat_graph,
    road_graph, uniform_graph,
)
from repro_torch.graphs.engine import GraphEngine, build_engine  # noqa: F401
from repro_torch.graphs.multi import (  # noqa: F401
    BFSBatchResult, PPRBatchResult, SSSPBatchResult, bfs_multi,
    make_bfs_multi, make_ppr_multi, make_sssp_multi, ppr_multi, sssp_multi,
    traverse_multi_buckets,
)
from repro_torch.graphs.ppr import (  # noqa: F401
    PPRResult, pagerank, pagerank_reference, ppr, ppr_reference,
)
from repro_torch.graphs.sssp import SSSPResult, sssp, sssp_reference  # noqa: F401
