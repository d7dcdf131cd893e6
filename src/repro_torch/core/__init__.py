"""Semiring sparse linear algebra with adaptive kernel selection and
mesh-partitioned execution (the paper's contribution)."""
from repro_torch.core.semiring import (  # noqa: F401
    BOOL_OR_AND, MIN_PLUS, MIN_TIMES, PLUS_AND, PLUS_TIMES, SEMIRINGS,
    Semiring,
)
from repro_torch.core.formats import (  # noqa: F401
    BSRMatrix, COOMatrix, CSCMatrix, CSRMatrix, PaddedBSR, SlicedELL,
    autotune_sell, build_bsr, build_bsr_padded, build_coo, build_csc,
    build_csr, build_sell, sell_stream_cost,
)
from repro_torch.core.spmv import (  # noqa: F401
    spmv, spmv_batch, spmv_bsr_ref, spmv_coo, spmv_csr,
)
from repro_torch.core.spgemm import (  # noqa: F401
    spgemm_blocked, spgemm_dense_ref, spgemm_masked, spgemm_sparse_dense,
)
from repro_torch.core.spmspv import (  # noqa: F401
    Frontier, frontier_from_dense, spmspv, spmspv_batch, spmspv_batch_union,
    spmspv_coo_masked, spmspv_csc_gather, spmspv_csr_masked,
)
from repro_torch.core.adaptive import (  # noqa: F401
    DecisionStump, GraphFeatures, adaptive_matvec, adaptive_matvec_batch,
    fit_decision_stump, select_kernel, select_kernel_batch,
)
from repro_torch.core.pipeline import (  # noqa: F401
    iterate_phases, pipeline_buckets, run_phases_once,
)
from repro_torch.core.mesh import Mesh  # noqa: F401
from repro_torch.core.partition import (  # noqa: F401
    PartitionedMatrix, PartitionPlan, balanced_cuts, partition, plan_partition,
    shard_tensor, shard_vector, unpartition, unshard_tensor,
)
from repro_torch.core.collectives import (  # noqa: F401
    MERGE_FAMILIES, MergePlan, MergeStage, merge, merge_chunks, plan_merge,
)
from repro_torch.core.distributed import (  # noqa: F401
    build_phase_fns, gather_frontier, make_distributed_batched_matvec,
    make_distributed_matvec, make_distributed_spgemm, make_distributed_spmspv,
    make_distributed_spmv, vec_to_2d_layout,
)
