"""Semiring sparse linear algebra with adaptive kernel selection."""
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
from repro_torch.core.pipeline import pipeline_buckets  # noqa: F401
