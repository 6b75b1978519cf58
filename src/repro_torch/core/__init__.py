"""Paper core: RANL (Algorithm 1) and its substrate, in PyTorch."""

from ..kernels.ref import chol_rank1_update  # noqa: F401
from .aggregation import late_fold_updates, quorum_aggregate, server_aggregate  # noqa: F401
from .baselines import (  # noqa: F401
    rounds_to_tol,
    run_gd,
    run_newton_exact,
    run_newton_zero,
    run_sgd,
)
from .compression import (  # noqa: F401
    CompressionSpec,
    compress_rows,
    compressed_quorum_aggregate,
    compressed_server_aggregate,
    lowrank_hmu_factor,
    parse_compression,
    uplink_bytes,
)
from .convex import Logistic, Quadratic, make_logistic, make_quadratic  # noqa: F401
from .hessian import (  # noqa: F401
    blocked_cho_solve,
    blocked_cholesky,
    fisher_diag,
    hutchinson_diag,
    project_diag,
    project_psd,
    project_psd_ns,
    project_psd_ns_panels,
    project_psd_sharded,
    solve_projected,
    sym_eigh,
)
from .masks import (  # noqa: F401
    PolicyConfig,
    ensure_coverage,
    sample_masks,
    staleness_weights,
)
from .options import (  # noqa: F401
    EngineDeprecationWarning,
    HierarchySpec,
    QuorumSpec,
    RanlOptions,
    parse_hierarchy,
)
from .regions import contiguous_regions, expand_mask, region_sizes  # noqa: F401
