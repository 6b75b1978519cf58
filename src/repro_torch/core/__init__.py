"""Paper core: RANL (Algorithm 1) and its substrate, in PyTorch."""

from .aggregation import server_aggregate  # noqa: F401
from .compression import CompressionSpec, parse_compression, uplink_bytes  # noqa: F401
from .convex import Logistic, Quadratic, make_logistic, make_quadratic  # noqa: F401
from .hessian import (  # noqa: F401
    hutchinson_diag,
    project_diag,
    project_psd,
    project_psd_ns,
    solve_projected,
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
