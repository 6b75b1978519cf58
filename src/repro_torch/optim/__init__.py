"""Deep-net optimizers: RANL (``ranl_llm``) and the first-order
baselines (SGD, AdamW)."""

from .first_order import (  # noqa: F401
    AdamWConfig,
    SGDConfig,
    adamw_init,
    adamw_step,
    sgd_init,
    sgd_step,
)
from .ranl_llm import (  # noqa: F401
    RanlLLMConfig,
    gather_tree,
    init_state,
    masked_aggregate,
    per_worker_grads,
    region_layout,
    region_param_counts,
    shard_params,
    train_step,
)
