"""Config registry: 10 assigned architectures + input shapes.

A copy of the reference package's ``configs`` (pure dataclasses), so the
port needs nothing of that package; the tests hold ``param_count`` and
``smoke_variant`` equal to the reference's for every arch."""

from .base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    list_configs,
    smoke_variant,
)

from . import (  # noqa: F401  (registration side effects)
    qwen3_32b,
    llava_next_mistral_7b,
    mistral_nemo_12b,
    llama4_scout_17b_a16e,
    deepseek_67b,
    hymba_1_5b,
    phi3_5_moe_42b_a6_6b,
    musicgen_medium,
    rwkv6_3b,
    phi4_mini_3_8b,
)

ALL_ARCHS = [
    "qwen3-32b",
    "llava-next-mistral-7b",
    "mistral-nemo-12b",
    "llama4-scout-17b-a16e",
    "deepseek-67b",
    "hymba-1.5b",
    "phi3.5-moe-42b-a6.6b",
    "musicgen-medium",
    "rwkv6-3b",
    "phi4-mini-3.8b",
]
