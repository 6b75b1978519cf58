"""The deep-net models of the port: RWKV-6 and dense GQA transformers."""

from .transformer import (  # noqa: F401
    forward,
    init_decode_cache,
    init_model,
)
