"""The deep-net models of the port: every block kind of the reference
(RWKV-6, dense GQA, hybrid attention+SSM, MoE) and its vision and audio
frontends."""

from .transformer import (  # noqa: F401
    forward,
    init_decode_cache,
    init_model,
    lm_loss,
)
