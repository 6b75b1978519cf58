"""Hymba-1.5B hybrid: parallel attention + mamba heads per layer. [arXiv:2411.13676]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,          # GQA
    head_dim=64,             # 25*64 = 1600
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,            # parallel mamba branch state size
    rope_theta=10_000.0,
    sliding_window=2048,     # hymba uses SWA on most layers
    source="arXiv:2411.13676 (Hymba: parallel attn+mamba heads, meta tokens omitted)",
))
