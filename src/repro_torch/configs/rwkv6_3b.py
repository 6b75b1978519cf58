"""RWKV-6 (Finch) 3B: attention-free, data-dependent decay. [arXiv:2404.05892]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=8960,               # channel-mix width
    vocab_size=65536,
    attn_free=True,
    rwkv_head_dim=64,        # 40 wkv heads
    source="arXiv:2404.05892 (RWKV-6 Finch: data-dependent decay wkv)",
))
