"""Qwen3-32B class dense transformer. [hf:Qwen/Qwen3-8B family card]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,          # GQA
    head_dim=128,            # decoupled from d_model (Qwen3 style)
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,            # per-head RMSNorm on q and k
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (scaled per assignment: 64L/5120/64H kv8/25600/151936, qk_norm+GQA)",
))
