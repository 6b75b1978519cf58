"""Phi-4-mini 3.8B dense (RoPE, SwiGLU, GQA). [arXiv:2412.08905]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10_000.0,
    tie_embeddings=True,     # phi-4-mini ties input/output embeddings
    source="arXiv:2412.08905 (Phi-4 family, mini: RoPE SwiGLU GQA)",
))
