"""DeepSeek 67B dense (llama-arch). [arXiv:2401.02954]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
    source="arXiv:2401.02954 (DeepSeek LLM 67B, llama-arch GQA)",
))
