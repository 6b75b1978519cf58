"""Mistral-NeMo 12B dense transformer, 128k context. [hf:mistralai/Mistral-Nemo-Base-2407]"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,          # GQA
    head_dim=128,            # 32*128 = 4096 != d_model (NeMo style)
    d_ff=14336,
    vocab_size=131072,       # tekken tokenizer
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407 (128k ctx)",
))
