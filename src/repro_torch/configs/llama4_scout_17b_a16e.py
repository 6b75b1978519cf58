"""Llama-4 Scout 17B-active / 16-expert MoE. [hf:meta-llama/Llama-4-Scout-17B-16E]

Early-fusion multimodality in the original card; the assigned backbone here
is the text decoder (MoE 16e top-1).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=8192,               # per-expert FFN width
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,     # top-1 routing
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (MoE 16e top-1, early fusion)",
))
