"""LLaVA-NeXT (Mistral-7B backbone) VLM. [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The vision tower (CLIP ViT-L/336 + anyres tiling) is a STUB per the task
carve-out: ``input_specs`` provides precomputed patch embeddings of shape
(batch, vision_tokens, vision_embed_dim); the projector + language backbone
are implemented fully.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    modality="vision",
    vision_embed_dim=1024,   # CLIP ViT-L penultimate features
    vision_tokens=576,       # base 24x24 tile; anyres adds tiles (stubbed)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (anyres tiling frontend stubbed)",
))
