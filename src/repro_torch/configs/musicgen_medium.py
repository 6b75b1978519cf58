"""MusicGen-medium decoder over EnCodec tokens. [arXiv:2306.05284]

The EnCodec neural codec (audio <-> token frontend) is a STUB per the task
carve-out: the decoder consumes 4 parallel codebook token streams whose
embeddings are summed (delay-pattern interleave handled by the data layer).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,         # full MHA (kv == heads)
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,         # EnCodec codebook size
    modality="audio",
    num_codebooks=4,
    rope_theta=10_000.0,
    source="arXiv:2306.05284 (MusicGen medium; EnCodec frontend stubbed)",
))
