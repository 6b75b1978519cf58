"""Model/config registry for the RANL framework.

Every assigned architecture from the public pool gets one module in this
package defining a :class:`ModelConfig` with the exact published dimensions
(citation recorded in ``source``).  ``smoke_variant`` derives the reduced
configuration used by CPU smoke tests (2 layers, d_model <= 512, <= 4
experts) so the same code path is exercised end-to-end without TPU-scale
allocation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int              # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv_width: int = 4
    # --- RWKV ---
    attn_free: bool = False
    rwkv_head_dim: int = 64
    # --- modality frontends (stubs per the carve-out) ---
    modality: str = "text"      # text | vision | audio
    num_codebooks: int = 1      # audio: EnCodec codebooks summed at the embed
    vision_embed_dim: int = 1024
    vision_tokens: int = 576    # anyres base-tile token budget (stubbed)
    # --- long-context serving ---
    sliding_window: int = 8192  # window used by the long_500k decode variant
    # --- misc ---
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return self.rwkv_head_dim

    @property
    def num_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def uses_attention(self) -> bool:
        return not self.attn_free

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid") and self.ssm_state > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        per_layer = 0
        if self.uses_attention and not self.attn_free:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            per_layer += q + kv + o + 2 * d  # + norms
        if self.attn_free:  # rwkv time-mix
            h = self.num_rwkv_heads * self.rwkv_head_dim
            per_layer += 5 * d * h + h * d + 2 * d
        if self.uses_ssm:
            di = d
            per_layer += d * 2 * di + di * (2 * self.ssm_state + 1) + di * d
        if self.num_experts:
            per_layer += self.num_experts * 3 * d * ff + d * self.num_experts
        elif not self.attn_free:
            per_layer += 3 * d * ff
        else:  # rwkv channel mix
            per_layer += 2 * d * int(ff)
        total = self.num_layers * per_layer
        total += v * d  # embedding
        if not self.tie_embeddings:
            total += d * v
        if self.modality == "vision":
            total += self.vision_embed_dim * d
        if self.modality == "audio":
            total += (self.num_codebooks - 1) * v * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        dense_like = dataclasses.replace(
            self, num_experts=0, experts_per_token=0,
            d_ff=self.d_ff * self.experts_per_token)
        return dense_like.param_count()


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate config {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import ALL_ARCHS  # noqa: F401  (forces registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import ALL_ARCHS  # noqa: F401
    return sorted(_REGISTRY)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    heads = max(1, min(4, cfg.num_heads)) if cfg.num_heads else 0
    kv = 0
    if cfg.num_kv_heads:
        kv = max(1, min(2, cfg.num_kv_heads))
        if heads % kv:
            kv = 1
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=256,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64 if cfg.num_heads else 0,
        d_ff=512,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=min(cfg.ssm_state, 8),
        rwkv_head_dim=64,
        vision_embed_dim=96,
        vision_tokens=8,
        sliding_window=16,
        dtype="float32",
    )
