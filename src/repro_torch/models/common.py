"""Shared building blocks: RMSNorm, RoPE, SwiGLU, init helpers.

Port of the reference's ``models/common.py``.  Weights keep its layout,
(fan_in, fan_out), so a layer is ``x @ w`` on both sides.  Random draws
come from an explicit ``torch.Generator``, and tensors are made on that
generator's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _trunc_normal(generator, shape, std: float, dtype):
    """Truncated normal on [-2, 2], scaled by ``std``, drawn in f32 on
    the generator's device and then cast, as the reference does."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def dense_init(generator, shape, dtype=torch.float32,
               scale: float | None = None):
    """Truncated-normal init with 1/sqrt(fan_in) scale (fan_in = shape[-2])."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    return _trunc_normal(generator, shape, std, dtype)


def embed_init(generator, shape, dtype=torch.float32):
    return _trunc_normal(generator, shape, 0.02, dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    # stats in fp32, but the normalize multiply stays in x.dtype, as in the
    # reference (which keeps it there to halve its activation stash)
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin of shape (..., S, head_dim//2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    # a Python base: no host-to-card copy, so a decode step can be
    # captured in a CUDA graph
    freqs = 1.0 / torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float):
    """x: (B, S, heads, hd); positions: (B, S) -> rotated x (same dtype)."""
    hd = x.shape[-1]
    cos, sin = rope_cos_sin(positions, hd, theta)      # (B, S, hd//2)
    cos = cos[:, :, None, :]                            # (B, S, 1, hd//2)
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_swiglu(generator, d_model: int, d_ff: int, dtype=torch.float32):
    return {
        "gate": dense_init(generator, (d_model, d_ff), dtype),
        "up": dense_init(generator, (d_model, d_ff), dtype),
        "down": dense_init(generator, (d_ff, d_model), dtype),
    }


def apply_swiglu(params, x):
    h = F.silu(x @ params["gate"]) * (x @ params["up"])
    return h @ params["down"]


def softmax_cross_entropy(logits, labels):
    """logits: (..., V) float; labels: (...,) int -> scalar mean loss (f32)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
