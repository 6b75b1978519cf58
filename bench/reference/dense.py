"""Plain dense decoder with grouped-query attention (Phi-4-mini,
arXiv:2412.08905): RMSNorm, RoPE on the two halves of each head,
causal GQA softmax attention, SwiGLU, an optionally tied head.

Layout of a layer, as the program holds it: ``ln1``, ``attn.{wq, wk,
wv, wo}``, ``ln2``, ``mlp.{gate, up, down}``; weights are (fan_in,
fan_out), so a projection is ``x @ w``.  Query head h reads kv head
``h // (H / KV)``.  Full score matrices, f32, no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _dims(cfg):
    hd = cfg["head_dim"] or cfg["d_model"] // cfg["num_heads"]
    return (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], hd,
            cfg["d_ff"], cfg["vocab_size"], cfg["num_layers"])


def param_specs(cfg):
    d, H, KV, hd, ff, V, L = _dims(cfg)

    def dense(fan_in, fan_out):
        return (fan_in, fan_out), ("normal", fan_in ** -0.5)
    specs = [(("embed",), (V, d), ("normal", 0.02))]
    if not cfg["tie_embeddings"]:
        specs.append((("lm_head",), *dense(d, V)))
    for i in range(L):
        p = ("layers", i)
        specs += [
            (p + ("ln1",), (d,), ("const", 1.0)),
            (p + ("attn", "wq"), *dense(d, H * hd)),
            (p + ("attn", "wk"), *dense(d, KV * hd)),
            (p + ("attn", "wv"), *dense(d, KV * hd)),
            (p + ("attn", "wo"), *dense(H * hd, d)),
            (p + ("ln2",), (d,), ("const", 1.0)),
            (p + ("mlp", "gate"), *dense(d, ff)),
            (p + ("mlp", "up"), *dense(d, ff)),
            (p + ("mlp", "down"), *dense(ff, d)),
        ]
    specs.append((("final_norm",), (d,), ("const", 1.0)))
    return specs


def rms_norm(x, scale, eps: float = 1e-6):
    inv = torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return x * inv * scale


def rope(x, theta: float):
    """x (B, S, heads, hd) rotated by position: the first half of each
    head against the second."""
    S, hd = x.shape[1], x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=x.device) / hd
    ang = (torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
           * (1.0 / torch.pow(float(theta), exps)))
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, x, cfg):
    d, H, KV, hd, _, _, _ = _dims(cfg)
    B, S, _ = x.shape
    q = rope((x @ p["wq"]).reshape(B, S, H, hd), cfg["rope_theta"])
    k = rope((x @ p["wk"]).reshape(B, S, KV, hd), cfg["rope_theta"])
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, S, H * hd) @ p["wo"]


def loss(params, batch, cfg):
    x = params["embed"][batch["tokens"].long()]
    for lp in params["layers"]:
        x = x + attention(lp["attn"], rms_norm(x, lp["ln1"]), cfg)
        h = rms_norm(x, lp["ln2"])
        m = lp["mlp"]
        x = x + (F.silu(h @ m["gate"]) * (h @ m["up"])) @ m["down"]
    x = rms_norm(x, params["final_norm"])
    head = (params["embed"].T if cfg["tie_embeddings"]
            else params["lm_head"])
    logits = x @ head
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1).long())


def matmul_params(cfg):
    d, H, KV, hd, ff, V, L = _dims(cfg)
    per_layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * ff
    return L * per_layer + d * V


def attn_pairs(seq: int) -> int:
    """(query, key) pairs a causal head keeps over one sequence."""
    return seq * (seq + 1) // 2


def extra_flops(cfg, batch: int, seq: int) -> float:
    """QKᵀ and PV over the kept causal pairs: 4·hd a pair forward, twice
    that backward (dP, dV, dS·K, dSᵀ·Q), nothing recomputed."""
    _, H, _, hd, _, _, L = _dims(cfg)
    return 12.0 * hd * attn_pairs(seq) * batch * H * L


def kernel_shapes(cfg, batch: int, seq: int):
    """{"attention": (B, S, H, KV, hd)} of one worker's call."""
    _, H, KV, hd, _, _, _ = _dims(cfg)
    return {"attention": (batch, seq, H, KV, hd)}
