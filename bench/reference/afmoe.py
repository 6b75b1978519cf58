"""Plain AFMoE decoder (Arcee's Trinity; ``model_type`` afmoe in Hugging
Face transformers), as one card of an expert-parallel deployment holds
it: the router over every expert of a layer, the experts
``[first_expert, first_expert + num_experts)`` computed here.

Layer i of the residual stream x, every norm an RMSNorm at
``rms_norm_eps``:

    a = ln1(x);  q, k, v = a·wq, a·wk, a·wv;  q, k = q_norm, k_norm a head
    q, k rotated by position (RoPE) on a sliding layer; none on a full one
    o = softmax(q·kᵀ/√hd) v, causal, over the last ``sliding_window``
        keys on a sliding layer, every earlier key on a full one
    x = x + ln1_post((o ⊙ sigmoid(a·wg))·wo)
    f = ln2(x):  the first ``num_dense_layers`` layers a SwiGLU;
        the others the shared expert's SwiGLU plus, over each token's
        top k of the sigmoid scores s = sigmoid(f·router) (ties to the
        lower id), those held here: route_scale · s_e / Σ_top s ·
        SwiGLU_e(f); the routing weights constants to autograd where
        the card holds a share of the experts (the router's gradient
        needs every expert's output)
    x = x + ln2_post(that)

the embedding times √d_model at the input; the loss is the next-token
cross-entropy of final_norm(x)·lm_head.  The layout is the program's:
``ln1``, ``ln1_post``, ``ln2``, ``ln2_post``, ``attn.{wq, wk, wv, wo,
wg, q_norm, k_norm}`` and ``mlp.{gate, up, down}`` or ``moe.{router,
gate, up, down, shared.{gate, up, down}}`` (experts stacked on a leading
axis); weights are (fan_in, fan_out).  Query head h reads kv head
h // (H / KV).

Plain f32: score matrices whole for each block of ``BLOCK`` queries
against the keys its rows can reach, one loop iteration an expert held,
no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 1024       # queries a score matrix, so that one fits at 4096 tokens


def _dims(cfg):
    return (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
            cfg["head_dim"], cfg["vocab_size"], cfg["num_layers"])


def is_dense(cfg, i: int) -> bool:
    return i < cfg["num_dense_layers"]


def layer_window(cfg, i: int) -> int:
    """The keys a query of layer i reaches back over (0: all)."""
    return (cfg["sliding_window"]
            if cfg["layer_types"][i] == "sliding_attention" else 0)


def param_specs(cfg):
    d, H, KV, hd, V, L = _dims(cfg)
    E, ff = cfg["num_experts"], cfg["d_ff"]

    def dense(*shape):
        return shape, ("normal", shape[-2] ** -0.5)

    def swiglu(p, width):
        return [(p + ("gate",), *dense(d, width)),
                (p + ("up",), *dense(d, width)),
                (p + ("down",), *dense(width, d))]
    one = (d,), ("const", 1.0)
    specs = [(("embed",), (V, d), ("normal", 0.02)),
             (("lm_head",), *dense(d, V))]
    for i in range(L):
        p = ("layers", i)
        specs += [(p + ("ln1",), *one), (p + ("ln1_post",), *one),
                  (p + ("ln2",), *one), (p + ("ln2_post",), *one),
                  (p + ("attn", "wq"), *dense(d, H * hd)),
                  (p + ("attn", "wk"), *dense(d, KV * hd)),
                  (p + ("attn", "wv"), *dense(d, KV * hd)),
                  (p + ("attn", "wo"), *dense(H * hd, d)),
                  (p + ("attn", "wg"), *dense(d, H * hd)),
                  (p + ("attn", "q_norm"), (hd,), ("const", 1.0)),
                  (p + ("attn", "k_norm"), (hd,), ("const", 1.0))]
        if is_dense(cfg, i):
            specs += swiglu(p + ("mlp",), cfg["dense_d_ff"])
        else:
            m = p + ("moe",)
            specs += [(m + ("router",), (d, cfg["router_experts"]),
                       ("normal", 0.02)),
                      (m + ("gate",), *dense(E, d, ff)),
                      (m + ("up",), *dense(E, d, ff)),
                      (m + ("down",), *dense(E, ff, d))]
            specs += swiglu(m + ("shared",), cfg["shared_d_ff"])
    specs.append((("final_norm",), (d,), ("const", 1.0)))
    return specs


def rms_norm(x, scale, eps: float):
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


def attention(p, x, cfg, window: int):
    """Gated GQA attention of one layer; RoPE where it has a window."""
    d, H, KV, hd, _, _ = _dims(cfg)
    eps = cfg["rms_norm_eps"]
    B, S, _ = x.shape
    q = rms_norm((x @ p["wq"]).reshape(B, S, H, hd), p["q_norm"], eps)
    k = rms_norm((x @ p["wk"]).reshape(B, S, KV, hd), p["k_norm"], eps)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    if window:
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    out = []
    for q0 in range(0, S, BLOCK):
        q1 = min(q0 + BLOCK, S)
        k0 = max(0, q0 - window + 1) if window else 0
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1],
                         k[:, k0:q1]) * hd ** -0.5
        qi = torch.arange(q0, q1, device=x.device)[:, None]
        ki = torch.arange(k0, q1, device=x.device)[None, :]
        keep = ki <= qi
        if window:
            keep &= ki > qi - window
        s = s.masked_fill(~keep, float("-inf"))
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                                v[:, k0:q1]))
    o = torch.cat(out, dim=1).reshape(B, S, H * hd)
    return (o * torch.sigmoid(x @ p["wg"])) @ p["wo"]


def swiglu(p, x):
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]


def experts(p, x, cfg):
    """The routed experts held here, one at a time, and the shared one."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    xr, router = xf, p["router"]
    if cfg["num_experts"] < cfg["router_experts"]:   # held: no gradient
        xr, router = xr.detach(), router.detach()
    scores = torch.sigmoid((xr @ router).float())
    top_s, top_e = torch.sort(scores, dim=-1, descending=True, stable=True)
    k = cfg["experts_per_token"]
    top_s, top_e = top_s[:, :k], top_e[:, :k]
    if cfg["route_norm"]:
        top_s = top_s / (top_s.sum(dim=-1, keepdim=True) + 1e-20)
    weight = top_s * cfg["route_scale"]
    out = torch.zeros_like(xf)
    for j in range(cfg["num_experts"]):
        tok, slot = torch.nonzero(top_e == cfg["first_expert"] + j,
                                  as_tuple=True)
        if tok.numel():
            xe = xf[tok]
            ye = (F.silu(xe @ p["gate"][j]) * (xe @ p["up"][j])) @ p["down"][j]
            out = out.index_add(0, tok, ye * weight[tok, slot][:, None])
    return (out + swiglu(p["shared"], xf)).reshape(B, S, d)


def ffn(lp, x, cfg, i: int):
    return swiglu(lp["mlp"], x) if is_dense(cfg, i) else experts(lp["moe"],
                                                                 x, cfg)


def loss(params, batch, cfg):
    eps = cfg["rms_norm_eps"]
    x = params["embed"][batch["tokens"].long()] * cfg["d_model"] ** 0.5
    for i, lp in enumerate(params["layers"]):
        a = attention(lp["attn"], rms_norm(x, lp["ln1"], eps), cfg,
                      layer_window(cfg, i))
        x = x + rms_norm(a, lp["ln1_post"], eps)
        f = ffn(lp, rms_norm(x, lp["ln2"], eps), cfg, i)
        x = x + rms_norm(f, lp["ln2_post"], eps)
    logits = rms_norm(x, params["final_norm"], eps) @ params["lm_head"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1).long())


def routed_rows(cfg, tokens: int) -> float:
    """Expected (token, expert) pairs computed here for ``tokens``
    tokens: k of the router's experts a token, a share num_experts /
    router_experts of them held here."""
    return (tokens * cfg["experts_per_token"] * cfg["num_experts"]
            / cfg["router_experts"])


def matmul_params(cfg):
    """A token's parameters in products: attention with its gate, the
    dense FFNs, and in an expert layer the router (a third of it where
    the card holds a share of the experts: a forward product, no
    backward), the shared expert and the routed experts at their
    expected rows; the untied head."""
    d, H, KV, hd, V, L = _dims(cfg)
    attn = 2 * d * H * hd + 2 * d * KV * hd + H * hd * d
    dense = 3 * d * cfg["dense_d_ff"]
    router = d * cfg["router_experts"] / (
        3 if cfg["num_experts"] < cfg["router_experts"] else 1)
    moe = (router + 3 * d * cfg["shared_d_ff"]
           + routed_rows(cfg, 1) * 3 * d * cfg["d_ff"])
    return sum(attn + (dense if is_dense(cfg, i) else moe)
               for i in range(L)) + d * V


def attn_pairs(seq: int, window: int = 0) -> int:
    """(query, key) pairs a causal head keeps over one sequence, within
    ``window`` keys of the query (0: all)."""
    if not window or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def extra_flops(cfg, batch: int, seq: int) -> float:
    """QKᵀ and PV over each layer's kept pairs: 4·hd a pair forward,
    twice that backward, nothing recomputed."""
    _, H, _, hd, _, L = _dims(cfg)
    pairs = sum(attn_pairs(seq, layer_window(cfg, i)) for i in range(L))
    return 12.0 * hd * pairs * batch * H


def kernel_shapes(cfg, batch: int, seq: int):
    """One worker's calls: {"attention": (B, S, H, KV, hd), "experts":
    (expected routed rows, d_model, expert width, experts held)}."""
    d, H, KV, hd, _, _ = _dims(cfg)
    return {"attention": (batch, seq, H, KV, hd),
            "experts": (routed_rows(cfg, batch * seq), d, cfg["d_ff"],
                        cfg["num_experts"])}
