"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Port of the reference's ``models/moe.py``: top-k routing, the Switch
load-balance aux loss, and a capacity-bounded (E, C, d) expert buffer
filled in expert order.  The reference's ``lax.top_k`` breaks ties toward
the lower expert id; ``torch.topk`` promises no order among ties, so the
routing takes the first k of a stable descending sort instead.  Tokens
past an expert's capacity land in one spare row of the buffer, which is
dropped (the reference's scatter ``mode="drop"``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init


def init_moe(cfg, generator, dtype=torch.float32):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": dense_init(generator, (d, E), dtype, scale=0.02),
        "gate": dense_init(generator, (E, d, ff), dtype),
        "up": dense_init(generator, (E, d, ff), dtype),
        "down": dense_init(generator, (E, ff, d), dtype),
    }


def top_k(x, k: int):
    """(values, indices) of the k largest entries along the last dim,
    ties to the lower index, as ``lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, tokens: int) -> int:
    """Slots per expert: capacity_factor × the even share, or every
    routed token for small token counts (decode never drops)."""
    if tokens <= 64:
        return tokens * cfg.experts_per_token
    return int(math.ceil(tokens * cfg.experts_per_token / cfg.num_experts
                         * cfg.capacity_factor))


def apply_moe(params, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar f32)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xf = x.reshape(T, d)

    logits = (xf @ params["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(logits, k)                             # (T, k)
    top_w = torch.softmax(top_w, dim=-1).to(x.dtype)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    onehot = F.one_hot(top_e, E).float()                        # (T, k, E)
    frac_tokens = onehot.sum(dim=(0, 1)) / (T * k)
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0)) \
        * cfg.router_aux_weight

    C = capacity(cfg, T)
    flat_e = top_e.reshape(T * k)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    flat_w = top_w.reshape(T * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(T * k, device=x.device) - group_start
    keep = pos_in_e < C
    dest = torch.where(keep, sorted_e * C + pos_in_e,
                       torch.full_like(sorted_e, E * C))        # E*C: dropped
    src_t = flat_t[order]
    src_w = flat_w[order]

    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((dest,), xf[src_t])[:E * C].reshape(E, C, d)
    h = F.silu(torch.bmm(buf, params["gate"])) * torch.bmm(buf, params["up"])
    out_buf = torch.bmm(h, params["down"]).reshape(E * C, d)

    gathered = out_buf[torch.clamp_max(dest, E * C - 1)]
    gathered = gathered * (keep[:, None] * src_w[:, None]).to(x.dtype)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device).index_add(
        0, src_t, gathered)
    return out.reshape(B, S, d), aux
