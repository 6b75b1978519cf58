"""Mixture-of-Experts FFNs.

``apply_moe``: port of the reference's ``models/moe.py`` with sort-based
capacity dispatch: top-k routing, the Switch load-balance aux loss, and
a capacity-bounded (E, C, d) expert buffer filled in expert order.  The
reference's ``lax.top_k`` breaks ties toward the lower expert id;
``torch.topk`` promises no order among ties, so the routing takes the
first k of a stable descending sort instead.  Tokens past an expert's
capacity land in one spare row of the buffer, which is dropped (the
reference's scatter ``mode="drop"``).

``apply_routed_moe``: the dropless layer of AFMoE (Trinity), which the
reference does not have: sigmoid scores over every expert of the layer,
the top k renormalised and scaled, every routed (token, expert) pair of
the experts held here computed, and a shared expert that every token
passes.  It is the expert-parallel layer's part on one card: the
experts held are ``[first_expert, first_expert + num_experts)`` of the
router's ``router_experts``, and the pairs routed elsewhere add nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..obs.trace import span
from .common import apply_swiglu, dense_init, init_swiglu


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


def init_routed_moe(cfg, generator, dtype=torch.float32):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(generator, (d, cfg.routed), dtype, scale=0.02),
        "gate": dense_init(generator, (E, d, ff), dtype),
        "up": dense_init(generator, (E, d, ff), dtype),
        "down": dense_init(generator, (E, ff, d), dtype),
    }
    if cfg.shared_d_ff:
        p["shared"] = init_swiglu(generator, d, cfg.shared_d_ff, dtype)
    return p


def route(x, router, cfg):
    """x (T, d) -> (weights (T, k) in x's type, experts (T, k)): sigmoid
    scores in f32 over every expert, the top k (ties to the lower id),
    renormalised to sum to one under ``route_norm``, times
    ``route_scale``.  Where the card holds a share of the experts, the
    weights are constants to autograd: the router's gradient sums a term
    from every expert's output, and those held elsewhere are not
    computed here, so a gradient from the held ones alone would draw the
    tokens to them."""
    if cfg.num_experts < cfg.routed:
        x, router = x.detach(), router.detach()
    scores = torch.sigmoid((x @ router).float())
    top_s, top_e = top_k(scores, cfg.experts_per_token)
    if cfg.route_norm:
        top_s = top_s / (top_s.sum(dim=-1, keepdim=True) + 1e-20)
    return (top_s * cfg.route_scale).to(x.dtype), top_e


# the routed rows the held experts took (the last offset of each call),
# summed on each device, and the calls: kept on the card and read once
# after a run (the benchmark's ``moe_gemm_roofline``), never inside one
ROUTED = {"calls": 0, "rows": {}}


def count_routed(offsets):
    """Add a call's routed rows held here to ``ROUTED``, on the card."""
    rows = ROUTED["rows"]
    if offsets.device not in rows:
        rows[offsets.device] = torch.zeros((), dtype=torch.int64,
                                           device=offsets.device)
    rows[offsets.device].add_(offsets[-1])
    ROUTED["calls"] += 1


def held_pairs(top_e, first: int, E: int):
    """The (token, slot) pairs routed to the experts held here, sorted by
    expert on the device: (order (T·k,) of the flattened pairs, held
    pairs first and in expert order, the rest after them; offsets (E+1,)
    int32: expert e's pairs are rows [offsets[e], offsets[e+1]) of the
    order).  No count reaches the host."""
    local = top_e.reshape(-1) - first
    key = torch.where((local >= 0) & (local < E), local, E)
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(E + 1, device=key.device, dtype=key.dtype)
    offsets = torch.searchsorted(sorted_key, bounds, side="left")
    return order, offsets.to(torch.int32)


def apply_routed_moe(params, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux 0): the shared expert plus
    Σ over each token's top k experts held here of weight · SwiGLU_e(x),
    the held experts' SwiGLU as grouped products
    (``ops.grouped_matmul``) over the pairs sorted by expert; the pairs
    of the experts held elsewhere are rows outside every group, which
    the products leave at zero.  The held rows are added to ``ROUTED``
    on the card.  Spans ``moe.route``, ``moe.experts`` and
    ``moe.shared``."""
    B, S, d = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    xf = x.reshape(B * S, d)
    dev = xf.device
    with span("moe.route", device=dev):
        top_w, top_e = route(xf, params["router"], cfg)
        order, offsets = held_pairs(top_e, cfg.first_expert, E)
        count_routed(offsets)
        tok = order // k
        xs = xf.index_select(0, tok)                    # (T·k, d)
    with span("moe.experts", device=dev):
        h = (F.silu(ops.grouped_matmul(xs, params["gate"], offsets))
             * ops.grouped_matmul(xs, params["up"], offsets))
        y = ops.grouped_matmul(h, params["down"], offsets)
        y = y * top_w.reshape(-1)[order][:, None]
        out = torch.zeros_like(xf).index_add(0, tok, y)
    if "shared" in params:
        with span("moe.shared", device=dev):
            out = out + apply_swiglu(params["shared"], xf)
    return out.reshape(B, S, d), torch.zeros((), dtype=torch.float32,
                                             device=dev)
