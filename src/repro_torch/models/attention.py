"""GQA attention: blocked (flash-style) softmax, sliding window, KV cache.

Port of the reference's ``models/attention.py``.  Train and prefill
(no cache, positions ``arange(S)``) go through ``kernels.ops
.flash_attention``: the hand-written kernel on the card, its plain twin
on the CPU.  That is the function the reference's Pallas kernel computes
in place of ``blocked_attention``; its gradient is the hand-written
backward kernel on the card (the plain backward on the CPU), where the
reference differentiates ``blocked_attention`` with XLA.  Decode (with a cache) runs
``blocked_attention`` in plain PyTorch, as the reference computes decode
attention outside any kernel.
"""

from __future__ import annotations

import math

import torch

from ..kernels import ops
from ..obs.trace import count
from .common import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def init_attention(cfg, generator, dtype=torch.float32):
    hd = cfg.resolved_head_dim
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(generator, (d, H * hd), dtype),
        "wk": dense_init(generator, (d, KV * hd), dtype),
        "wv": dense_init(generator, (d, KV * hd), dtype),
        "wo": dense_init(generator, (H * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=generator.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=generator.device)
    if cfg.attn_gate:
        p["wg"] = dense_init(generator, (d, H * hd), dtype)
    return p


def _block_mask(q_pos, k_pos, window: int):
    """q_pos: (B, qc), k_pos: (B, kc) -> bool (B, 1, qc, kc). Causal+window."""
    q = q_pos[:, None, :, None]
    k = k_pos[:, None, None, :]
    valid = (k <= q) & (k >= 0)
    if window:
        valid &= k > q - window
    return valid


def blocked_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024,
                      static_positions: bool = False):
    """Online-softmax GQA attention with an explicit (KV, G) group split:
    kv heads are never repeated to H width.

    q: (B, Sq, H, hd) with H = KV*G; k, v: (B, Skv, KV, hd).
    q_pos: (B, Sq) int; k_pos: (B, Skv) int (−1 marks empty cache slots).
    static_positions: True when positions are literally ``arange`` — then
    blocks wholly above the diagonal or outside the window are skipped.
    """
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    n_q = (Sq + q_chunk - 1) // q_chunk
    n_kv = (Skv + kv_chunk - 1) // kv_chunk

    out_blocks = []
    for i in range(n_q):
        q0, q1 = i * q_chunk, min((i + 1) * q_chunk, Sq)
        qc = q1 - q0
        qb = (q[:, q0:q1].float() * scale).reshape(B, qc, KV, G, hd)
        qpb = q_pos[:, q0:q1]
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, qc, hd), dtype=torch.float32,
                          device=q.device)
        for j in range(n_kv):
            k0, k1_ = j * kv_chunk, min((j + 1) * kv_chunk, Skv)
            if static_positions:
                if k0 > q1 - 1:
                    continue
                if window and (k1_ - 1) < (q0 - window + 1):
                    continue
            kb = k[:, k0:k1_].float()                      # (B, kc, KV, hd)
            vb = v[:, k0:k1_].float()
            kpb = k_pos[:, k0:k1_]
            s = torch.einsum("bqcgh,bkch->bcgqk", qb, kb)
            mask = _block_mask(qpb, kpb, window)           # (B,1,qc,kc)
            s = torch.where(mask[:, :, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bcgqk,bkch->bcgqh", p, vb)
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]   # (B,KV,G,qc,hd)
        out_blocks.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc, H, hd))
    return torch.cat(out_blocks, dim=1).to(q.dtype)


def apply_attention(params, x, cfg, positions, *, cache=None, pos=None,
                    window: int = 0, q_chunk: int = 1024,
                    kv_chunk: int = 1024, return_cache: bool = False,
                    rope: bool = True):
    """Attention with optional KV cache.

    x: (B, S, d).  positions: (B, S) absolute positions of x tokens.
    cache: None or dict(k=(B, W, KV, hd), v=..., slot_pos=(W,)) — when given,
    runs a decode/append step: the new k/v are written at slot ``pos % W``
    (into a copy: the given cache is left as it was) and attention runs
    over the whole cache.  Without a cache, ``positions`` must be
    ``arange(S)`` for every row: that is what the kernel computes.
    return_cache: in prefill mode, also return the freshly-built cache.
    rope: rotate q and k by position (False: no position encoding).
    With ``cfg.attn_gate`` the heads' output is gated by sigmoid(x·wg)
    before ``wo``.
    """
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads

    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, KV, hd)
    v = (x @ params["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.rms_norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        W = cache["k"].shape[1]
        pos = int(pos)
        slot = pos % W
        start = min(slot, W - S)   # dynamic_update_slice clamps the start
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)
        slot_pos = cache["slot_pos"].clone()
        slot_pos[slot:slot + 1].fill_(pos)
        new_cache = {"k": ck, "v": cv, "slot_pos": slot_pos}
        k_pos = slot_pos[None].expand(B, W)
        out = blocked_attention(
            q, ck, cv, positions, k_pos, window=window,
            q_chunk=q_chunk, kv_chunk=kv_chunk, static_positions=False)
    else:
        arange = torch.arange(S, device=positions.device)
        count("host_syncs")     # torch.equal waits for the card
        if not torch.equal(positions, arange.expand(B, S).to(positions.dtype)):
            raise ValueError("without a cache, positions must be arange(S)")
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        if return_cache:
            new_cache = {"k": k, "v": v,
                         "slot_pos": positions[0].to(torch.int32)}

    out = out.reshape(B, S, H * hd)
    if cfg.attn_gate:
        out = out * torch.sigmoid(x @ params["wg"])
    return out @ params["wo"], new_cache


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device=None):
    """Empty per-layer KV cache (slot_pos −1 = invalid)."""
    hd = cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, cache_len, cfg.num_kv_heads, hd),
                         dtype=dtype, device=device),
        "v": torch.zeros((batch, cache_len, cfg.num_kv_heads, hd),
                         dtype=dtype, device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
    }
