"""Model assembly: init, forward (train / prefill / decode), loss.

Port of the reference's ``models/transformer.py`` for every block kind it
has: the attention-free RWKV-6 block, the dense block (attention +
SwiGLU), the hybrid block (attention and a parallel SSM branch), the MoE
block (attention + routed experts, with the load-balance aux loss), and
the vision (projected patch embeddings) and audio (summed codebook
embeddings, one head per codebook) frontends.  Parameters are plain
dicts of tensors, the reference's names, with ``params["layers"]`` a list
of per-layer dicts; the layers run in a Python loop, with no scan and no
rematerialisation.  Decode caches keep the reference's stacked layout, a
leading L axis on every leaf.
"""

from __future__ import annotations

import torch

from .attention import apply_attention, init_attention, init_cache
from .common import apply_swiglu, dense_init, embed_init, init_swiglu, rms_norm
from .moe import apply_moe, init_moe
from .rwkv import (apply_channel_mix, apply_time_mix, init_channel_mix,
                   init_rwkv_state, init_time_mix)
from .ssm import apply_ssm, init_ssm, init_ssm_state


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_layer(cfg, generator, dtype=torch.float32):
    d = cfg.d_model
    dev = generator.device
    ones = lambda: torch.ones((d,), dtype=dtype, device=dev)  # noqa: E731
    if cfg.attn_free:
        return {
            "ln1": ones(), "tmix": init_time_mix(cfg, generator, dtype),
            "ln2": ones(), "cmix": init_channel_mix(cfg, generator, dtype),
        }
    p = {"ln1": ones(), "attn": init_attention(cfg, generator, dtype),
         "ln2": ones()}
    if cfg.family == "hybrid":
        p["ssm"] = init_ssm(cfg, generator, dtype)
    if cfg.num_experts:
        p["moe"] = init_moe(cfg, generator, dtype)
    else:
        p["mlp"] = init_swiglu(generator, d, cfg.d_ff, dtype)
    return p


def init_model(cfg, generator, dtype=torch.float32):
    """Random parameters on ``generator``'s device."""
    d, V = cfg.d_model, cfg.vocab_size
    if cfg.modality == "audio":
        params = {
            "embed": embed_init(generator, (cfg.num_codebooks, V, d), dtype),
            "lm_head": dense_init(generator, (cfg.num_codebooks, d, V),
                                  dtype)}
    else:
        params = {"embed": embed_init(generator, (V, d), dtype)}
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, (d, V), dtype)
    if cfg.modality == "vision":
        params["vision_proj"] = dense_init(
            generator, (cfg.vision_embed_dim, d), dtype)
    params["layers"] = [init_layer(cfg, generator, dtype)
                        for _ in range(cfg.num_layers)]
    params["final_norm"] = torch.ones((d,), dtype=dtype,
                                      device=generator.device)
    return params


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def apply_block(lp, x, cfg, *, mode, layer_cache, positions, pos, window,
                q_chunk, kv_chunk):
    """Returns (x, cache_out_or_None, aux_scalar)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    decode = mode == "decode" and layer_cache is not None

    if cfg.attn_free:  # RWKV
        ts = ({"last_x": layer_cache["tmix_last_x"], "wkv": layer_cache["wkv"]}
              if decode else None)
        h, tstate = apply_time_mix(lp["tmix"], rms_norm(x, lp["ln1"]), cfg,
                                   state=ts)
        x = x + h
        cs = {"last_x": layer_cache["cmix_last_x"]} if decode else None
        h, cstate = apply_channel_mix(lp["cmix"], rms_norm(x, lp["ln2"]), cfg,
                                      state=cs)
        x = x + h
        cache_out = None
        if mode != "train":
            cache_out = {"tmix_last_x": tstate["last_x"],
                         "wkv": tstate["wkv"],
                         "cmix_last_x": cstate["last_x"]}
        return x, cache_out, aux

    # --- attention (+ the hybrid's parallel SSM branch) ---
    h_in = rms_norm(x, lp["ln1"])
    attn_cache = None if layer_cache is None else layer_cache.get("attn")
    attn_out, attn_cache_out = apply_attention(
        lp["attn"], h_in, cfg, positions,
        cache=attn_cache if mode == "decode" else None,
        pos=pos, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
        return_cache=(mode == "prefill"))
    if cfg.family == "hybrid":
        ssm_out, ssm_state_out = apply_ssm(
            lp["ssm"], h_in, cfg,
            state=layer_cache.get("ssm") if decode else None)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out

    h2 = rms_norm(x, lp["ln2"])
    if cfg.num_experts:
        ffn_out, aux = apply_moe(lp["moe"], h2, cfg)
    else:
        ffn_out = apply_swiglu(lp["mlp"], h2)
    x = x + ffn_out

    cache_out = None
    if mode != "train":
        cache_out = {"attn": attn_cache_out}
        if cfg.family == "hybrid":
            cache_out["ssm"] = ssm_state_out
    return x, cache_out, aux


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def embed_inputs(params, batch, cfg):
    tokens = batch["tokens"]
    if cfg.modality == "audio":
        # tokens: (B, S, C); the codebooks' embeddings summed
        h = sum(params["embed"][c][tokens[..., c]]
                for c in range(cfg.num_codebooks))
    else:
        h = params["embed"][tokens]
    if cfg.modality == "vision" and "patch_embeds" in batch:
        # the projected patches written over the first positions
        pe, w = batch["patch_embeds"], params["vision_proj"]
        dt = torch.promote_types(pe.dtype, w.dtype)
        patches = (pe.to(dt) @ w.to(dt)).to(h.dtype)
        P = patches.shape[1]
        if P > h.shape[1]:
            raise ValueError(f"{P} patch embeddings do not fit in "
                             f"{h.shape[1]} positions")
        h = torch.cat([patches, h[:, P:]], dim=1)
    return h


def lm_logits(params, h, cfg):
    if cfg.modality == "audio":
        return torch.einsum("bsd,cdv->bscv", h, params["lm_head"])
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _layer(tree, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _stack(trees):
    first = trees[0]
    return {k: (_stack([t[k] for t in trees]) if isinstance(first[k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in first}


def forward(params, batch, cfg, *, mode="train", cache=None, window=None,
            q_chunk=1024, kv_chunk=1024, compute_logits=True):
    """Returns (logits, new_cache, aux).

    batch: {"tokens": (B, S) or (B, S, C)[, "patch_embeds", "pos": int]}.
    mode: train | prefill | decode.  decode consumes ``cache`` and returns
    an updated copy; prefill returns a fresh cache.
    window: sliding window (None -> cfg default: hybrid archs run with
    their configured window; others full attention).
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if window is None:
        window = cfg.sliding_window if cfg.family == "hybrid" else 0
    x = embed_inputs(params, batch, cfg)
    B, S = x.shape[:2]
    if mode == "decode":
        pos = int(batch["pos"])
        positions = torch.full((B, S), pos, dtype=torch.int32,
                               device=x.device)
    else:
        pos = None
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)

    layer_caches = None if cache is None else cache["layers"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache_outs = []
    for i, lp in enumerate(params["layers"]):
        lc = None if layer_caches is None else _layer(layer_caches, i)
        x, c, a = apply_block(lp, x, cfg, mode=mode, layer_cache=lc,
                              positions=positions, pos=pos, window=window,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
        aux = aux + a
        if c is not None:
            cache_outs.append(c)
    new_cache = {"layers": _stack(cache_outs)} if cache_outs else None

    x = rms_norm(x, params["final_norm"])
    if not compute_logits:
        return x, new_cache, aux
    return lm_logits(params, x, cfg), new_cache, aux


def lm_loss(params, batch, cfg, *, loss_chunk=1024, **fwd_kwargs):
    """Next-token cross-entropy plus the MoE aux loss, the logits made one
    sequence chunk of ``loss_chunk`` at a time: each chunk's (B, chunk,
    vocab) logits in f32, logsumexp − gold, summed; the total over the
    label count.  ``fwd_kwargs`` go to ``forward``."""
    h, _, aux = forward(params, batch, cfg, mode="train",
                        compute_logits=False, **fwd_kwargs)
    labels = batch["labels"].long()
    S = h.shape[1]
    chunk = min(loss_chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    denom = 0
    for s0 in range(0, S, chunk):
        lc = labels[:, s0:s0 + chunk]
        logits = lm_logits(params, h[:, s0:s0 + chunk], cfg).float()
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        total = total + torch.sum(torch.logsumexp(logits, dim=-1) - gold)
        denom += lc.numel()
    return total / denom + aux


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_decode_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
                      device=None):
    """Stacked (num_layers-leading) decode cache for a fresh sequence."""
    if cfg.attn_free:
        one = init_rwkv_state(cfg, batch, dtype, device)
    else:
        one = {"attn": init_cache(cfg, batch, cache_len, dtype, device)}
        if cfg.family == "hybrid":
            one["ssm"] = init_ssm_state(cfg, batch, dtype, device)
    return {"layers": _stack([one] * cfg.num_layers)}
