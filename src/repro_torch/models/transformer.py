"""Model assembly: init and forward (train / prefill / decode).

Port of the reference's ``models/transformer.py`` for two of its block
kinds: the attention-free RWKV-6 block and the plain dense block
(attention + SwiGLU).  Parameters are plain dicts of tensors, the
reference's names, with ``params["layers"]`` a list of per-layer dicts;
the layers run in a Python loop, with no scan and no rematerialisation.
Decode caches keep the reference's stacked layout, a leading L axis on
every leaf.  The hybrid, MoE, vision and audio branches raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from .attention import apply_attention, init_attention, init_cache
from .common import apply_swiglu, dense_init, embed_init, init_swiglu, rms_norm
from .rwkv import (apply_channel_mix, apply_time_mix, init_channel_mix,
                   init_rwkv_state, init_time_mix)

_NOT_YET = "ROADMAP Queue 1 item 14b (deep-net path, training and other blocks)"


def check_supported(cfg):
    """Raise ``NotImplementedError`` for the block kinds this port does not
    have yet."""
    for what, unsupported in (
            ("the hybrid attention+SSM block", cfg.family == "hybrid"),
            ("mixture-of-experts layers", cfg.num_experts > 0),
            (f"the {cfg.modality} frontend",
             cfg.modality in ("vision", "audio"))):
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet; see {_NOT_YET}")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_layer(cfg, generator, dtype=torch.float32):
    check_supported(cfg)
    d = cfg.d_model
    dev = generator.device
    ones = lambda: torch.ones((d,), dtype=dtype, device=dev)  # noqa: E731
    if cfg.attn_free:
        return {
            "ln1": ones(), "tmix": init_time_mix(cfg, generator, dtype),
            "ln2": ones(), "cmix": init_channel_mix(cfg, generator, dtype),
        }
    return {"ln1": ones(), "attn": init_attention(cfg, generator, dtype),
            "ln2": ones(),
            "mlp": init_swiglu(generator, d, cfg.d_ff, dtype)}


def init_model(cfg, generator, dtype=torch.float32):
    """Random parameters on ``generator``'s device."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    params = {"embed": embed_init(generator, (V, d), dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, (d, V), dtype)
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

    if cfg.attn_free:  # RWKV
        decode = mode == "decode" and layer_cache is not None
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

    h_in = rms_norm(x, lp["ln1"])
    attn_cache = None if layer_cache is None else layer_cache.get("attn")
    attn_out, attn_cache_out = apply_attention(
        lp["attn"], h_in, cfg, positions,
        cache=attn_cache if mode == "decode" else None,
        pos=pos, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
        return_cache=(mode == "prefill"))
    x = x + attn_out
    x = x + apply_swiglu(lp["mlp"], rms_norm(x, lp["ln2"]))
    cache_out = None if mode == "train" else {"attn": attn_cache_out}
    return x, cache_out, aux


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def embed_inputs(params, batch, cfg):
    check_supported(cfg)
    return params["embed"][batch["tokens"]]


def lm_logits(params, h, cfg):
    check_supported(cfg)
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

    batch: {"tokens": (B, S)[, "pos": int]}.
    mode: train | prefill | decode.  decode consumes ``cache`` and returns
    an updated copy; prefill returns a fresh cache.
    window: sliding window (None -> cfg default: full attention for the
    block kinds ported here).
    """
    check_supported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    if window is None:
        window = 0
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


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_decode_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
                      device=None):
    """Stacked (num_layers-leading) decode cache for a fresh sequence."""
    check_supported(cfg)
    if cfg.attn_free:
        one = init_rwkv_state(cfg, batch, dtype, device)
    else:
        one = {"attn": init_cache(cfg, batch, cache_len, dtype, device)}
    return {"layers": _stack([one] * cfg.num_layers)}
