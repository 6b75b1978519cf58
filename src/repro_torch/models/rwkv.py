"""RWKV-6 (Finch) blocks: time-mix with data-dependent decay + channel-mix.

Port of the reference's ``models/rwkv.py``.  The wkv recurrence
    y_t = r_t · (S + u ⊙ (k_t ⊗ v_t)),   S ← diag(w_t) S + k_t ⊗ v_t
goes through ``kernels.ops.rwkv_wkv`` in prefill (S = prompt length) and
in decode (S = 1): the hand-written kernel on the card, which keeps the
state in registers for the whole sequence, and its plain twin on the CPU.
That is the call the reference makes to ``_wkv_scan``.  Its chunked
``jax.checkpoint`` only saves memory in a backward pass; serving takes
none, so nothing here chunks time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import dense_init, rms_norm


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros / carried state at t=0). x: (B,S,d)."""
    B, S, d = x.shape
    first = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
             if last is None else last[:, None])
    return torch.cat([first, x[:, :-1]], dim=1)


def init_time_mix(cfg, generator, dtype=torch.float32):
    d = cfg.d_model
    H = cfg.num_rwkv_heads
    hd = cfg.rwkv_head_dim
    lora = 64
    dev = generator.device
    return {
        "mu": 0.5 * torch.ones((5, d), dtype=dtype, device=dev),  # r,k,v,w,g
        "w_r": dense_init(generator, (d, H * hd), dtype),
        "w_k": dense_init(generator, (d, H * hd), dtype),
        "w_v": dense_init(generator, (d, H * hd), dtype),
        "w_g": dense_init(generator, (d, H * hd), dtype),
        "decay_base": torch.full((H * hd,), -6.0, dtype=dtype, device=dev),
        "decay_lo": dense_init(generator, (d, lora), dtype, scale=0.01),
        "decay_hi": dense_init(generator, (lora, H * hd), dtype, scale=0.01),
        "bonus_u": dense_init(generator, (H, hd), dtype, scale=0.5),
        "ln_x": torch.ones((hd,), dtype=dtype, device=dev),
        "w_o": dense_init(generator, (H * hd, d), dtype),
    }


def apply_time_mix(params, x, cfg, *, state=None):
    """x: (B, S, d). state: None or {"last_x": (B,d), "wkv": (B,H,hd,hd)}."""
    B, S, d = x.shape
    H, hd = cfg.num_rwkv_heads, cfg.rwkv_head_dim
    last = None if state is None else state["last_x"]
    xs = _shift(x, last)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (x + (xs - x) * mu[i] for i in range(5))

    r = (xr @ params["w_r"]).reshape(B, S, H, hd)
    k = (xk @ params["w_k"]).reshape(B, S, H, hd)
    v = (xv @ params["w_v"]).reshape(B, S, H, hd)
    g = F.silu(xg @ params["w_g"])
    # data-dependent decay (Finch): w_t = exp(-exp(base + lora(x))), in f32
    dlog = params["decay_base"] + torch.tanh(
        xw @ params["decay_lo"]) @ params["decay_hi"]
    w = torch.exp(-torch.exp(dlog.float())).reshape(B, S, H, hd)

    wkv0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
            if state is None else state["wkv"])
    y, wkv = ops.rwkv_wkv(r, k, v, w, params["bonus_u"], wkv0)
    y = rms_norm(y, params["ln_x"]).reshape(B, S, H * hd).to(x.dtype)
    out = (y * g) @ params["w_o"]
    return out, {"last_x": x[:, -1], "wkv": wkv}


def init_channel_mix(cfg, generator, dtype=torch.float32):
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "mu": 0.5 * torch.ones((2, d), dtype=dtype, device=generator.device),
        "w_k": dense_init(generator, (d, ff), dtype),
        "w_v": dense_init(generator, (ff, d), dtype),
        "w_r": dense_init(generator, (d, d), dtype),
    }


def apply_channel_mix(params, x, cfg, *, state=None):
    last = None if state is None else state["last_x"]
    xs = _shift(x, last)
    xk = x + (xs - x) * params["mu"][0]
    xr = x + (xs - x) * params["mu"][1]
    kk = torch.square(torch.relu(xk @ params["w_k"]))
    out = torch.sigmoid(xr @ params["w_r"]) * (kk @ params["w_v"])
    return out, {"last_x": x[:, -1]}


def init_rwkv_state(cfg, batch: int, dtype=torch.float32, device=None):
    H, hd, d = cfg.num_rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    return {
        "tmix_last_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "cmix_last_x": torch.zeros((batch, d), dtype=dtype, device=device),
    }
