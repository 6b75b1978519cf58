"""Selective SSM (Mamba-style) branch of the Hymba hybrid blocks.

Port of the reference's ``models/ssm.py``.  The diagonal recurrence
h_t = a_t ⊙ h_{t-1} + b_t runs as a sequential loop over time
(``_ssm_scan``), where the reference uses ``lax.associative_scan``: the
same recurrence with its products and sums in another order, so the two
agree to f32 rounding.  Decode keeps the (B, d_inner, n) state and the
last W − 1 conv inputs, and takes one step of each.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init


def init_ssm(cfg, generator, dtype=torch.float32):
    d = cfg.d_model
    di = d                      # inner width (1x expansion for the branch)
    n = cfg.ssm_state
    r = max(1, di // 16)        # low-rank dt projection
    dev = generator.device
    return {
        "in_proj": dense_init(generator, (d, 2 * di), dtype),
        "conv": dense_init(generator, (cfg.ssm_conv_width, di), dtype,
                           scale=cfg.ssm_conv_width ** -0.5),
        "dt_lo": dense_init(generator, (di, r), dtype),
        "dt_hi": dense_init(generator, (r, di), dtype),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=dev),
        "w_B": dense_init(generator, (di, n), dtype),
        "w_C": dense_init(generator, (di, n), dtype),
        "A_log": torch.zeros((di, n), dtype=dtype, device=dev),
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (di, d), dtype),
    }


def _causal_conv(u, w, conv_state=None):
    """Depthwise causal conv.  u: (B, S, di); w: (W, di); conv_state:
    (B, W-1, di) trailing inputs of the previous step (decode).  Returns
    (y, new_conv_state)."""
    B, S, di = u.shape
    W = w.shape[0]
    pad = (torch.zeros((B, W - 1, di), dtype=u.dtype, device=u.device)
           if conv_state is None else conv_state)
    full = torch.cat([pad, u], dim=1)                  # (B, S+W-1, di)
    y = sum(full[:, i:i + S] * w[i] for i in range(W))
    new_state = (full[:, -(W - 1):] if W > 1 else
                 torch.zeros((B, 0, di), dtype=u.dtype, device=u.device))
    return y, new_state


def _ssm_scan(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t, a loop over t.  a, b: (B, S, di, n);
    h0: (B, di, n) or None (zeros).  Returns every h: (B, S, di, n)."""
    h = b[:, 0] if h0 is None else a[:, 0] * h0 + b[:, 0]
    hs = [h]
    for t in range(1, a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def apply_ssm(params, x, cfg, *, state=None):
    """x: (B, S, d).  state: None (train / prefill) or the decode state
    {"h": (B, di, n), "conv": (B, W-1, di)}.  Returns (y, new_state)."""
    x_in, z = (x @ params["in_proj"]).chunk(2, dim=-1)  # (B, S, di) each
    conv_state = None if state is None else state["conv"]
    u, new_conv = _causal_conv(x_in, params["conv"], conv_state)
    u = F.silu(u)

    dt = F.softplus((u @ params["dt_lo"]) @ params["dt_hi"]
                    + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())            # (di, n), negative
    Bmat = u @ params["w_B"]                           # (B, S, n)
    Cmat = u @ params["w_C"]

    dtf = dt.float()[..., None]                        # (B, S, di, 1)
    a = torch.exp(dtf * A)                             # (B, S, di, n)
    b = dtf * Bmat[:, :, None, :].float() * u[..., None].float()

    h = _ssm_scan(a, b, None if state is None else state["h"])
    y = torch.einsum("bsdn,bsn->bsd", h, Cmat.float())
    y = y.to(x.dtype) + params["D"] * u
    y = y * F.silu(z)
    return y @ params["out_proj"], {"h": h[:, -1], "conv": new_conv}


def init_ssm_state(cfg, batch: int, dtype=torch.float32, device=None):
    di, n, W = cfg.d_model, cfg.ssm_state, cfg.ssm_conv_width
    return {
        "h": torch.zeros((batch, di, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, W - 1, di), dtype=dtype, device=device),
    }
