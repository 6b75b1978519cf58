"""Plain RWKV-6 (Finch, arXiv:2404.05892): token shift, time mix with a
data-dependent decay and the wkv recurrence, channel mix, an untied
head.

    y_t = r_t · (S + u ⊙ k_t v_tᵀ),   S ← diag(w_t) S + k_t v_tᵀ,
    w_t = exp(−exp(decay_base + tanh(x_w · decay_lo) · decay_hi))

Layout of a layer, as the program holds it: ``ln1``, ``tmix.{mu (5, d)
for r, k, v, w, g; w_r, w_k, w_v, w_g, decay_base, decay_lo (d, 64),
decay_hi (64, d), bonus_u (H, hd), ln_x (hd,), w_o}``, ``ln2``,
``cmix.{mu (2, d), w_k, w_v, w_r}``.  The recurrence runs a chunk of
steps at a time (``wkv``; ``wkv_loop`` is the step-by-step form it is
tested against), f32, no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LORA = 64
CHUNK = 32        # steps of the recurrence taken together


def _dims(cfg):
    hd = cfg["rwkv_head_dim"]
    d = cfg["d_model"]
    return d, d // hd, hd, cfg["d_ff"], cfg["vocab_size"], cfg["num_layers"]


def param_specs(cfg):
    d, H, hd, ff, V, L = _dims(cfg)

    def dense(fan_in, fan_out, std=None):
        return (fan_in, fan_out), ("normal", std or fan_in ** -0.5)
    specs = [(("embed",), (V, d), ("normal", 0.02)),
             (("lm_head",), *dense(d, V))]
    for i in range(L):
        p = ("layers", i)
        t = p + ("tmix",)
        c = p + ("cmix",)
        specs += [
            (p + ("ln1",), (d,), ("const", 1.0)),
            (t + ("mu",), (5, d), ("const", 0.5)),
            (t + ("w_r",), *dense(d, H * hd)),
            (t + ("w_k",), *dense(d, H * hd)),
            (t + ("w_v",), *dense(d, H * hd)),
            (t + ("w_g",), *dense(d, H * hd)),
            (t + ("decay_base",), (H * hd,), ("const", -6.0)),
            (t + ("decay_lo",), *dense(d, LORA, 0.01)),
            (t + ("decay_hi",), *dense(LORA, H * hd, 0.01)),
            (t + ("bonus_u",), (H, hd), ("normal", 0.5)),
            (t + ("ln_x",), (hd,), ("const", 1.0)),
            (t + ("w_o",), *dense(H * hd, d)),
            (p + ("ln2",), (d,), ("const", 1.0)),
            (c + ("mu",), (2, d), ("const", 0.5)),
            (c + ("w_k",), *dense(d, ff)),
            (c + ("w_v",), *dense(ff, d)),
            (c + ("w_r",), *dense(d, d)),
        ]
    specs.append((("final_norm",), (d,), ("const", 1.0)))
    return specs


def rms_norm(x, scale, eps: float = 1e-6):
    inv = torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return x * inv * scale


def shift(x):
    """x_{t−1}, zeros at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv_loop(r, k, v, w, u):
    """The recurrence one step at a time: r, k, v, w (B, S, H, hd), u
    (H, hd), zero initial state -> y (B, S, H, hd)."""
    B, S, H, hd = r.shape
    state = torch.zeros(B, H, hd, hd, dtype=r.dtype, device=r.device)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1)


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """The same recurrence, ``chunk`` steps at a time, from the log
    decays (``log w_t``, all ≤ 0).  With L_t = Σ_{j≤t} log w_j inside a
    chunk and S₀ the state carried into it,

        y_t = r_t·(e^{L_{t−1}} ⊙ S₀) + Σ_{s<t} (Σ_i r_ti k_si e^{L_{t−1,i} − L_si}) v_s
              + (Σ_i r_ti u_i k_ti) v_t,
        S   = e^{L_last} ⊙ S₀ + Σ_s (e^{L_last − L_s} ⊙ k_s) v_sᵀ;

    every exponent is a sum of log decays, so none exceeds 0."""
    B, S, H, hd = r.shape
    state = torch.zeros(B, H, hd, hd, dtype=r.dtype, device=r.device)
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lw = (x[:, c0:c0 + chunk].transpose(1, 2)
                          for x in (r, k, v, logw))       # (B, H, C, hd)
        C = rc.shape[2]
        L = torch.cumsum(lw, dim=2)
        Lprev = L - lw
        y = torch.einsum("bhti,bhij->bhtj", rc * torch.exp(Lprev), state)
        earlier = torch.ones(C, C, dtype=torch.bool,
                             device=r.device).tril(-1)[:, :, None]
        decay = torch.exp((Lprev[:, :, :, None, :] - L[:, :, None, :, :])
                          .masked_fill(~earlier, float("-inf")))
        A = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, decay)
        bonus = (rc * u[None, :, None, :] * kc).sum(dim=-1, keepdim=True)
        ys.append(y + A @ vc + bonus * vc)
        last = L[:, :, -1:, :]
        state = (torch.exp(last).transpose(2, 3) * state
                 + torch.einsum("bhsi,bhsj->bhij", kc * torch.exp(last - L),
                                vc))
    return torch.cat(ys, dim=2).transpose(1, 2)


def time_mix(p, x, cfg):
    d, H, hd, _, _, _ = _dims(cfg)
    B, S, _ = x.shape
    xs = shift(x)
    xr, xk, xv, xw, xg = (x + (xs - x) * p["mu"][i] for i in range(5))
    r = (xr @ p["w_r"]).reshape(B, S, H, hd)
    k = (xk @ p["w_k"]).reshape(B, S, H, hd)
    v = (xv @ p["w_v"]).reshape(B, S, H, hd)
    g = F.silu(xg @ p["w_g"])
    dlog = p["decay_base"] + torch.tanh(xw @ p["decay_lo"]) @ p["decay_hi"]
    logw = -torch.exp(dlog).reshape(B, S, H, hd)          # log w_t
    y = rms_norm(wkv(r, k, v, logw, p["bonus_u"]), p["ln_x"])
    return (y.reshape(B, S, H * hd) * g) @ p["w_o"]


def channel_mix(p, x):
    xs = shift(x)
    xk = x + (xs - x) * p["mu"][0]
    xr = x + (xs - x) * p["mu"][1]
    kk = torch.square(torch.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (kk @ p["w_v"])


def loss(params, batch, cfg):
    x = params["embed"][batch["tokens"].long()]
    for lp in params["layers"]:
        x = x + time_mix(lp["tmix"], rms_norm(x, lp["ln1"]), cfg)
        x = x + channel_mix(lp["cmix"], rms_norm(x, lp["ln2"]))
    logits = rms_norm(x, params["final_norm"]) @ params["lm_head"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           batch["labels"].reshape(-1).long())


def matmul_params(cfg):
    d, H, hd, ff, V, L = _dims(cfg)
    tmix = 5 * d * H * hd + 2 * d * LORA        # r, k, v, g, o; decay lora
    cmix = 2 * d * ff + d * d
    return L * (tmix + cmix) + d * V


def extra_flops(cfg, batch: int, seq: int) -> float:
    """The wkv recurrence: 5·hd² a (token, head) forward (k vᵀ, S + u⊙kv,
    r·(…), w⊙S + kv), twice that backward, nothing recomputed."""
    d, H, hd, _, _, L = _dims(cfg)
    return 15.0 * hd * hd * batch * seq * H * L


def kernel_shapes(cfg, batch: int, seq: int):
    """{"wkv": (B, S, H, hd)} of one worker's call."""
    d, H, hd, _, _, _ = _dims(cfg)
    return {"wkv": (batch, seq, H, hd)}
