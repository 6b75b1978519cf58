"""First-order baselines (the paper's comparison class): SGD, AdamW.

Port of the reference's ``optim/first_order.py``: plain functions over
parameter trees (nested dicts, per-layer lists).  AdamW keeps its moments
in f32, takes the bias corrections from the f32 step count, and casts the
updated parameter back to its own dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..obs.trace import span
from ..tree import from_leaves, get, leaves, rebuild, tree_map


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` and its gradient with
    respect to every leaf of ``params`` (zeros for a leaf the loss does
    not reach, as the reference's gradient has).  Under an active tracer
    the two passes are the spans ``forward`` and ``backward``."""
    live = rebuild(params, lambda keys, layer:
                   get(params, keys, layer).detach().requires_grad_(True))
    wrt = leaves(live)
    with torch.enable_grad():
        with span("forward", device=wrt[0].device):
            loss = loss_fn(live, batch)
        with span("backward", device=wrt[0].device):
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return loss.detach(), from_leaves(params, [
        torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)])


@dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.0


def sgd_init(params, cfg: SGDConfig):
    if cfg.momentum:
        return {"m": tree_map(torch.zeros_like, params)}
    return {}


def sgd_step(params, state, grads, cfg: SGDConfig):
    if cfg.momentum:
        m = tree_map(lambda m_, g: cfg.momentum * m_ + g, state["m"], grads)
        return tree_map(lambda p, m_: p - cfg.lr * m_, params, m), {"m": m}
    return tree_map(lambda p, g: p - cfg.lr * g, params, grads), state


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0


def adamw_init(params, cfg: AdamWConfig):
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32),
            "m": tree_map(z, params), "v": tree_map(z, params)}


def _bias_correction(beta: float, t) -> float:
    """1 − beta^t in f32 (the value, as a Python float)."""
    f32 = torch.float32
    return float(1.0 - torch.pow(torch.tensor(beta, dtype=f32), t.to(f32)))


def adamw_step(params, state, grads, cfg: AdamWConfig):
    t = state["step"] + 1
    b1t = _bias_correction(cfg.b1, t)
    b2t = _bias_correction(cfg.b2, t)

    def upd(p, g, m, v):
        gf = g.float()
        m_ = cfg.b1 * m + (1 - cfg.b1) * gf
        v_ = cfg.b2 * v + (1 - cfg.b2) * torch.square(gf)
        step = cfg.lr * (m_ / b1t) / (torch.sqrt(v_ / b2t) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.lr * cfg.weight_decay * p.float()
        return (p.float() - step).to(p.dtype), m_, v_

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                           for i in range(3))
    return new_p, {"step": t, "m": new_m, "v": new_v}
