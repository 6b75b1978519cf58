"""RANL for deep networks — the paper's optimizer at framework scale.

Port of the reference's ``optim/ranl_llm.py`` on one device:

* workers = slices of the global batch; worker i takes rows
  [i·B/N, (i+1)·B/N) and its gradient comes from one forward and backward
  of its own (a Python loop over workers, where the reference vmaps);
* regions = one per layer (shared by every per-layer leaf) and one per
  glue leaf (embeddings, head, final norm, vision projection), numbered
  in the reference's sorted-key leaf order; glue is protected by default;
* Hessian = the one-shot empirical-Fisher diagonal at x⁰ (mean over
  workers of squared gradients), floored per leaf and reused every round;
* memory = the paper's C_i^{t,q}, each worker's latest gradient per
  region, in bf16 (default) or int8.

``params["layers"]`` is a list of per-layer dicts where the reference
stacks layers on a leading axis; the four places where that layout shows
reproduce the stacked one: region ids (``region_layout``), the Newton
step's statistics over all layers of a leaf (``newton_step``), int8
scales per (worker, layer) (``quantize_memory(layer=True)``) and the
per-region parameter counts.  The reference's mesh plumbing (worker and
batch axes sharded over a data axis) is not ported yet: ``mesh=`` raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..core.masks import PolicyConfig, sample_masks
from ..tree import get, leaf_paths, leaves, num_layers, put, rebuild
from .first_order import value_and_grad

_MESH_ITEM = ("ROADMAP Queue 1 item 14c (sharded deep-net training on "
              "torch.distributed)")


def _no_mesh(mesh, what: str):
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=...) is not ported yet; see {_MESH_ITEM}")


@dataclass(frozen=True)
class RanlLLMConfig:
    num_workers: int
    keep_prob: float = 0.7
    heterogeneous: bool = True
    tau_star: int = 1
    mu: float = 1e-8            # absolute curvature floor of [·]_μ
    mu_rel: float = 0.05        # relative floor: mu_rel * mean(h) per leaf
    lr: float = 1.0             # Newton step scale (paper: 1.0)
    trust_ratio: float = 0.1    # per-leaf cap ‖Δ‖ ≤ trust_ratio·(‖p‖+1)
    protect_glue: bool = True   # glue regions always trained
    memory_dtype: str = "bfloat16"
    # EMA curvature refresh: 0.0 = the one-shot Newton-Zero curvature;
    # beta > 0 folds each round's worker-mean squared gradients in
    precond_beta: float = 0.0
    # int8 gradient memory: per-(worker, region-row) absmax-scaled int8
    memory_int8: bool = False
    # lossy uplink compression of the per-worker gradients before the
    # aggregate (None | "int8" | "bf16")
    compression: str | None = None

    def __post_init__(self):
        if self.compression not in (None, "int8", "bf16"):
            raise ValueError(
                f"unknown compression {self.compression!r} on the LLM "
                f"path (expected None, 'int8' or 'bf16' — 'topk:k' only "
                f"exists on the convex engines, where regions are "
                f"coordinate blocks rather than layers)")

    @property
    def policy(self) -> PolicyConfig:
        return PolicyConfig(name="bernoulli", keep_prob=self.keep_prob,
                            heterogeneous=self.heterogeneous,
                            tau_star=self.tau_star)


# --------------------------------------------------------------------------
# region layout over a params tree
# --------------------------------------------------------------------------

def region_layout(params):
    """Region ids: one per layer, shared by every per-layer leaf, then one
    per glue leaf in the reference's leaf order.

    Returns (num_regions, num_layer_regions, leaf_infos), leaf_infos
    aligned with ``tree.leaf_paths(params)``: ("layer", L) or
    ("glue", region_id).  Every per-layer dict must hold the same leaves
    at the same shapes, as the reference's stacked leaves must agree on
    their depth: else layer q of one leaf and of another would not share
    a region."""
    layers = params.get("layers", [])
    shapes = [[(keys, tuple(get(lp, keys).shape))
               for keys, _ in leaf_paths(lp)] for lp in layers]
    if any(s != shapes[0] for s in shapes):
        raise ValueError(
            "region_layout: the per-layer dicts disagree on their leaves or "
            "shapes — region ids would mis-align across leaves. Give every "
            "layer the same tensors, or move the odd one out of 'layers'.")
    L = len(layers)
    infos, next_glue = [], L
    for _, layered in leaf_paths(params):
        if layered:
            infos.append(("layer", L))
        else:
            infos.append(("glue", next_glue))
            next_glue += 1
    return next_glue, L, infos


def region_param_counts(params):
    """(Q,) f32 parameter count per region: region q < L sums layer q's
    leaves; a glue region is its whole leaf."""
    num_regions, L, infos = region_layout(params)
    counts = [0] * num_regions
    for (keys, layered), (_, v) in zip(leaf_paths(params), infos):
        if layered:
            for q in range(L):
                counts[q] += get(params, keys, q).numel()
        else:
            counts[v] += get(params, keys).numel()
    return torch.tensor(counts, dtype=torch.float32,
                        device=leaves(params)[0].device)


def leaf_masks(masks, infos, protect_glue: bool):
    """masks (N, Q) bool -> one mask a reference leaf: (N, L) for the
    per-layer leaves, (N, 1) for a glue leaf (all True when protected)."""
    out = []
    for kind, v in infos:
        if kind == "layer":
            out.append(masks[:, :v])
        else:
            m = torch.ones_like(masks[:, v]) if protect_glue else masks[:, v]
            out.append(m[:, None])
    return out


def _bshape(mask, ndim: int):
    """Reshape an (N, ...) mask to broadcast against an ndim-d leaf."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def masked_aggregate(G, mask, C):
    """Server aggregation of one leaf (Algorithm 1 lines 15–22).

    G, C: (N, *leaf); mask: bool (N, ...) broadcastable to it.  Returns
    (g, C_new): covered coordinates average the covering workers' G,
    uncovered ones the memory C over all N; C_new is G where the worker
    trained, else C (in C's dtype).  Each worker's contribution is the
    reference's, ``where(covered, m·G/count, C/N)``, added in worker
    order, one worker at a time, so no (N, *leaf) temporary is made."""
    N = G.shape[0]
    m = _bshape(mask, G.ndim)
    mf = m.to(G.dtype)
    count = mf.sum(dim=0)
    covered = count > 0
    count = torch.clamp_min(count, 1.0)
    g = None
    C_new = torch.empty_like(C)
    for i in range(N):
        c_i = C[i].to(G.dtype)
        part = torch.where(covered, mf[i] * G[i] / count, c_i / N)
        g = part if g is None else g + part
        C_new[i] = torch.where(m[i], G[i], c_i).to(C.dtype)
    return g, C_new


# --------------------------------------------------------------------------
# per-worker gradients
# --------------------------------------------------------------------------

def split_batch(batch, num_workers: int):
    return {k: v.reshape(num_workers, v.shape[0] // num_workers,
                         *v.shape[1:]) for k, v in batch.items()}


def per_worker_grads(loss_fn, params, batch, num_workers: int, *,
                     mesh=None):
    """One forward and backward per worker, in worker order.  batch
    leaves (B, ...).  Returns (losses (N,), G): G shaped like ``params``
    with a leading worker axis on every leaf (a leaf the loss does not
    reach gets zeros, as the reference's gradient does)."""
    _no_mesh(mesh, "per_worker_grads")
    wb = split_batch(batch, num_workers)
    G, losses = None, []
    for i in range(num_workers):
        loss, grads = value_and_grad(loss_fn, params,
                                     {k: v[i] for k, v in wb.items()})
        if G is None:
            G = rebuild(params, lambda keys, layer: torch.empty(
                (num_workers,) + tuple(get(grads, keys, layer).shape),
                dtype=get(grads, keys, layer).dtype,
                device=get(grads, keys, layer).device))
        for out, g in zip(leaves(G), leaves(grads)):
            out[i].copy_(g)
        losses.append(loss)
        del grads
    return torch.stack(losses), G


# --------------------------------------------------------------------------
# gradient memory encodings
# --------------------------------------------------------------------------

def quantize_memory(G, *, layer: bool = False):
    """Absmax int8 quantization of a memory leaf, one scale per (worker,
    region-row).  A per-layer leaf (N, ...) is one layer's slice of the
    reference's stacked (N, L, ...) leaf, so ``layer=True`` keeps one
    scale per worker, the reference's one per (worker, layer).  Any other
    leaf reduces as the reference does: over axes 2… when it has more
    than two (an embedding: one scale per (worker, row)), else over
    axis 1."""
    if layer:
        red = tuple(range(1, G.ndim))
    else:
        red = tuple(range(2, G.ndim)) if G.ndim > 2 else (1,)
    Gf = G.float()
    absmax = torch.amax(torch.abs(Gf), dim=red, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-12) / 127.0
    q = torch.clamp(torch.round(Gf / scale), -127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def dequantize_memory(Cq):
    return Cq["q"].float() * Cq["scale"]


def _encode_memory(G, cfg, layer: bool):
    if cfg.memory_int8:
        return quantize_memory(G, layer=layer)
    return G.to(getattr(torch, cfg.memory_dtype))


def _decode_memory(C, cfg, like_dtype):
    if cfg.memory_int8:
        return dequantize_memory(C).to(like_dtype)
    return C.to(like_dtype)


def _sq_mean(G):
    return torch.mean(torch.square(G.float()), dim=0)


# --------------------------------------------------------------------------
# state init / step
# --------------------------------------------------------------------------

def init_state(params, loss_fn, batch, cfg: RanlLLMConfig, key,
               precond_batches=None, mesh=None):
    """Round 0: the one-shot curvature (the workers' mean squared
    gradients at x⁰, averaged over ``precond_batches`` too) and the
    memory seeded with the init gradients."""
    _no_mesh(mesh, "init_state")
    _, G0 = per_worker_grads(loss_fn, params, batch, cfg.num_workers)
    C = rebuild(G0, lambda keys, layer: _encode_memory(
        get(G0, keys, layer), cfg, layer is not None))
    h = rebuild(G0, lambda keys, layer: _sq_mean(get(G0, keys, layer)))
    del G0
    for b in precond_batches or ():
        _, Gb = per_worker_grads(loss_fn, params, b, cfg.num_workers)
        h = rebuild(h, lambda keys, layer: get(h, keys, layer)
                    + _sq_mean(get(Gb, keys, layer)))
        del Gb
    if precond_batches:
        n = 1 + len(precond_batches)
        h = rebuild(h, lambda keys, layer: get(h, keys, layer) / n)
    return {"step": torch.zeros((), dtype=torch.int32), "precond": h,
            "memory": C}


def aggregate(G, memory, masks, params, cfg: RanlLLMConfig):
    """The server's aggregate, leaf by leaf in the reference's order:
    compression of the uplink, then ``masked_aggregate`` against the
    decoded memory, then the new memory encoded.  G's leaves are freed
    as they are used (G is emptied).  Returns (g, C_new, gsq): gsq is the
    worker-mean squared (uncompressed) gradient for the EMA curvature
    refresh, or None when ``precond_beta`` is 0."""
    _, L, infos = region_layout(params)
    lmasks = leaf_masks(masks, infos, cfg.protect_glue)
    g, c_new, gsq = {}, {}, {}
    for (keys, layered), lm in zip(leaf_paths(params), lmasks):
        for layer in (range(L) if layered else (None,)):
            Gl = get(G, keys, layer)
            put(G, keys, layer, None)
            if cfg.precond_beta > 0.0:
                gsq[keys, layer] = _sq_mean(Gl)
            if cfg.compression == "int8":
                Gl = dequantize_memory(
                    quantize_memory(Gl, layer=layered)).to(Gl.dtype)
            elif cfg.compression == "bf16":
                Gl = Gl.to(torch.bfloat16).to(Gl.dtype)
            ml = lm[:, layer] if layered else lm[:, 0]
            Cl = _decode_memory(get(memory, keys, layer), cfg, Gl.dtype)
            g[keys, layer], c = masked_aggregate(Gl, ml, Cl)
            del Gl, Cl
            c_new[keys, layer] = _encode_memory(c, cfg, layered)
            del c

    def out(d):
        return rebuild(params, lambda keys, layer: d[keys, layer])
    return out(g), out(c_new), (out(gsq) if gsq else None)


def newton_step(params, g, precond, cfg: RanlLLMConfig):
    """x − scale·lr·g / max(h, μ + μ_rel·mean h), per reference leaf: the
    mean and the trust ratio's norms ‖Δ‖, ‖p‖ are over all layers of a
    per-layer leaf together (the reference's stacked leaf), and
    scale = min(1, trust_ratio·(‖p‖ + 1) / ‖Δ‖)."""
    L = num_layers(params)
    new = {}
    for keys, layered in leaf_paths(params):
        idx = range(L) if layered else (None,)
        ps = [get(params, keys, i) for i in idx]
        hs = [get(precond, keys, i) for i in idx]
        mean_h = sum(h.sum() for h in hs) / sum(h.numel() for h in hs)
        floor = cfg.mu + cfg.mu_rel * mean_h
        deltas = [cfg.lr * get(g, keys, i).float() / torch.maximum(h, floor)
                  for i, h in zip(idx, hs)]
        dn = torch.sqrt(sum(torch.sum(torch.square(d)) for d in deltas))
        pn = torch.sqrt(sum(torch.sum(torch.square(p.float())) for p in ps))
        scale = torch.clamp_max(cfg.trust_ratio * (pn + 1.0)
                                / torch.clamp_min(dn, 1e-20), 1.0)
        for i, p, d in zip(idx, ps, deltas):
            new[keys, i] = (p.float() - scale * d).to(p.dtype)
    return rebuild(params, lambda keys, layer: new[keys, layer])


def _f32_mean(x):
    """Mean of a bool tensor as the reference's compiled mean takes it:
    the sum times the f32 reciprocal of the count."""
    return x.float().sum() * float(np.float32(1.0) / np.float32(x.numel()))


def train_step(params, state, batch, rng, *, loss_fn, cfg: RanlLLMConfig,
               mesh=None, masks=None):
    """One RANL round.  Returns (new_params, new_state, metrics).

    ``rng``: a ``repro_torch.prng`` key; the round's masks are
    ``sample_masks(cfg.policy, fold_in(rng, step), step, N, Q)``, the
    reference's draw, unless ``masks`` (bool (N, Q)) is given — the hook
    the closed-loop controllers use.  metrics: loss (the workers' mean),
    grad_norm (of the aggregate), coverage (share of regions covered) and
    uplink_frac (share of (worker, region) pairs sent)."""
    _no_mesh(mesh, "train_step")
    num_regions, _, _ = region_layout(params)
    device = leaves(params)[0].device
    step = int(state["step"])
    if masks is None:
        masks = sample_masks(cfg.policy, prng.fold_in(rng, step), step,
                             cfg.num_workers, num_regions, device)
    masks = masks.to(device)
    losses, G = per_worker_grads(loss_fn, params, batch, cfg.num_workers)
    g, C_new, gsq = aggregate(G, state["memory"], masks, params, cfg)

    precond = state["precond"]
    if cfg.precond_beta > 0.0:
        beta = cfg.precond_beta
        precond = rebuild(precond, lambda keys, layer: (
            (1.0 - beta) * get(precond, keys, layer)
            + beta * get(gsq, keys, layer)))
    new_params = newton_step(params, g, precond, cfg)
    new_state = {"step": state["step"] + 1, "precond": precond,
                 "memory": C_new}
    gnorm = torch.sqrt(sum(torch.sum(torch.square(x.float()))
                           for x in leaves(g)))
    metrics = {"loss": losses.mean(), "grad_norm": gnorm,
               "coverage": _f32_mean(masks.any(dim=0)),
               "uplink_frac": _f32_mean(masks)}
    return new_params, new_state, metrics
