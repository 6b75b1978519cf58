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
per-region parameter counts.  The layers may hold different leaves (the
paper's sub-model diversity: dense and expert FFNs in one model): each
layer is still one region, and a per-layer leaf's Newton statistics run
over the layers that hold it (``tree.holders``).  The mesh path keeps
the stacked layout and refuses such a model.

With ``mesh=`` (a ``DeviceMesh`` with a "data" dimension, and "pod" and
"model" ones where wanted; ``launch.mesh.make_engine_mesh``) the step
runs SPMD on every rank, the reference's ``mesh=`` path:

* workers over the plane ("pod", "data"): rank p of the plane (pod-major)
  owns workers [p·n, (p+1)·n), n = N / plane size, and runs only their
  forwards and backwards on its rows of the global batch, which reaches
  every rank whole;
* masks drawn on every rank from the same key (replicated), so the
  coverage counts need no collective;
* each rank's workers' contributions ``where(covered, m·G/count, C/N)``
  summed into one flat f32 buffer (with the N losses, and, under
  ``precond_beta``, the squared gradients), then ONE all-reduce over the
  plane a step — the reference's single-reduction form; memory C stays
  on the rank that owns the worker;
* over "model" M: params, precond and memory are stored as this rank's
  shard, on the dim ``launch.shard.params_pspecs`` names.  Every model
  rank runs each of its workers' whole forward on params all-gathered
  over "model" (one all-gather a step), compresses and encodes the
  worker's full gradient, and keeps its shard of it: no (N, *leaf)
  gradient is ever made.  The Newton step's ‖Δ‖ and the grad norm sum
  over "model" in one small all-reduce a step; mean(h) comes from
  partial sums that ride the all-gather, ‖p‖ from the gathered params.

``pspecs`` (``{"state": launch.shard.ranl_state_pspecs(full params,
M)}``) tells which dim of each leaf is cut; it is needed when M > 1.
Every collective goes through a ``core.collectives.Collectives``
recorder (``coll=``), whose log ``analysis.contracts.train_contract``
holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..core.collectives import Collectives
from ..core.masks import PolicyConfig, sample_masks
from ..kernels import ops
# the plain version under the reference's name, for callers of the module
from ..kernels.ref import masked_aggregate_ref as masked_aggregate  # noqa: F401
from ..launch.shard import BATCH, MODEL, local_shard, model_dim
from ..obs.trace import count, span
from ..tree import (get, holders, leaf_paths, leaves, num_layers, put,
                    rebuild, require_uniform_layers)
from .first_order import value_and_grad


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
    ("glue", region_id).  The per-layer dicts may hold different leaves
    (region q is layer q's, whichever it holds), but a leaf held by
    several layers must have one shape in all of them, as the reference's
    stacked leaf has."""
    layers = params.get("layers", [])
    for keys, layered in leaf_paths(params):
        if layered and len({tuple(get(params, keys, q).shape)
                            for q in holders(params, keys)}) > 1:
            raise ValueError(
                f"region_layout: the per-layer dicts disagree on the shape "
                f"of {'/'.join(keys)} — one leaf of several layers is one "
                f"group of the Newton step. Give it one shape, or another "
                f"name where it differs.")
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
            for q in holders(params, keys):
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


# --------------------------------------------------------------------------
# per-worker gradients
# --------------------------------------------------------------------------

def split_batch(batch, num_workers: int):
    return {k: v.reshape(num_workers, v.shape[0] // num_workers,
                         *v.shape[1:]) for k, v in batch.items()}


def per_worker_grads(loss_fn, params, batch, num_workers: int, *,
                     mesh=None, pspecs=None, coll=None):
    """One forward and backward per worker, in worker order.  batch
    leaves (B, ...).  Returns (losses (N,), G): G shaped like ``params``
    with a leading worker axis on every leaf (a leaf the loss does not
    reach gets zeros, as the reference's gradient does).

    With ``mesh``: ``params`` is this rank's shard; only this rank's
    workers run, and it returns their losses (n,) and its shard of their
    gradients, (n, *shard) a leaf."""
    if mesh is not None:
        return _per_worker_grads_mesh(loss_fn, params, batch, num_workers,
                                      _Mesh(mesh, params, coll, pspecs,
                                            num_workers))
    wb = split_batch(batch, num_workers)
    device = leaves(params)[0].device
    G, losses = None, []
    for i in range(num_workers):
        with span("ranl.worker_pass", device=device, worker=i):
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
    with span("ranl.memory_encode", device=G.device):
        if cfg.memory_int8:
            return quantize_memory(G, layer=layer)
        return G.to(getattr(torch, cfg.memory_dtype))


def _decode_memory(C, cfg, like_dtype):
    with span("ranl.memory_decode",
              device=(C["q"] if cfg.memory_int8 else C).device):
        if cfg.memory_int8:
            return dequantize_memory(C).to(like_dtype)
        return C.to(like_dtype)


def _sq_mean(G):
    return torch.mean(torch.square(G.float()), dim=0)


# --------------------------------------------------------------------------
# state init / step
# --------------------------------------------------------------------------

def init_state(params, loss_fn, batch, cfg: RanlLLMConfig, key,
               precond_batches=None, mesh=None, pspecs=None, coll=None):
    """Round 0: the one-shot curvature (the workers' mean squared
    gradients at x⁰, averaged over ``precond_batches`` too) and the
    memory seeded with the init gradients.  With ``mesh``: ``params`` is
    this rank's shard, and so is the state returned (memory: this rank's
    workers only); the curvature is one plane all-reduce."""
    if mesh is not None:
        return _init_state_mesh(params, loss_fn, batch, cfg,
                                precond_batches,
                                _Mesh(mesh, params, coll, pspecs,
                                      cfg.num_workers))
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
    compression of the uplink, then the masked combine against the stored
    memory, which writes the new memory.  G's leaves are freed as they
    are used (G is emptied).  Returns (g, C_new, gsq): gsq is the
    worker-mean squared (uncompressed) gradient for the EMA curvature
    refresh, or None when ``precond_beta`` is 0.

    Each leaf goes to ``ops.masked_aggregate`` (the kernel on the card,
    which takes an f32 G) with the memory as it is stored, so no f32
    copy of it is made.  An int8 memory is decoded to G's type ahead of
    the combine and its new memory encoded after it (spans
    ``ranl.memory_decode``/``ranl.memory_encode``)."""
    _, _, infos = region_layout(params)
    lmasks = leaf_masks(masks, infos, cfg.protect_glue)
    g, c_new, gsq = {}, {}, {}
    for (keys, layered), lm in zip(leaf_paths(params), lmasks):
        for layer in (holders(params, keys) if layered else (None,)):
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
            Cl = get(memory, keys, layer)
            if cfg.memory_int8:
                Cl = _decode_memory(Cl, cfg, Gl.dtype)
            g[keys, layer], c = ops.masked_aggregate(Gl, ml, Cl)
            del Gl, Cl
            if cfg.memory_int8:
                c = _encode_memory(c, cfg, layered)
            c_new[keys, layer] = c
            del c

    def out(d):
        return rebuild(params, lambda keys, layer: d[keys, layer])
    return out(g), out(c_new), (out(gsq) if gsq else None)


def _groups(params, *trees):
    """[(keys, layers)] of the Newton step's groups (a per-layer leaf of
    every layer that holds it, or one glue leaf) and, for each tree, its
    leaves as groups."""
    idx = [(keys, holders(params, keys) if layered else [None])
           for keys, layered in leaf_paths(params)]
    return idx, [[[get(t, keys, q) for q in qs] for keys, qs in idx]
                 for t in trees]


def _ungroup(params, idx, groups):
    """A tree shaped like ``params`` from leaves given as ``_groups``
    gives them."""
    out = {(keys, q): t for (keys, qs), grp in zip(idx, groups)
           for q, t in zip(qs, grp)}
    return rebuild(params, lambda keys, layer: out[keys, layer])


def newton_step(params, g, precond, cfg: RanlLLMConfig):
    """x − scale·lr·g / max(h, μ + μ_rel·mean h), per reference leaf: the
    mean and the trust ratio's norms ‖Δ‖, ‖p‖ are over all layers of a
    per-layer leaf together (the reference's stacked leaf; the layers
    that hold it), and scale = min(1, trust_ratio·(‖p‖ + 1) / ‖Δ‖).
    ``ops.newton_step``: the kernels on the card (three launches for the
    whole tree), the plain version on the CPU.  Returns (new params, ‖g‖
    of the aggregate, from the same pass as ‖Δ‖)."""
    idx, (ps, gs, hs) = _groups(params, params, g, precond)
    new, stats = ops.newton_step(ps, gs, hs, lr=cfg.lr, mu=cfg.mu,
                                 mu_rel=cfg.mu_rel, trust=cfg.trust_ratio)
    return _ungroup(params, idx, new), torch.sqrt(stats[:, 3].sum())


def _f32_mean(x):
    """Mean of a bool tensor as the reference's compiled mean takes it:
    the sum times the f32 reciprocal of the count."""
    return x.float().sum() * float(np.float32(1.0) / np.float32(x.numel()))


def _round_masks(params, state, rng, cfg, masks):
    num_regions, _, _ = region_layout(params)
    device = leaves(params)[0].device
    step = int(state["step"])
    if masks is None:
        masks = sample_masks(cfg.policy, prng.fold_in(rng, step), step,
                             cfg.num_workers, num_regions, device)
    return step, masks.to(device)


def train_step(params, state, batch, rng, *, loss_fn, cfg: RanlLLMConfig,
               mesh=None, pspecs=None, masks=None, coll=None):
    """One RANL round.  Returns (new_params, new_state, metrics).

    ``rng``: a ``repro_torch.prng`` key; the round's masks are
    ``sample_masks(cfg.policy, fold_in(rng, step), step, N, Q)``, the
    reference's draw, unless ``masks`` (bool (N, Q)) is given — the hook
    the closed-loop controllers use.  metrics: loss (the workers' mean),
    grad_norm (of the aggregate), coverage (share of regions covered) and
    uplink_frac (share of (worker, region) pairs sent).

    With ``mesh`` (SPMD: every rank calls it with the same arguments):
    ``params`` and ``state`` are this rank's shards, as ``init_state``
    returns them, and so are the new ones; the metrics are every rank's.
    ``pspecs``: ``{"state": launch.shard.ranl_state_pspecs(full params,
    M)}``, needed when the mesh has M > 1 model shards.  ``coll``: the
    ``Collectives`` recorder to log into (a new one when None); the
    step's collectives are logged as round ``step + 1``.

    Under an active tracer (``obs.tracing``) the round is the span
    ``ranl.round``, holding ``ranl.worker_pass`` (each with ``forward``
    and ``backward``), ``ranl.aggregate`` (with ``ranl.memory_decode``
    and ``ranl.memory_encode`` a leaf where the memory is int8, and on a
    mesh wherever a worker's memory is decoded or encoded),
    ``ranl.newton`` and, on a mesh,
    ``ranl.exchange``; each place the host waits on the card adds to the
    counter ``host_syncs``."""
    m = None if mesh is None else _Mesh(mesh, params, coll, pspecs,
                                        cfg.num_workers)
    step, masks = _round_masks(params, state, rng, cfg, masks)
    with span("ranl.round", device=masks.device):
        if m is not None:
            return _train_step_mesh(params, state, batch, step, masks,
                                    loss_fn, cfg, m)
        # through the module's globals, so a caller may wrap each phase
        losses, G = per_worker_grads(loss_fn, params, batch,
                                     cfg.num_workers)
        with span("ranl.aggregate", device=masks.device):
            g, C_new, gsq = aggregate(G, state["memory"], masks, params,
                                      cfg)

        precond = state["precond"]
        if cfg.precond_beta > 0.0:
            beta = cfg.precond_beta
            precond = rebuild(precond, lambda keys, layer: (
                (1.0 - beta) * get(precond, keys, layer)
                + beta * get(gsq, keys, layer)))
        with span("ranl.newton", device=masks.device):
            new_params, gnorm = newton_step(params, g, precond, cfg)
        new_state = {"step": state["step"] + 1, "precond": precond,
                     "memory": C_new}
        metrics = {"loss": losses.mean(), "grad_norm": gnorm,
                   "coverage": _f32_mean(masks.any(dim=0)),
                   "uplink_frac": _f32_mean(masks)}
        return new_params, new_state, metrics


# --------------------------------------------------------------------------
# the mesh path: workers over ("pod", "data"), params and state over "model"
# --------------------------------------------------------------------------

def _port_leaves(tree):
    """[(keys, layered, layer)]: every leaf, each layer's apart, in the
    reference's order."""
    L = num_layers(tree)
    return [(keys, layered, layer) for keys, layered in leaf_paths(tree)
            for layer in (range(L) if layered else (None,))]


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


class _Mesh:
    """One call's view of the mesh: the worker plane and this rank's
    workers in it, the model extent and rank, and the dim of each leaf
    that "model" cuts (from ``pspecs``; none when M is 1)."""

    def __init__(self, mesh, params, coll, pspecs, num_workers=None):
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, "
                            f"got {type(mesh).__name__}")
        require_uniform_layers(params, "the mesh path")
        names = tuple(mesh.mesh_dim_names or ())
        self.plane = tuple(a for a in BATCH if a in names)
        if not self.plane:
            raise ValueError(f"mesh {names} has no 'data' axis to shard "
                             f"workers over")
        self.coll = Collectives(mesh) if coll is None else coll
        n = self.coll.size(self.plane)
        if num_workers is not None:
            if num_workers % n:
                raise ValueError(
                    f"num_workers={num_workers} must divide evenly across "
                    f"the {n}-way {self.plane} mesh axes")
            self.n_local = num_workers // n
            self.start = self.coll.rank(self.plane) * self.n_local
        self.n_model = self.coll.size(MODEL) if MODEL in names else 1
        self.m_rank = self.coll.rank(MODEL) if self.n_model > 1 else 0
        specs = None
        if self.n_model > 1:
            if not pspecs or "state" not in pspecs:
                raise ValueError(
                    f"a mesh with {self.n_model} model shards needs "
                    f"pspecs={{'state': launch.shard.ranl_state_pspecs("
                    f"full params, {self.n_model})}}: a shard does not "
                    f"tell which dim was cut")
            specs = pspecs["state"]["precond"]
        self.dims = {(keys, layer): (None if specs is None else model_dim(
            get(specs, keys, layer))) for keys, _, layer in
            _port_leaves(params)}

    def cut(self, t, key, lead: int = 0):
        """This rank's shard of a full leaf (``lead`` leading axes before
        the leaf's own)."""
        d = self.dims[key]
        return local_shard(t, None if d is None else d + lead, self.m_rank,
                           self.n_model)

    def scale_cut(self, key, ndim: int) -> bool:
        """Whether the int8 scale of a memory leaf of ``ndim`` dims (the
        worker axis included) keeps the cut dim: only a glue leaf of two
        or more dims keeps its dim 0 (a scale a (worker, row))."""
        return key[1] is None and ndim > 2 and self.dims[key] == 0

    def cut_encoded(self, enc, key):
        """One worker's encoded memory leaf (a leading axis of 1) cut to
        this rank's shard."""
        if not isinstance(enc, dict):
            return self.cut(enc, key, 1)
        scale = enc["scale"]
        if self.scale_cut(key, enc["q"].ndim):
            scale = self.cut(scale, key, 1)
        return {"q": self.cut(enc["q"], key, 1), "scale": scale}

    def full(self, params, extra=None):
        """(params all-gathered over "model", every model rank's
        ``extra`` (f32 (k,)) as (M, k)) — one all-gather of the cut
        leaves' bytes and ``extra``; no collective when M is 1."""
        if self.n_model == 1:
            return params, None
        cut = [(key, get(params, *key)) for key, d in self.dims.items()
               if d is not None]
        parts, sizes = [], []
        for _, t in cut + ([(None, extra.float())] if extra is not None
                           else []):
            b = t.contiguous().view(-1).view(torch.uint8)
            sizes.append(_pad16(b.numel()))
            parts.append(torch.nn.functional.pad(
                b, (0, sizes[-1] - b.numel())))
        flat = torch.cat(parts)
        del parts
        with span("ranl.exchange", device=flat.device,
                  op="all_gather:model"):
            wire = self.coll.all_gather(flat, "model")
        del flat
        vals, off = {}, 0
        for (key, t), nb in zip(cut, sizes):
            n = t.numel() * t.element_size()
            vals[key] = torch.cat(
                [wire[r, off:off + n].view(t.dtype).view(t.shape)
                 for r in range(self.n_model)], dim=self.dims[key])
            off += nb
        got = None
        if extra is not None:
            got = wire[:, off:off + extra.numel() * 4].contiguous().view(
                torch.float32)
        del wire
        return rebuild(params, lambda keys, layer: vals.get(
            (keys, layer), get(params, keys, layer))), got

    def flat(self, params, device, copies: int = 1, extra: int = 0):
        """(a zero f32 buffer of ``copies`` passes over this rank's
        shard plus ``extra`` floats, [{key: a view shaped like the leaf}
        for each pass])"""
        n = sum(get(params, *key).numel() for key in self.dims)
        buf = torch.zeros(copies * n + extra, dtype=torch.float32,
                          device=device)
        views, off = [], 0
        for _ in range(copies):
            v = {}
            for key in self.dims:
                t = get(params, *key)
                v[key] = buf[off:off + t.numel()].view(t.shape)
                off += t.numel()
            views.append(v)
        return buf, views, n

    def worker_batches(self, batch, num_workers: int):
        """[(global worker index, its rows of ``batch``)] for this rank's
        workers."""
        wb = split_batch(batch, num_workers)
        return [(i, {k: v[i] for k, v in wb.items()})
                for i in range(self.start, self.start + self.n_local)]


def _put_worker(store, key, j: int, n: int, enc):
    """``store[key][j] = enc`` (one worker's leaf, a leading axis of 1),
    allocating ``store[key]`` with ``n`` workers at first use."""
    if isinstance(enc, dict):
        if key not in store:
            store[key] = {k: v.new_empty((n,) + v.shape[1:])
                          for k, v in enc.items()}
        for k, v in enc.items():
            store[key][k][j] = v[0]
    else:
        if key not in store:
            store[key] = enc.new_empty((n,) + enc.shape[1:])
        store[key][j] = enc[0]


def _worker_of(C, j: int):
    """Worker ``j``'s row of a memory leaf, keeping a leading axis."""
    if isinstance(C, dict):
        return {k: v[j:j + 1] for k, v in C.items()}
    return C[j:j + 1]


def _per_worker_grads_mesh(loss_fn, params, batch, num_workers, m):
    full, _ = m.full(params)
    losses, G = [], {}
    for j, (_, b) in enumerate(m.worker_batches(batch, num_workers)):
        loss, grads = value_and_grad(loss_fn, full, b)
        for key in m.dims:
            _put_worker(G, key, j, m.n_local, m.cut(get(grads, *key)[None],
                                                   key, 1))
        losses.append(loss)
        del grads
    return torch.stack(losses), rebuild(params, lambda keys, layer:
                                        G[keys, layer])


def _init_state_mesh(params, loss_fn, batch, cfg, precond_batches, m):
    device = leaves(params)[0].device
    full, _ = m.full(params)
    buf, (h,), _ = m.flat(params, device)
    C = {}
    batches = [batch, *(precond_batches or ())]
    for bi, b in enumerate(batches):
        for j, (_, wb) in enumerate(m.worker_batches(b, cfg.num_workers)):
            _, grads = value_and_grad(loss_fn, full, wb)
            for keys, layered, layer in _port_leaves(params):
                G = get(grads, keys, layer)
                h[keys, layer] += torch.square(m.cut(G, (keys, layer)).float())
                if bi == 0:
                    _put_worker(C, (keys, layer), j, m.n_local,
                                m.cut_encoded(_encode_memory(
                                    G[None], cfg, layered), (keys, layer)))
            del grads
    del full
    m.coll.all_reduce(buf, m.plane)
    buf /= cfg.num_workers * len(batches)
    return {"step": torch.zeros((), dtype=torch.int32),
            "precond": rebuild(params, lambda keys, layer: h[keys, layer]),
            "memory": rebuild(params, lambda keys, layer: C[keys, layer])}


def _train_step_mesh(params, state, batch, step, masks, loss_fn, cfg, m):
    N, beta = cfg.num_workers, cfg.precond_beta
    device = leaves(params)[0].device
    _, L, infos = region_layout(params)
    refs = leaf_paths(params)
    idx = {keys: (range(L) if layered else (None,)) for keys, layered in refs}
    cut = [keys for keys, _ in refs if m.dims[keys, idx[keys][0]] is not None]
    # a leaf's mask is one bool a worker: the covered/uncovered choice and
    # the count are made on the host, so no branch is computed twice
    count("host_syncs")     # masks.cpu() waits for the card
    on = {}
    for (keys, layered), hm in zip(refs, leaf_masks(masks.cpu(), infos,
                                                    cfg.protect_glue)):
        for layer in idx[keys]:
            on[keys, layer] = hm[:, 0 if layer is None else layer].tolist()
    saved, m.coll.round = m.coll.round, step + 1
    precond = state["precond"]
    # mean(h) of a cut leaf: this rank's partial sums ride the all-gather
    hpart = (torch.stack([sum(get(precond, keys, q).float().sum()
                              for q in idx[keys]) for keys in cut])
             if cut else None)
    full, hparts = m.full(params, hpart)
    # ‖p‖² of a cut leaf from the gathered one; the Newton step's first
    # pass takes every other leaf's
    pn2 = {keys: sum(torch.sum(torch.square(get(full, keys, q).float()))
                     for q in idx[keys]) for keys in cut}
    copies = 2 if beta > 0.0 else 1
    buf, views, P = m.flat(params, device, copies,
                           N + (len(refs) if beta > 0.0 else 0))
    gv = views[0]
    losses = buf[copies * P:copies * P + N]
    C_new = {}
    for j, (i, wb) in enumerate(m.worker_batches(batch, N)):
        with span("ranl.worker_pass", device=device, worker=i):
            loss, grads = value_and_grad(loss_fn, full, wb)
            losses[i] = loss
        with span("ranl.aggregate", device=device):
            for r, (keys, layered) in enumerate(refs):
                for layer in idx[keys]:
                    key = (keys, layer)
                    G = get(grads, keys, layer)
                    if beta > 0.0:
                        views[1][key] += torch.square(m.cut(G, key).float())
                        buf[copies * P + N + r] += torch.sum(
                            torch.square(G.float()))
                    if cfg.compression == "int8":
                        G = dequantize_memory(quantize_memory(
                            G[None], layer=layered))[0].to(G.dtype)
                    elif cfg.compression == "bf16":
                        G = G.to(torch.bfloat16).to(G.dtype)
                    n_on = sum(on[key])
                    Gs = m.cut(G, key)
                    C_j = _worker_of(get(state["memory"], keys, layer), j)
                    if not n_on:            # uncovered: the memory's mean
                        gv[key] += _decode_memory(C_j, cfg, G.dtype)[0] / N
                    elif on[key][i]:        # m·G/count; 0 where m is off
                        gv[key] += Gs / float(n_on)
                    if not on[key][i]:
                        enc = C_j
                    elif cfg.memory_int8:
                        enc = m.cut_encoded(_encode_memory(G[None], cfg,
                                                           layered), key)
                    else:
                        enc = _encode_memory(Gs[None], cfg, layered)
                    _put_worker(C_new, key, j, m.n_local, enc)
        del grads
    del full
    with span("ranl.exchange", device=device,
              op="all_reduce:" + "+".join(m.plane)):
        m.coll.all_reduce(buf, m.plane)
    g = rebuild(params, lambda keys, layer: gv[keys, layer].to(
        get(params, keys, layer).dtype))
    hsum = {}
    if hparts is not None:
        hsum = dict(zip(cut, hparts.sum(dim=0)))
    if beta > 0.0:
        gsq = {key: v / N for key, v in views[1].items()}
        precond = rebuild(precond, lambda keys, layer: (
            (1.0 - beta) * get(precond, keys, layer)
            + beta * gsq[keys, layer]))
        for r, (keys, _) in enumerate(refs):
            if keys in hsum:
                hsum[keys] = ((1.0 - beta) * hsum[keys]
                              + beta * buf[copies * P + N + r] / N)

    groups, (ps, gs, hs) = _groups(params, params, g, precond)
    on_model = [j for j, (keys, _) in enumerate(groups) if keys in hsum]
    model_gn2 = []

    def over_model(stats):
        """‖Δ‖² and ‖g‖² of the cut leaves: one small all-reduce over
        "model"."""
        if not on_model:
            return
        small = torch.stack([stats[j, 1] for j in on_model]
                            + [sum(stats[j, 3] for j in on_model)])
        with span("ranl.exchange", device=device, op="all_reduce:model"):
            m.coll.all_reduce(small, MODEL)
        for i, j in enumerate(on_model):
            stats[j, 1] = small[i]
        model_gn2.append(small[-1])

    with span("ranl.newton", device=device):
        new, stats = ops.newton_step(
            ps, gs, hs, lr=cfg.lr, mu=cfg.mu, mu_rel=cfg.mu_rel,
            trust=cfg.trust_ratio,
            hsum=[(hsum[keys], sum(h.numel() for h in hg) * m.n_model)
                  if keys in hsum else None
                  for (keys, _), hg in zip(groups, hs)],
            pn2=[pn2.get(keys) for keys, _ in groups], between=over_model)
    gn2 = sum(stats[j, 3] for j in range(len(groups))
              if j not in on_model) + sum(model_gn2)
    m.coll.round = saved
    metrics = {"loss": losses.mean(), "grad_norm": torch.sqrt(gn2),
               "coverage": _f32_mean(masks.any(dim=0)),
               "uplink_frac": _f32_mean(masks)}
    return (_ungroup(params, groups, new),
            {"step": state["step"] + 1, "precond": precond,
             "memory": rebuild(params, lambda keys, layer:
                               C_new[keys, layer])},
            metrics)


def shard_params(params, mesh, pspecs=None):
    """This rank's shard of full ``params`` (every rank holds the same):
    each leaf cut on the dim ``pspecs["state"]`` names for "model"; the
    inverse of ``gather_tree``."""
    m = _Mesh(mesh, params, None, pspecs)
    return rebuild(params, lambda keys, layer: m.cut(
        get(params, keys, layer), (keys, layer)))


def gather_tree(tree, mesh, pspecs=None, coll=None, *, workers=False):
    """A tree of this rank's shards put back together on every rank: each
    leaf all-gathered over "model" on its cut dim (``pspecs`` as for
    ``train_step``), and, with ``workers``, over the worker plane on dim
    0 (memory leaves: every worker's row).  An int8 memory leaf gathers
    its codes, and its scales where they keep the cut dim."""
    m = _Mesh(mesh, tree, coll, pspecs)
    lead = 1 if workers else 0

    def one(t, key, cut=True):
        if cut and m.n_model > 1 and m.dims[key] is not None:
            t = torch.cat(list(m.coll.all_gather(t, "model")),
                          dim=m.dims[key] + lead)
        if workers:
            t = torch.cat(list(m.coll.all_gather(t, m.plane)), dim=0)
        return t

    def leaf(keys, layer):
        t = get(tree, keys, layer)
        if isinstance(t, dict):
            return {"q": one(t["q"], (keys, layer)),
                    "scale": one(t["scale"], (keys, layer), m.scale_cut(
                        (keys, layer), t["q"].ndim))}
        return one(t, (keys, layer))
    return rebuild(tree, leaf)


def mesh_sizes(params, mesh, pspecs=None) -> dict:
    """The sizes ``analysis.contracts.train_contract`` takes, for this
    rank's params shard ``params`` on ``mesh``: ``shard_numel``,
    ``plane`` (the worker plane's name in the log), ``n_model`` and
    ``gather_bytes`` (the cut leaves' bytes)."""
    m = _Mesh(mesh, params, None, pspecs)
    ts = {key: get(params, *key) for key in m.dims}
    return {"shard_numel": sum(t.numel() for t in ts.values()),
            "plane": "+".join(m.plane), "n_model": m.n_model,
            "gather_bytes": sum(t.numel() * t.element_size()
                                for key, t in ts.items()
                                if m.n_model > 1
                                and m.dims[key] is not None)}
