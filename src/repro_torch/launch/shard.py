"""Partition rules for the trees the sharded train step moves.

Port of the parts of the reference's ``launch/shard.py`` that the train
step needs: ``params_pspecs``, ``worker_prefix``, ``ranl_state_pspecs``
and ``batch_pspecs``.  A spec is a plain tuple with one entry a dim:
``None`` (replicated), a mesh dimension name, or a tuple of names (a dim
split over several).  Conventions, as the reference's:

* batch and worker axes over ``BATCH`` = ("pod", "data");
* "model" on attention heads (the q out-dim), FFN width, vocab, MoE
  experts, SSM inner width and RWKV head projections — only on a dim it
  divides, else that dim is replicated;
* small glue (norms, token-shift mixes, routers) replicated.

The port's per-layer leaves lack the reference's stacked-layer axis, so
a spec here is the reference's without its leading ``None``.
``local_shard`` and ``gather_shards`` cut a tensor to this rank's piece
of its "model" dim and put the pieces back together.
"""

from __future__ import annotations

import torch

from ..tree import get, rebuild

BATCH = ("pod", "data")
MODEL = "model"


def _param_spec(names, shape, model_shards: int, fsdp_shards=None,
                tied_embeddings: bool = False) -> tuple:
    """Spec of one parameter leaf (no worker axis; a per-layer leaf
    without the stacked-layer axis).  "model" lands only on a dim that
    ``model_shards`` divides.  With ``fsdp_shards`` ([(extra_axes,
    extra_count), ...]), a model-sharded dim over 4096 also splits over
    the batch axes, cascading by divisibility."""
    name = names[-1]
    ndim = len(shape)

    def _model_axis(dim):
        if dim % model_shards:
            return None
        if dim > 1 << 12:
            for extra_axes, extra_n in (fsdp_shards or ()):
                if dim % (model_shards * extra_n) == 0:
                    return (MODEL,) + tuple(extra_axes)
        return MODEL

    def _fsdp_axis(dim):
        """Batch-axes-only sharding, for dims with no model axis (an MoE
        expert's FFN width: the expert dim takes "model")."""
        if dim > 1 << 12:
            for extra_axes, extra_n in (fsdp_shards or ()):
                if dim % extra_n == 0:
                    return (tuple(extra_axes) if len(extra_axes) > 1
                            else extra_axes[0])
        return None

    def lay(*spec):
        return tuple(
            (_model_axis(shape[i]) if ax == MODEL else
             (_fsdp_axis(shape[i]) if ax == "fsdp" else ax))
            for i, ax in enumerate(spec))

    if name in ("embed", "lm_head", "vision_proj"):
        # glue stays out of the FSDP cascade, as in the reference
        fsdp_shards = None
        if name == "embed" and tied_embeddings and ndim == 2:
            return lay(MODEL, None)         # the vocab dim: logits sharded
        return lay(None, None, MODEL) if ndim == 3 else lay(None, MODEL)
    if name == "final_norm":
        return lay(None)
    if name in ("wq", "wk", "wv", "in_proj", "w_r", "w_k", "w_v", "w_g"):
        return lay(None, MODEL)
    if name in ("wo", "w_o", "out_proj", "down"):
        if ndim == 3:                                   # MoE (E, ff, d)
            return lay(MODEL, "fsdp", None)
        return lay(MODEL, None)
    if name in ("gate", "up"):
        if ndim == 3:                                   # MoE (E, d, ff)
            return lay(MODEL, None, "fsdp")
        return lay(None, MODEL)
    if name == "router":
        return lay(None, None)
    if name == "conv":
        return lay(None, MODEL)
    if name == "dt_lo":
        return lay(MODEL, None)
    if name == "dt_hi":
        return lay(None, MODEL)
    if name in ("w_B", "w_C", "A_log"):
        return lay(MODEL, None)
    if name in ("dt_bias", "D", "decay_base"):
        return lay(MODEL)
    if name == "decay_lo":
        return lay(None, None)
    if name == "decay_hi":
        return lay(None, MODEL)
    if name == "bonus_u":
        return lay(MODEL, None)
    if name in ("mu", "ln_x", "q_norm", "k_norm", "ln1", "ln2"):
        return lay(*([None] * ndim))
    return (None,) * ndim


def params_pspecs(params, model_shards: int = 1, fsdp_shards=None,
                  tied_embeddings: bool = False):
    """A tree shaped like ``params`` (per-layer list included) holding
    each leaf's spec."""
    return rebuild(params, lambda keys, layer: _param_spec(
        keys, tuple(get(params, keys, layer).shape), model_shards,
        fsdp_shards, tied_embeddings))


def worker_prefix(spec: tuple) -> tuple:
    """Prepend the worker axis (gradients, RANL memory).  The batch axes
    move to the worker dim, so they leave the inner spec (an axis names
    at most one dim)."""
    def strip(part):
        if isinstance(part, tuple):
            kept = tuple(a for a in part if a not in BATCH)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return None if part in BATCH else part
    return (BATCH,) + tuple(strip(p) for p in spec)


def ranl_state_pspecs(params, model_shards: int = 1, fsdp_shards=None,
                      tied_embeddings: bool = False):
    pspec = params_pspecs(params, model_shards, fsdp_shards,
                          tied_embeddings)
    return {"step": (), "precond": pspec,
            "memory": rebuild(pspec, lambda keys, layer: worker_prefix(
                get(pspec, keys, layer)))}


def batch_pspecs(batch, batch_shards: int = 1):
    """{name: spec} for a batch dict of (B, ...) leaves: the batch dim
    over ``BATCH`` when ``batch_shards`` divides it; ``pos`` replicated."""
    out = {}
    for name, leaf in batch.items():
        shape = tuple(leaf.shape)
        if name == "pos":
            out[name] = ()
            continue
        bax = BATCH if shape[0] % max(batch_shards, 1) == 0 else None
        out[name] = (bax,) + (None,) * (len(shape) - 1)
    return out


def model_dim(spec: tuple) -> int | None:
    """The dim of ``spec`` that "model" splits, or None."""
    for i, part in enumerate(spec):
        if part == MODEL or (isinstance(part, tuple) and MODEL in part):
            return i
    return None


def local_shard(t, dim: int | None, rank: int, n: int):
    """This model rank's contiguous piece of ``t`` along ``dim`` (a copy;
    ``t`` itself when ``dim`` is None or ``n`` is 1)."""
    if dim is None or n == 1:
        return t
    return t.chunk(n, dim=dim)[rank].clone()


def gather_shards(pieces, dim: int | None):
    """The inverse of ``local_shard``: ``pieces`` (every model rank's, in
    rank order) put back together along ``dim``."""
    if dim is None or len(pieces) == 1:
        return pieces[0]
    return torch.cat(list(pieces), dim=dim)
