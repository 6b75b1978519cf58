"""Carrying state across from the reference package.

Every helper takes plain numpy data, so this module needs neither the
reference package nor its framework: the caller turns the reference's
problem leaves, keys and parameter trees into numpy arrays first.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng
from .core.convex import Logistic, Quadratic
from .device import resolve_device


def problem_from_arrays(kind: str, arrays: dict, scalars: dict,
                        device=None):
    """Build the port's problem from the reference problem's leaves.

    ``kind``: ``"quadratic"`` (arrays ``A, b, x_star``; scalars
    ``grad_noise, hess_noise, mu, L_g``) or ``"logistic"`` (arrays
    ``X, y, x_star``; scalars ``lam, grad_noise, hess_noise, mu, L_g``).
    Arrays become f32 tensors on ``device``."""
    if kind not in ("quadratic", "logistic"):
        raise ValueError(f"unknown problem kind {kind!r} "
                         f"(expected 'quadratic' or 'logistic')")
    dev = resolve_device(device)

    def t(name):
        return torch.tensor(np.asarray(arrays[name], np.float32),
                               device=dev)

    common = {k: float(scalars[k])
              for k in ("grad_noise", "hess_noise", "mu", "L_g")}
    if kind == "quadratic":
        return Quadratic(A=t("A"), b=t("b"), x_star=t("x_star"), **common)
    return Logistic(X=t("X"), y=t("y"), x_star=t("x_star"),
                    lam=float(scalars["lam"]), **common)


_COST_STATICS = ("overhead", "dropout_prob", "churn_period", "churn_cohorts",
                 "diurnal_period", "diurnal_amplitude", "pod_latency",
                 "overlap_credit")


def cost_from_arrays(arrays: dict, statics: dict, device=None):
    """The reference's ``CostModel`` -> the port's.

    ``arrays``: ``compute_rate``, ``bandwidth`` and ``pod_bw`` (None
    without a pod topology); ``statics``: the scalar fields
    (``overhead``, ``dropout_prob``, ``churn_period``, ``churn_cohorts``,
    ``diurnal_period``, ``diurnal_amplitude``, ``pod_latency`` and
    ``overlap_credit``)."""
    from .hetero.cost import CostModel
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    pod_bw = arrays.get("pod_bw")
    return CostModel(
        compute_rate=f32(arrays["compute_rate"]),
        bandwidth=f32(arrays["bandwidth"]),
        pod_bw=None if pod_bw is None else f32(pod_bw),
        **{k: statics[k] for k in _COST_STATICS if k in statics})


def key_from_numpy(key) -> np.ndarray:
    """A reference key's raw data (uint32 (2,)) -> the port's key."""
    k = prng.as_key(np.asarray(key))
    if k.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {k.shape}")
    return k


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy has no bf16 of its own
        t = torch.tensor(a.astype(np.float32), device=device)
        return t.to(dtype or torch.bfloat16)
    t = torch.tensor(a, device=device)
    return t if dtype is None else t.to(dtype)


def model_params_from_numpy(cfg, tree, device=None, dtype=None):
    """The reference's model parameters -> the port's.

    ``tree``: what the reference's ``init_model`` returns, as nested dicts
    of numpy arrays, with the layers stacked on a leading L axis.  The
    port keeps the reference's names; its ``"layers"`` is a list of L
    per-layer dicts.  ``dtype`` None keeps each array's type."""
    dev = resolve_device(device)

    def convert(node, layer=None):
        if isinstance(node, dict):
            return {k: convert(v, layer) for k, v in node.items()}
        return _tensor(node if layer is None else np.asarray(node)[layer],
                       dev, dtype)

    params = {k: convert(v) for k, v in tree.items() if k != "layers"}
    params["layers"] = [convert(tree["layers"], i)
                        for i in range(cfg.num_layers)]
    return params


def params_to_numpy(cfg, params):
    """The port's model parameters -> the reference's layout: nested dicts
    of numpy arrays with the layers stacked on a leading L axis (the
    inverse of ``model_params_from_numpy``; bf16 widens to f32)."""
    from .tree import stacked, to_numpy
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"{cfg.name} has {cfg.num_layers} layers, the "
                         f"parameters {len(params['layers'])}")
    return stacked(params, to_numpy)


def ranl_state_from_numpy(cfg, state, device=None):
    """The reference's RANL state -> the port's.

    ``state``: ``{"step", "precond", "memory"}`` as nested dicts of numpy
    arrays, as ``repro.optim.init_state`` returns it.  ``precond`` is
    shaped like the parameters; ``memory`` has a leading worker axis, so
    its per-layer leaves are (N, L, ...) and layer i is ``[:, i]``; an
    int8 memory leaf ``{"q", "scale"}`` is sliced in both."""
    dev = resolve_device(device)

    def memory(node, layer=None):
        if isinstance(node, dict):
            return {k: memory(v, layer) for k, v in node.items()}
        a = np.asarray(node)
        return _tensor(a if layer is None else a[:, layer], dev, None)

    mem = state["memory"]
    port_mem = {k: memory(v) for k, v in mem.items() if k != "layers"}
    port_mem["layers"] = [memory(mem["layers"], i)
                          for i in range(cfg.num_layers)]
    return {"step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32),
            "precond": model_params_from_numpy(cfg, state["precond"], dev),
            "memory": port_mem}
