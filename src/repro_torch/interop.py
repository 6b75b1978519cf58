"""Carrying state across from the reference package.

Both helpers take plain numpy data, so this module needs neither the
reference package nor its framework: the caller turns the reference's
problem leaves and keys into numpy arrays first.
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


def key_from_numpy(key) -> np.ndarray:
    """A reference key's raw data (uint32 (2,)) -> the port's key."""
    k = prng.as_key(np.asarray(key))
    if k.shape != (2,):
        raise ValueError(f"expected one key of shape (2,), got {k.shape}")
    return k
