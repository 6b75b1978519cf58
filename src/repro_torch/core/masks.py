"""Pruning policies P: adaptive per-worker region masks (paper §3–4).

A policy maps (key, round t) -> boolean mask M of shape (N, Q): worker i
trains region q this round iff M[i, q].  ``ensure_coverage``
post-processes a mask so every region has at least ``tau_star`` covering
workers (the paper's minimum worker-coverage number τ*).

Keys are host-side (``repro_torch.prng``) and ``t`` is a Python int; the
draws run on ``device``.  Every policy reproduces the reference's key
derivation, so the masks are bit-identical to the reference's.  A stack
of keys (``(B, 2)``) draws B seeds' masks in one pass, each equal to its
own key's masks (the batch engine's round).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng


@dataclass(frozen=True)
class PolicyConfig:
    name: str = "bernoulli"      # bernoulli | fixed_k | roundrobin | full | staleness
    keep_prob: float = 0.5       # bernoulli: mean fraction of regions kept
    heterogeneous: bool = True   # vary resources across workers
    keep_k: int = 1              # fixed_k: regions per worker
    stale_period: int = 0        # staleness: the stale_regions untrained for
                                 # this many consecutive rounds out of each
                                 # period+1
    stale_regions: tuple[int, ...] = (0,)   # staleness: which regions starve
    tau_star: int = 0            # 0 = no coverage repair

    def __post_init__(self):
        if not 0.0 < self.keep_prob <= 1.0:
            raise ValueError(f"keep_prob={self.keep_prob} must be in "
                             f"(0, 1]")
        if self.keep_k < 1:
            raise ValueError(f"keep_k={self.keep_k} must be >= 1")
        if self.stale_period < 0:
            raise ValueError(f"stale_period={self.stale_period} must be "
                             f">= 0")
        if self.tau_star < 0:
            raise ValueError(f"tau_star={self.tau_star} must be >= 0")


def worker_keep_probs(key, num_workers: int, base: float,
                      heterogeneous: bool, device) -> torch.Tensor:
    """Per-worker keep probabilities, mean ``base``: uniform on the widest
    interval centred on ``base`` inside [0, 1] (half-width
    ``min(base/2, 1 - base)``); ``key.shape[:-1] + (N,)``, or ``(N,)``
    when not heterogeneous."""
    if not heterogeneous:
        return torch.full((num_workers,), float(np.float32(base)),
                          device=device)
    half = min(base * 0.5, 1.0 - base)
    return prng.uniform(key, (num_workers,), device, minval=base - half,
                        maxval=base + half)


def _bernoulli_mask(policy, kp, km, t, N, Q, device):
    probs = worker_keep_probs(kp, N, policy.keep_prob, policy.heterogeneous,
                              device)
    return prng.uniform(prng.fold_in(km, t), (N, Q), device) \
        < probs[..., None]


def sample_masks(policy: PolicyConfig, key, t: int, num_workers: int,
                 num_regions: int, device) -> torch.Tensor:
    """-> bool ``key.shape[:-1] + (N, Q)`` on ``device``."""
    N, Q, t = int(num_workers), int(num_regions), int(t)
    key = prng.as_key(key)
    batch = key.shape[:-1]
    pair = prng.split(prng.fold_in(key, 1))
    kp, km = pair[..., 0, :], pair[..., 1, :]
    if policy.name == "full":
        m = torch.ones(batch + (N, Q), dtype=torch.bool, device=device)
    elif policy.name == "bernoulli":
        m = _bernoulli_mask(policy, kp, km, t, N, Q, device)
    elif policy.name == "fixed_k":
        perms = prng.permutation(prng.split(prng.fold_in(km, t), N), Q,
                                 device)                     # (..., N, Q)
        m = torch.zeros(batch + (N, Q), dtype=torch.bool, device=device)
        m.scatter_(-1, perms[..., :policy.keep_k], True)
    elif policy.name == "roundrobin":
        q0 = (torch.arange(N, device=device) + t) % Q
        m = torch.nn.functional.one_hot(q0, Q).to(torch.bool).expand(
            batch + (N, Q)).clone()
    elif policy.name == "staleness":
        if policy.stale_regions and max(policy.stale_regions) >= Q:
            raise ValueError(
                f"staleness policy names region "
                f"{max(policy.stale_regions)} but only {Q} regions exist")
        m = _bernoulli_mask(policy, kp, km, t, N, Q, device)
        period = policy.stale_period
        train_now = (t % (period + 1)) == period if period else True
        if not train_now:
            idx = torch.as_tensor(policy.stale_regions, dtype=torch.int64,
                                  device=device)
            m[..., idx] = False
    else:
        raise ValueError(f"unknown policy {policy.name}")
    if policy.tau_star:
        m = ensure_coverage(m, policy.tau_star)
    return m


def staleness_weights(delays: torch.Tensor, gamma: float,
                      max_delay: int) -> torch.Tensor:
    """(N,) f32 fold weights ``gamma**s`` for 1 <= s <= max_delay, else 0."""
    s = delays.to(torch.float32)
    w = torch.pow(torch.tensor(float(gamma), dtype=torch.float32,
                               device=delays.device), s)
    live = (delays >= 1) & (delays <= int(max_delay))
    return torch.where(live, w, torch.zeros_like(w))


def ensure_coverage(mask: torch.Tensor, tau_star) -> torch.Tensor:
    """Repair ``mask`` (..., N, Q) so every region is covered by >= tau_star
    workers.

    Deterministically forces workers (q + j) mod N onto under-covered
    regions, already-covering workers ranked last.  ``tau_star`` is a
    Python int (at most N, else ValueError) or a (..., Q) int tensor of
    per-region targets (clamped at N)."""
    N, Q = mask.shape[-2:]
    dev = mask.device
    if isinstance(tau_star, (int, np.integer)):
        if tau_star > N:
            raise ValueError(
                f"ensure_coverage: tau_star={tau_star} exceeds "
                f"num_workers={N} — at most N workers can cover a region")
        tau = int(tau_star)
    else:
        tau = torch.clamp_max(torch.as_tensor(tau_star, device=dev)
                              .to(torch.int64), N)
    count = mask.sum(dim=-2)
    need = torch.clamp_min(tau - count, 0)                      # (..., Q)
    j = torch.arange(N, device=dev)[:, None]
    q = torch.arange(Q, device=dev)[None, :]
    order = (j - q) % N + N * mask.to(torch.int64)              # (..., N, Q)
    rank = (order[..., None, :, :] < order[..., :, None, :]).sum(dim=-2)
    return mask | (rank < need[..., None, :])
