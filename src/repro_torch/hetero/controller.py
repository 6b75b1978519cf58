"""Mask controllers: telemetry in, next round's (N, Q) mask out.

A controller maps observed telemetry — per-worker simulated round times,
per-region coverage counts and staleness counters — to the next round's
mask, optionally carrying state between rounds.  ``PolicyController``
wraps any open-loop ``PolicyConfig`` and reproduces the reference's key
derivation, so its masks are bit-identical.  The closed-loop controllers
arrive with ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import torch

from ..core.masks import PolicyConfig, sample_masks


@dataclass(frozen=True)
class Telemetry:
    """What the server observed about the previous round: ``times`` (N,)
    simulated per-worker times, ``work`` (N,) coordinates trained,
    ``count_q`` (Q,) coverage counts, ``stale_q`` (Q,) rounds since each
    region was last covered."""
    times: torch.Tensor
    work: torch.Tensor
    count_q: torch.Tensor
    stale_q: torch.Tensor


def initial_telemetry(num_workers: int, num_regions: int,
                      device) -> Telemetry:
    """Telemetry as of the (full-participation, untimed) init round."""
    return Telemetry(
        times=torch.zeros((num_workers,), dtype=torch.float32,
                          device=device),
        work=torch.zeros((num_workers,), dtype=torch.float32, device=device),
        count_q=torch.full((num_regions,), num_workers, dtype=torch.int32,
                           device=device),
        stale_q=torch.zeros((num_regions,), dtype=torch.int32,
                            device=device))


def next_telemetry(prev: Telemetry, count_q, work, times) -> Telemetry:
    """Fold one observed round in: staleness resets where covered, ages
    everywhere else."""
    stale_q = torch.where(count_q > 0, torch.zeros_like(prev.stale_q),
                          prev.stale_q + 1).to(torch.int32)
    return Telemetry(times=times.to(torch.float32),
                     work=work.to(torch.float32),
                     count_q=count_q.to(torch.int32), stale_q=stale_q)


@runtime_checkable
class Controller(Protocol):
    def init_state(self, num_workers: int, num_regions: int):
        """-> controller state (fixed shapes)."""
        ...

    def step(self, state, telem: Telemetry, key, t: int, num_workers: int,
             num_regions: int, device):
        """-> (bool (N, Q) mask for round t on ``device``, new state).
        ``key`` is the round key ``fold_in(k_loop, t)``."""
        ...


@dataclass(frozen=True)
class PolicyController:
    """Any open-loop ``PolicyConfig`` as a stateless controller: ``step``
    is ``sample_masks(policy, key, t, N, Q)`` on the round key."""
    policy: PolicyConfig = PolicyConfig()

    def init_state(self, num_workers: int, num_regions: int):
        return ()

    def step(self, state, telem, key, t, num_workers: int,
             num_regions: int, device):
        return sample_masks(self.policy, key, t, num_workers, num_regions,
                            device), state


def as_controller(policy_or_controller) -> Controller:
    """PolicyConfig -> shim; controllers pass through."""
    if isinstance(policy_or_controller, PolicyConfig):
        return PolicyController(policy_or_controller)
    if isinstance(policy_or_controller, Controller):
        return policy_or_controller
    raise TypeError(f"not a PolicyConfig or Controller: "
                    f"{policy_or_controller!r}")
