"""Mask controllers: telemetry in, next round's (N, Q) mask out.

A controller maps observed telemetry — per-worker simulated round times,
per-region coverage counts and staleness counters — to the next round's
mask, optionally carrying state between rounds.  ``PolicyController``
wraps any open-loop ``PolicyConfig`` and reproduces the reference's key
derivation, so its masks are bit-identical.  The closed-loop controllers
(resource-proportional, staleness-bounded) and the quorum wrapper keep
the reference's draws too.

Every controller broadcasts over a leading seed axis: the batch engine
steps all B seeds at once with stacked ``(B, 2)`` keys and telemetry
whose fields carry that axis, and gets back ``(B, N, Q)`` masks and the
B states stacked.  A controller of the caller's own must do the same to
run on the batch engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import torch

from .. import prng
from ..core.masks import PolicyConfig, ensure_coverage, sample_masks


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


def initial_telemetry(num_workers: int, num_regions: int, device,
                      batch: tuple = ()) -> Telemetry:
    """Telemetry as of the (full-participation, untimed) init round;
    ``batch`` is a leading shape (the seed axis of the batch engine)."""
    b = tuple(batch)
    return Telemetry(
        times=torch.zeros(b + (num_workers,), dtype=torch.float32,
                          device=device),
        work=torch.zeros(b + (num_workers,), dtype=torch.float32,
                         device=device),
        count_q=torch.full(b + (num_regions,), num_workers,
                           dtype=torch.int32, device=device),
        stale_q=torch.zeros(b + (num_regions,), dtype=torch.int32,
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
    def init_state(self, num_workers: int, num_regions: int, device):
        """-> controller state (fixed shapes) on ``device``."""
        ...

    def step(self, state, telem: Telemetry, key, t: int, num_workers: int,
             num_regions: int, device):
        """-> (bool (..., N, Q) mask for round t on ``device``, new
        state).  ``key`` is the round key ``fold_in(k_loop, t)``, shape
        (..., 2)."""
        ...


@dataclass(frozen=True)
class PolicyController:
    """Any open-loop ``PolicyConfig`` as a stateless controller: ``step``
    is ``sample_masks(policy, key, t, N, Q)`` on the round key."""
    policy: PolicyConfig = PolicyConfig()

    def init_state(self, num_workers: int, num_regions: int, device):
        return ()

    def step(self, state, telem, key, t, num_workers: int,
             num_regions: int, device):
        return sample_masks(self.policy, key, t, num_workers, num_regions,
                            device), state


@dataclass(frozen=True)
class ResourceProportionalController:
    """Keep budgets ∝ estimated worker throughput (EMA-tracked).

    State: (N,) throughput estimates, initially 1.  Each round the
    observed ``work/times`` updates the estimate of every worker that
    participated (EMA weight ``ema``), and the keep probabilities are

        p_i = keep_prob · N · thr_i / Σ thr   (clipped to [min_keep, 1])

    so the mean keep fraction stays ``keep_prob`` while slow workers
    train few regions.  Coverage is repaired to ``tau_star``."""
    keep_prob: float = 0.5
    tau_star: int = 1
    ema: float = 0.5
    min_keep: float = 0.05

    def init_state(self, num_workers: int, num_regions: int, device):
        return torch.ones((num_workers,), dtype=torch.float32,
                          device=device)

    def step(self, state, telem, key, t, num_workers: int,
             num_regions: int, device):
        N, Q = num_workers, num_regions
        observed = telem.work > 0
        est = telem.work / torch.clamp_min(telem.times, 1e-12)
        thr = torch.where(observed,
                          (1.0 - self.ema) * state + self.ema * est, state)
        probs = self.keep_prob * N * thr / torch.clamp_min(
            thr.sum(dim=-1, keepdim=True), 1e-12)
        probs = torch.clamp(probs, self.min_keep, 1.0)
        u = prng.uniform(prng.fold_in(key, 3), (N, Q), device)
        m = u < probs[..., None]
        if self.tau_star:
            m = ensure_coverage(m, self.tau_star)
        return m, thr


@dataclass(frozen=True)
class StalenessBoundedController:
    """Base policy + a hard staleness bound: the base mask, then coverage
    forced (per-region ``ensure_coverage``) for every region whose
    staleness counter has reached ``max_stale``.  Under dropout or churn
    the bound is best effort: availability filters the mask after the
    controller."""
    base: PolicyConfig = PolicyConfig()
    max_stale: int = 4

    def init_state(self, num_workers: int, num_regions: int, device):
        return ()

    def step(self, state, telem, key, t, num_workers: int,
             num_regions: int, device):
        m = sample_masks(self.base, key, t, num_workers, num_regions,
                         device)
        forced = (telem.stale_q >= self.max_stale).to(torch.int32)
        tau_q = torch.clamp_min(forced, self.base.tau_star)
        return ensure_coverage(m, tau_q), state


@dataclass(frozen=True)
class QuorumController:
    """Semi-synchronous wrapper: any inner controller plus the quorum
    knobs (commit quorum, per-region on-time floor, damping ``gamma``,
    bounded delay).  ``repro_torch.run`` unwraps it: the knobs move onto
    the run's options and ``inner`` drives the masks."""
    inner: Controller = PolicyController()
    quorum: float = 0.75
    quorum_tau: int | None = 1
    gamma: float = 0.5
    max_delay: int = 2

    def init_state(self, num_workers: int, num_regions: int, device):
        return self.inner.init_state(num_workers, num_regions, device)

    def step(self, state, telem, key, t, num_workers: int,
             num_regions: int, device):
        return self.inner.step(state, telem, key, t, num_workers,
                               num_regions, device)


def as_controller(policy_or_controller) -> Controller:
    """PolicyConfig -> shim; controllers pass through."""
    if isinstance(policy_or_controller, PolicyConfig):
        return PolicyController(policy_or_controller)
    if isinstance(policy_or_controller, Controller):
        return policy_or_controller
    raise TypeError(f"not a PolicyConfig or Controller: "
                    f"{policy_or_controller!r}")


def parse_spec_params(body: str, what: str = "controller") -> dict:
    """``"k=v,k=v"`` -> dict: the grammar of controller and scenario spec
    strings."""
    out = {}
    if body:
        for pair in body.split(","):
            k, sep, v = pair.partition("=")
            if not sep or not k:
                raise ValueError(f"bad {what} parameter {pair!r} "
                                 f"(expected key=value)")
            out[k.strip()] = v.strip()
    return out


def make_controller(spec) -> Controller:
    """A controller from a spec string (controllers pass through).

    ``name[:key=value,...]``: ``policy`` (name, keep, tau, het),
    ``resource`` (keep, tau, ema, min_keep), ``staleness-bounded`` (s,
    keep, tau, het), ``quorum`` (q, tau, gamma, delay, inner — the inner
    spec with ``;`` for ``:`` and ``,``; ``tau=none`` = full
    participating coverage).  Same defaults as the reference."""
    if isinstance(spec, (PolicyController, ResourceProportionalController,
                         StalenessBoundedController, QuorumController)):
        return spec
    if isinstance(spec, PolicyConfig):
        return PolicyController(spec)
    name, _, body = str(spec).partition(":")
    p = parse_spec_params(body)
    if name == "policy":
        return PolicyController(PolicyConfig(
            name=p.get("name", "bernoulli"),
            keep_prob=float(p.get("keep", 0.5)),
            heterogeneous=bool(int(p.get("het", 1))),
            tau_star=int(p.get("tau", 1))))
    if name == "resource":
        return ResourceProportionalController(
            keep_prob=float(p.get("keep", 0.5)),
            tau_star=int(p.get("tau", 1)),
            ema=float(p.get("ema", 0.5)),
            min_keep=float(p.get("min_keep", 0.05)))
    if name == "staleness-bounded":
        return StalenessBoundedController(
            base=PolicyConfig(keep_prob=float(p.get("keep", 0.5)),
                              heterogeneous=bool(int(p.get("het", 1))),
                              tau_star=int(p.get("tau", 1))),
            max_stale=int(p.get("s", 4)))
    if name == "quorum":
        raw = p.get("inner", "policy")
        iname, _, ibody = raw.partition(";")
        inner = make_controller(
            iname + (":" + ibody.replace(";", ",") if ibody else ""))
        tau = p.get("tau", "1")
        return QuorumController(
            inner=inner, quorum=float(p.get("q", 0.75)),
            quorum_tau=None if tau.lower() in ("none", "") else int(tau),
            gamma=float(p.get("gamma", 0.5)),
            max_delay=int(p.get("delay", 2)))
    raise ValueError(
        f"unknown controller {name!r} (expected policy | resource | "
        f"staleness-bounded | quorum)")
