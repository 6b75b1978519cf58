"""Per-worker cost models and the simulated wall-clock of a round.

    time_i(t) = overhead + work_i / (rate_i · capacity_i(t)) + bytes_i / bw_i
    round_time(t) = max over participating workers i of time_i(t)

``work_i`` is the number of coordinates worker i trains this round and
``bytes_i`` what it uplinks (4·work_i uncompressed).  A cost model without
availability dynamics consumes no random draws, so default runs match the
reference's bit for bit.  ``quorum_split`` is the semi-synchronous clock:
the round commits at the k-th order statistic of participant times.
Every function broadcasts over a leading seed axis of its per-round
inputs (keys ``(..., 2)``, work and masks ``(..., N)``/``(..., N, Q)``).
A pod topology (``with_topology``) prices the inter-pod links:
``pod_exchange_time`` is what one crossing costs.  An overlap credit
(``with_overlap_credit``) is what the sharded engine's pipelined rounds
(``overlap=True``) hide of each worker's time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import prng
from ..device import resolve_device

_F32 = torch.float32


@dataclass(frozen=True)
class CostModel:
    """``compute_rate``: (N,) floats per simulated time unit;
    ``bandwidth``: (N,) uplink BYTES per time unit (``inf`` = free).
    ``overhead`` is paid by each participant; ``dropout_prob`` is i.i.d.
    per-round unavailability; ``churn_period``/``churn_cohorts`` rotate
    offline cohorts; ``diurnal_period``/``diurnal_amplitude`` scale
    capacity sinusoidally with a per-worker phase.

    ``pod_bw``: None (a uniform interconnect: crossing pods is free) or
    (P,) inter-pod uplink BYTES per time unit; an exchange of ``nbytes``
    across the pods costs ``pod_latency + nbytes / min(pod_bw)``.  Flat
    runs on such a topology pay it every round, hierarchical runs only
    on exchange rounds.

    ``overlap_credit`` in [0, 1] is the fraction of ``min(compute,
    comm)`` a pipelined (``overlap=True``) round hides by overlapping
    the two (see ``worker_times``)."""
    compute_rate: torch.Tensor    # (N,)
    bandwidth: torch.Tensor       # (N,)
    overhead: float = 0.0
    dropout_prob: float = 0.0
    churn_period: int = 0
    churn_cohorts: int = 4
    diurnal_period: int = 0
    diurnal_amplitude: float = 0.0
    pod_bw: torch.Tensor | None = None   # (P,)
    pod_latency: float = 0.0
    overlap_credit: float = 0.0

    @property
    def num_workers(self) -> int:
        return self.compute_rate.shape[0]


def uniform_cost(num_workers: int, device, *, rate: float = 1.0,
                 bandwidth: float = np.inf) -> CostModel:
    """Homogeneous cluster — the engines' default (round_time then
    reports the max kept coordinates per worker, a pure work measure)."""
    return CostModel(
        compute_rate=torch.full((num_workers,), rate, dtype=_F32,
                                device=device),
        bandwidth=torch.full((num_workers,), bandwidth, dtype=_F32,
                             device=device))


def on_device(cost: CostModel, device) -> CostModel:
    """The same cost model with its arrays on ``device``."""
    return replace(cost, compute_rate=cost.compute_rate.to(device),
                   bandwidth=cost.bandwidth.to(device),
                   pod_bw=None if cost.pod_bw is None
                   else cost.pod_bw.to(device))


def pareto_cost(key, num_workers: int, *, alpha: float = 1.2,
                bandwidth: float = np.inf, device=None) -> CostModel:
    """Heavy-tailed compute rates: rate_i = 1 / Pareto(alpha) sample, with
    u uniform on [1e-4, 1).

    Computed on the host and then moved to ``device`` (None = the card),
    so the card and the host get the same rates bit for bit; the power
    runs in float64 on the f32 base and exponent and rounds once, within
    an ulp of the reference's f32 pow."""
    u = prng.uniform(key, (num_workers,), "cpu", minval=1e-4, maxval=1.0)
    base = (1.0 - u).to(torch.float64)
    slowdown = torch.pow(base, float(np.float32(-1.0 / alpha))).to(_F32)
    cost = CostModel(compute_rate=1.0 / slowdown,
                     bandwidth=torch.full((num_workers,), bandwidth,
                                          dtype=_F32))
    return on_device(cost, resolve_device(device))


def with_availability(cost: CostModel, *, dropout_prob: float = 0.0,
                      churn_period: int = 0, churn_cohorts: int = 4,
                      diurnal_period: int = 0,
                      diurnal_amplitude: float = 0.0) -> CostModel:
    return replace(cost, dropout_prob=float(dropout_prob),
                   churn_period=int(churn_period),
                   churn_cohorts=int(churn_cohorts),
                   diurnal_period=int(diurnal_period),
                   diurnal_amplitude=float(diurnal_amplitude))


def with_topology(cost: CostModel, *, pod_bw,
                  pod_latency: float = 0.0) -> CostModel:
    """Attach an inter-pod link topology: ``pod_bw`` (P,) BYTES per time
    unit per pod uplink (the full vector: asymmetric uplinks stay
    explicit) and a fixed per-exchange ``pod_latency``."""
    return replace(cost, pod_bw=torch.as_tensor(
        pod_bw, dtype=_F32, device=cost.compute_rate.device),
        pod_latency=float(pod_latency))


def with_overlap_credit(cost: CostModel, credit: float) -> CostModel:
    """Set the comm/compute overlap credit (see ``worker_times``)."""
    credit = float(credit)
    if not 0.0 <= credit <= 1.0:
        raise ValueError(f"overlap_credit={credit} must be in [0, 1]")
    return replace(cost, overlap_credit=credit)


def pod_exchange_time(cost: CostModel, nbytes: float) -> torch.Tensor:
    """Simulated time (a 0-d f32 tensor) for ``nbytes`` to cross the
    inter-pod links: 0 without a topology."""
    dev = cost.compute_rate.device
    if cost.pod_bw is None:
        return torch.zeros((), dtype=_F32, device=dev)
    return cost.pod_latency + (torch.tensor(float(nbytes), dtype=_F32,
                                            device=dev) / cost.pod_bw.min())


def available(cost: CostModel, key, t: int) -> torch.Tensor:
    """(..., N) bool — which workers participate in round ``t``.  ``key``
    is the round key (..., 2); dropout folds the tag 23 into it."""
    N = cost.num_workers
    dev = cost.compute_rate.device
    avail = torch.ones((N,), dtype=torch.bool, device=dev)
    if cost.dropout_prob > 0.0:
        u = prng.uniform(prng.fold_in(key, 23), (N,), dev)
        avail = u >= float(np.float32(cost.dropout_prob))
    if cost.churn_period > 0:
        cohort = torch.arange(N, device=dev) % cost.churn_cohorts
        offline = (int(t) // cost.churn_period) % cost.churn_cohorts
        avail = avail & (cohort != offline)
    return avail


def capacity(cost: CostModel, t: int) -> torch.Tensor:
    """(N,) compute-capacity multiplier at round ``t`` (diurnal trace)."""
    N = cost.num_workers
    dev = cost.compute_rate.device
    if cost.diurnal_period <= 0 or cost.diurnal_amplitude == 0.0:
        return torch.ones((N,), dtype=_F32, device=dev)
    phase = torch.arange(N, device=dev).to(_F32) / N
    wave = torch.sin(2.0 * math.pi * (float(np.float32(
        t / cost.diurnal_period)) + phase))
    return torch.clamp_min(1.0 + cost.diurnal_amplitude * wave, 0.05)


def worker_times(cost: CostModel, work, t: int, uplink_bytes=None, *,
                 overlap: bool = False) -> torch.Tensor:
    """(..., N) simulated time per worker for a round; workers with no
    work cost nothing.  ``uplink_bytes`` None = 4 bytes per coordinate.
    ``overlap=True`` takes the cost model's ``overlap_credit`` off: a
    pipelined round hides ``credit · min(compute, comm)`` of each
    worker's time (full overlap hides the shorter phase, never both)."""
    work = work.to(_F32)
    if uplink_bytes is None:
        uplink_bytes = 4.0 * work
    rate = cost.compute_rate * capacity(cost, t)
    compute = work / rate
    comm = uplink_bytes.to(_F32) / cost.bandwidth
    per = cost.overhead + compute + comm
    if overlap and cost.overlap_credit > 0.0:
        per = per - cost.overlap_credit * torch.minimum(compute, comm)
    return torch.where(work > 0, per, torch.zeros_like(per))


def round_time(cost: CostModel, work, t: int, *, overlap: bool = False):
    """Scalar simulated wall-clock of one synchronous round."""
    return worker_times(cost, work, t, overlap=overlap).max()


def quorum_deadline(times, masks, *, quorum: float,
                    quorum_tau: int | None = None):
    """Commit time of a semi-synchronous round (see ``quorum_split``)."""
    return quorum_split(times, masks, quorum=quorum, quorum_tau=quorum_tau,
                        max_delay=1)[0]


def quorum_split(times, masks, *, quorum: float,
                 quorum_tau: int | None = None, max_delay: int = 1):
    """-> (deadline (...,), on_time (..., N) bool, delays (..., N) int32).

    ``times``: (..., N) per-worker times; ``masks``: (..., N, Q) the
    round's masks after availability (an all-False row does not take
    part).  Region q is quorum-covered once ``min(quorum_tau, count_q)``
    of its participants have finished (``None``: all of them); the round
    commits at the earliest participant time by which ``ceil(quorum·Q)``
    regions are covered.  A late worker is ``ceil(time/deadline) − 1``
    rounds late, clipped to ``max_delay + 1``.  The sort is stable, as
    the reference's: tied times (common under a uniform cost) keep
    worker order."""
    N, Q = masks.shape[-2:]
    required = int(np.ceil(float(quorum) * Q))
    times = times.to(_F32)
    participating = masks.any(dim=-1)
    t_eff = torch.where(participating, times,
                        torch.full_like(times, math.inf))
    order = torch.argsort(t_eff, dim=-1, stable=True)
    t_sorted = torch.take_along_dim(t_eff, order, dim=-1)
    cum = torch.cumsum(torch.take_along_dim(
        masks.to(torch.int32), order[..., None], dim=-2), dim=-2)
    full = cum[..., -1, :]                                     # (..., Q)
    floor = full if quorum_tau is None else torch.clamp_max(
        full, int(quorum_tau))
    n_ok = (cum >= floor[..., None, :]).sum(dim=-1)            # (..., N)
    k_star = torch.argmax((n_ok >= required).to(torch.int32), dim=-1)
    deadline = torch.take_along_dim(t_sorted, k_star[..., None],
                                    dim=-1)[..., 0]
    deadline = torch.where(torch.isfinite(deadline), deadline,
                           torch.zeros_like(deadline))
    on_time = participating & (times <= deadline[..., None])
    ratio = times / torch.clamp_min(deadline, 1e-30)[..., None]
    delays = torch.ceil(ratio).to(torch.int32) - 1
    delays = torch.clamp(delays, 0, int(max_delay) + 1)
    delays = torch.where(on_time | ~participating,
                         torch.zeros_like(delays),
                         torch.clamp_min(delays, 1))
    return deadline, on_time, delays


def time_to_target(trace, round_times, target: float, *,
                   record_every: int = 1) -> float:
    """Simulated time until ``trace`` (a per-iterate series: x⁰, x¹, then
    the kept rounds) first drops to ``target``; ``inf`` if it never does.
    ``round_times`` is always full length."""
    trace = np.asarray(torch.as_tensor(trace).cpu())
    times = np.cumsum(np.asarray(torch.as_tensor(round_times).cpu(),
                                 np.float64))
    T = len(times)
    k = int(record_every)
    if k > 1:
        rounds = sorted(set(range(k, T + 1, k)) | ({T} if T > 0 else set()))
    else:
        rounds = list(range(1, T + 1))
    if len(trace) != len(rounds) + 2:
        raise ValueError(
            f"trace length {len(trace)} does not match {T} rounds at "
            f"record_every={k} (expected {len(rounds) + 2} entries: "
            f"x0, x1 and the kept rounds {rounds})")
    hits = np.nonzero(trace[2:] <= target)[0]
    if len(hits) == 0:
        return float("inf")
    return float(times[rounds[hits[0]] - 1])
