"""Per-worker cost models and the simulated wall-clock of a round.

    time_i(t) = overhead + work_i / (rate_i · capacity_i(t)) + bytes_i / bw_i
    round_time(t) = max over participating workers i of time_i(t)

``work_i`` is the number of coordinates worker i trains this round and
``bytes_i`` what it uplinks (4·work_i uncompressed).  A cost model without
availability dynamics consumes no random draws, so default runs match the
reference's bit for bit.  This slice ports the synchronous clock; the
quorum split, pod topology and overlap credit arrive with ROADMAP Queue 1
items 10–12.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import prng

_F32 = torch.float32


@dataclass(frozen=True)
class CostModel:
    """``compute_rate``: (N,) floats per simulated time unit;
    ``bandwidth``: (N,) uplink BYTES per time unit (``inf`` = free).
    ``overhead`` is paid by each participant; ``dropout_prob`` is i.i.d.
    per-round unavailability; ``churn_period``/``churn_cohorts`` rotate
    offline cohorts; ``diurnal_period``/``diurnal_amplitude`` scale
    capacity sinusoidally with a per-worker phase."""
    compute_rate: torch.Tensor    # (N,)
    bandwidth: torch.Tensor       # (N,)
    overhead: float = 0.0
    dropout_prob: float = 0.0
    churn_period: int = 0
    churn_cohorts: int = 4
    diurnal_period: int = 0
    diurnal_amplitude: float = 0.0

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


def available(cost: CostModel, key, t: int) -> torch.Tensor:
    """(N,) bool — which workers participate in round ``t``.  ``key`` is
    the round key; dropout folds the tag 23 into it."""
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


def worker_times(cost: CostModel, work, t: int,
                 uplink_bytes=None) -> torch.Tensor:
    """(N,) simulated time per worker for a round; workers with no work
    cost nothing.  ``uplink_bytes`` None = 4 bytes per coordinate."""
    work = work.to(_F32)
    if uplink_bytes is None:
        uplink_bytes = 4.0 * work
    rate = cost.compute_rate * capacity(cost, t)
    per = cost.overhead + work / rate + uplink_bytes.to(_F32) / cost.bandwidth
    return torch.where(work > 0, per, torch.zeros_like(per))


def round_time(cost: CostModel, work, t: int):
    """Scalar simulated wall-clock of one synchronous round."""
    return worker_times(cost, work, t).max()


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
