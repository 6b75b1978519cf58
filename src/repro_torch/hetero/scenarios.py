"""Named cluster scenarios, constructible from a string.

A ``Scenario`` bundles what "the cluster" contributes to a run: the
per-worker cost and availability model and, for non-IID scenarios, the
Dirichlet concentration that skews the per-worker data shards.

    uniform                 homogeneous workers, always available
    pareto-stragglers       heavy-tailed compute rates (alpha=1.2)
    dropout                 i.i.d. per-round unavailability (p=0.2)
    churn                   rotating cohorts leave and rejoin (period=5,
                            cohorts=4)
    churn-stragglers        churn on pareto rates (alpha=1.2)
    diurnal                 sinusoidal capacity (period=20, amp=0.8)
    dirichlet               non-IID data shards (alpha=0.3) on uniform cost

Parameters override with ``name:key=value,...`` (``pareto-stragglers:
alpha=1.0``, ``dropout:p=0.4,alpha=1.5``: dropout, churn and diurnal ride
on pareto rates when ``alpha`` is given); every scenario takes ``bw``, a
finite uplink bandwidth in bytes per time unit.  The same names, defaults
and draws as the reference.

Pod-of-pods topologies attach a per-link inter-pod bandwidth vector
(``cost.with_topology``):

    geo-distributed         uniform workers in pods joined by slow,
                            geometrically asymmetric WAN uplinks (pods=2,
                            pod_bw=64, asym=8, latency=0.5)
    edge-cohort             pareto rates and i.i.d. dropout, thin
                            asymmetric uplinks (alpha=1.2, p=0.1, pods=2,
                            pod_bw=32, asym=4, latency=1.0)
    diurnal-WAN             geo-distributed pods with staggered diurnal
                            capacity (period=20, amp=0.8, pods=2,
                            pod_bw=64, asym=8, latency=0.5)

They take ``pods`` (P), ``pod_bw`` (the fastest pod uplink), ``asym``
(the slowest is ``pod_bw / asym``, geometric in between) and
``latency`` (a fixed per-exchange cost).

Cost models and Dirichlet weights are drawn on the host and then moved to
``device``, so a run on the card and one on the host see the same
cluster bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from .controller import parse_spec_params
from .cost import CostModel, on_device, pareto_cost, uniform_cost, \
    with_availability, with_topology

_F32 = torch.float32


@dataclass(frozen=True)
class Scenario:
    """A named cluster: cost/availability model + data-skew knob."""
    name: str
    cost: CostModel
    dirichlet_alpha: float | None = None


def _f32(v):
    return torch.tensor(v, dtype=_F32)


def _gamma_one(key, alpha: float) -> torch.Tensor:
    """One Gamma(alpha) draw: the reference's Marsaglia–Tsang rejection
    loop (``jax.random.gamma``), on this package's threefry streams.

    alpha < 1 is boosted to alpha + 1 and scaled by U^(1/alpha).  Every
    step is an f32 operation on the host, as in the reference."""
    a = _f32(alpha)
    boost_mask = bool(a >= 1.0)
    al = a if boost_mask else a + 1.0
    d = al - _f32(1.0 / 3.0)
    c = _f32(1.0 / 3.0) / torch.sqrt(d)
    one, half, squeeze = _f32(1.0), _f32(0.5), _f32(0.0331)
    pair = prng.split(key)
    key, subkey = pair[0], pair[1]
    X, V, U = _f32(0.0), _f32(1.0), _f32(2.0)

    def reject(X, V, U):
        return bool(U >= one - squeeze * (X * X)) and bool(
            torch.log(U) >= X * half + d * ((one - V) + torch.log(V)))

    while reject(X, V, U):
        key, x_key, u_key = prng.split(key, 3)
        x, v = _f32(0.0), _f32(-1.0)
        while bool(v <= 0.0):
            x_key, sub = prng.split(x_key)
            x = prng.normal(sub, (), "cpu")
            v = one + x * c
        X = x * x
        V = v * v * v
        U = prng.uniform(u_key, (), "cpu")
    sample = one - prng.uniform(subkey, (), "cpu")
    boost = one if boost_mask else torch.pow(sample, one / a)
    return d * V * boost


def _gamma(key, alpha: float, num: int) -> torch.Tensor:
    """(num,) f32 Gamma(alpha) draws on the host, draw i from
    ``split(key, num)[i]`` as the reference's."""
    keys = prng.split(key, num)
    return torch.stack([_gamma_one(keys[i], alpha) for i in range(num)])


def dirichlet_weights(key, num_workers: int, alpha: float,
                      device=None) -> torch.Tensor:
    """(N,) per-worker data-share weights, mean 1 (N · Dirichlet(alpha)):
    small ``alpha`` concentrates the data on few workers."""
    g = _gamma(key, alpha, num_workers)
    w = num_workers * g / torch.clamp_min(g.sum(), 1e-30)
    return w.to(resolve_device(device))


def _base_cost(key, num_workers: int, p: dict) -> CostModel:
    bw = float(p.get("bw", float("inf")))
    if "alpha" in p:
        return pareto_cost(key, num_workers, alpha=float(p["alpha"]),
                           bandwidth=bw, device="cpu")
    return uniform_cost(num_workers, "cpu", bandwidth=bw)


def _uniform(key, n, p):
    return Scenario("uniform", uniform_cost(
        n, "cpu", bandwidth=float(p.get("bw", float("inf")))))


def _pareto(key, n, p):
    return Scenario("pareto-stragglers", pareto_cost(
        key, n, alpha=float(p.get("alpha", 1.2)),
        bandwidth=float(p.get("bw", float("inf"))), device="cpu"))


def _dropout(key, n, p):
    return Scenario("dropout", with_availability(
        _base_cost(key, n, p), dropout_prob=float(p.get("p", 0.2))))


def _churn(key, n, p):
    return Scenario("churn", with_availability(
        _base_cost(key, n, p), churn_period=int(p.get("period", 5)),
        churn_cohorts=int(p.get("cohorts", 4))))


def _churn_stragglers(key, n, p):
    return Scenario("churn-stragglers",
                    _churn(key, n, {"alpha": 1.2, **p}).cost)


def _diurnal(key, n, p):
    return Scenario("diurnal", with_availability(
        _base_cost(key, n, p), diurnal_period=int(p.get("period", 20)),
        diurnal_amplitude=float(p.get("amp", 0.8))))


def _dirichlet(key, n, p):
    return Scenario("dirichlet", uniform_cost(n, "cpu"),
                    dirichlet_alpha=float(p.get("alpha", 0.3)))


def pod_uplinks(pods: int, pod_bw: float, asym: float) -> torch.Tensor:
    """(P,) f32 geometrically asymmetric uplink bandwidths on the host:
    pod 0 gets ``pod_bw``, pod P−1 ``pod_bw / asym``, the rest
    interpolate geometrically.  The power runs in float64 on the f32 base
    and exponents and rounds once."""
    if pods < 1:
        raise ValueError(f"pods={pods} must be >= 1")
    expo = torch.arange(pods, dtype=_F32) / max(pods - 1, 1)
    base = _f32(1.0 / float(asym)).to(torch.float64)
    return pod_bw * torch.pow(base, expo.to(torch.float64)).to(_F32)


def _with_pods(cost: CostModel, p: dict, *, pod_bw: float, asym: float,
               latency: float) -> CostModel:
    bw = pod_uplinks(int(p.get("pods", 2)), float(p.get("pod_bw", pod_bw)),
                     float(p.get("asym", asym)))
    return with_topology(cost, pod_bw=bw,
                         pod_latency=float(p.get("latency", latency)))


def _geo(key, n, p):
    return Scenario("geo-distributed", _with_pods(
        _base_cost(key, n, p), p, pod_bw=64.0, asym=8.0, latency=0.5))


def _edge_cohort(key, n, p):
    cost = with_availability(_base_cost(key, n, {"alpha": 1.2, **p}),
                             dropout_prob=float(p.get("p", 0.1)))
    return Scenario("edge-cohort", _with_pods(
        cost, p, pod_bw=32.0, asym=4.0, latency=1.0))


def _diurnal_wan(key, n, p):
    cost = with_availability(
        _base_cost(key, n, p), diurnal_period=int(p.get("period", 20)),
        diurnal_amplitude=float(p.get("amp", 0.8)))
    return Scenario("diurnal-WAN", _with_pods(
        cost, p, pod_bw=64.0, asym=8.0, latency=0.5))


SCENARIOS = {
    "uniform": _uniform,
    "pareto-stragglers": _pareto,
    "dropout": _dropout,
    "churn": _churn,
    "churn-stragglers": _churn_stragglers,
    "diurnal": _diurnal,
    "dirichlet": _dirichlet,
    "geo-distributed": _geo,
    "edge-cohort": _edge_cohort,
    "diurnal-WAN": _diurnal_wan,
}


def make_scenario(spec: str, key, num_workers: int,
                  device=None) -> Scenario:
    """``"name"`` or ``"name:key=value,..."`` -> Scenario whose cost model
    lies on ``device`` (None = the card)."""
    name, _, body = str(spec).partition(":")
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r} (known: "
                         f"{', '.join(sorted(SCENARIOS))})")
    dev = resolve_device(device)
    scen = SCENARIOS[name](key, int(num_workers),
                           parse_spec_params(body, "scenario"))
    return Scenario(scen.name, on_device(scen.cost, dev),
                    scen.dirichlet_alpha)


def scenario_problem(scenario: Scenario, key, *, kind: str = "quadratic",
                     device=None, **kwargs):
    """A convex problem shaped by the scenario's data skew: for
    ``dirichlet`` the per-worker shares become the factories'
    ``worker_weights`` (and ``heterogeneity`` defaults to 0.5); other
    scenarios build the plain problem.  ``kwargs`` go to
    ``make_quadratic`` / ``make_logistic``."""
    from ..core.convex import make_logistic, make_quadratic
    factory = {"quadratic": make_quadratic,
               "logistic": make_logistic}.get(kind)
    if factory is None:
        raise ValueError(f"unknown problem kind {kind!r}")
    if scenario.dirichlet_alpha is not None:
        n = kwargs.get("num_workers", 16)
        w = dirichlet_weights(prng.fold_in(key, 101), n,
                              scenario.dirichlet_alpha, device="cpu")
        kwargs = dict(kwargs, worker_weights=np.asarray(w.numpy()))
        kwargs.setdefault("heterogeneity", 0.5)
    return factory(key, device=device, **kwargs)
