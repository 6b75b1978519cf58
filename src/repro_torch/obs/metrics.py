"""Typed metrics registry + the runtime contract-drift alarm.

``MetricsRegistry`` is a small counter/gauge/histogram substrate for
host-side telemetry (nothing here touches a tensor of a running
program).  ``result_metrics`` adapts a finished ``RanlResult`` into a
registry; ``check_byte_drift`` is the **live contract-drift alarm**: it
compares the observed ``comm_bytes``/``pod_bytes`` of every recorded
round against the per-round ceilings
:func:`repro_torch.analysis.contracts.round_byte_budget` derives for the
same options, and returns structured ``kind="drift"`` journal records
where they diverge.

Import-light by design (numpy and torch lazily): the report CLI loads
this without the engine stack.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "result_metrics", "check_byte_drift", "byte_budget_for",
           "DRIFT_RTOL"]

#: Relative headroom on the byte ceilings before the alarm fires: the
#: budgets are exact worst-case wire-model sums, so anything past float
#: round-off is genuine drift.
DRIFT_RTOL = 1e-6


@dataclass
class Counter:
    """Monotonically increasing total."""
    name: str
    value: float = 0.0

    def inc(self, amount: float = 1.0) -> float:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc({amount}))")
        self.value += float(amount)
        return self.value


@dataclass
class Gauge:
    """Last-write-wins instantaneous value."""
    name: str
    value: float = 0.0

    def set(self, value: float) -> float:
        self.value = float(value)
        return self.value


@dataclass
class Histogram:
    """Fixed-bound histogram: ``counts[i]`` holds observations with
    ``value <= bounds[i]`` (last bucket is the +inf overflow)."""
    name: str
    bounds: tuple[float, ...] = (1.0, 2.0, 5.0, 10.0, 100.0)
    counts: list[int] = field(default_factory=list)
    total: float = 0.0
    n: int = 0

    def __post_init__(self):
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram {self.name!r} bounds must be "
                             f"sorted: {self.bounds}")
        if not self.counts:
            self.counts = [0] * (len(self.bounds) + 1)

    def observe(self, value: float) -> None:
        v = float(value)
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += v
        self.n += 1

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0


class MetricsRegistry:
    """Namespaced counters/gauges/histograms; re-requesting a name
    returns the same instrument (mismatched type raises)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name=name, **kwargs)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str, bounds=None) -> Histogram:
        kwargs = {} if bounds is None else {"bounds": tuple(bounds)}
        return self._get(Histogram, name, **kwargs)

    def to_dict(self) -> dict:
        out = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                out[name] = {"type": "histogram",
                             "bounds": list(m.bounds),
                             "counts": list(m.counts),
                             "mean": m.mean(), "n": m.n}
            else:
                out[name] = {"type": type(m).__name__.lower(),
                             "value": m.value}
        return out


def result_metrics(result, registry: MetricsRegistry | None = None,
                   ) -> MetricsRegistry:
    """Adapt a finished ``RanlResult`` into registry instruments:
    totals as counters, final/τ readings as gauges, per-round
    staleness and round-time distributions as histograms."""
    from .journal import _on_host
    res = _on_host(result)
    reg = registry or MetricsRegistry()
    losses = res.losses.astype("float64")
    if losses.ndim == 2:
        losses = losses.mean(axis=0)
    T = int(res.coverage.shape[-1])
    reg.counter("rounds_total").inc(T)
    for name in ("comm_floats", "comm_bytes", "pod_bytes"):
        v = getattr(res, name)
        if v is not None:
            reg.counter(f"{name}_total").inc(float(v.astype("float64")
                                                   .sum()))
    reg.gauge("final_loss").set(float(losses[-1]))
    reg.gauge("tau_star").set(float(res.tau_star.min()))
    reg.gauge("tau_covered").set(float(res.tau_covered.min()))
    if res.max_stale is not None:
        h = reg.histogram("max_stale", bounds=(0, 1, 2, 4, 8, 16))
        for s in res.max_stale.reshape(-1):
            h.observe(float(s))
    if res.round_time is not None:
        rt = res.round_time.astype("float64")
        reg.counter("sim_s_total").inc(float(rt.sum(axis=-1).max()))
        h = reg.histogram("round_time",
                          bounds=(0.1, 0.5, 1.0, 5.0, 25.0, 125.0))
        for s in rt.reshape(-1):
            h.observe(float(s))
    return reg


def byte_budget_for(engine: str, options, *, dim: int,
                    num_workers: int) -> dict:
    """Per-round byte ceilings for a run — thin wrapper over
    ``analysis.contracts.round_byte_budget`` (kept here so obs callers
    need one import; the derivation lives with the contracts)."""
    del engine  # the wire-model ceilings are engine-independent
    from ..analysis.contracts import round_byte_budget
    return round_byte_budget(options, dim=dim, num_workers=num_workers)


def check_byte_drift(rounds, budget: dict, *,
                     rtol: float = DRIFT_RTOL) -> list[dict]:
    """The live contract-drift alarm.

    ``rounds``: an iterable of ``kind="round"`` journal records (other
    kinds are skipped, so a whole journal can be passed).  ``budget``:
    ``{"comm_per_round", "pod_per_round"}`` ceilings from
    :func:`byte_budget_for`.  Returns one structured ``kind="drift"``
    record per (round, metric) whose observed bytes exceed the ceiling —
    empty when the run and its contract agree (the state every
    combination of the reference's contract matrix is pinned to in
    ``tests/test_torch_obs.py``).
    """
    checks = (("comm_bytes", "comm_per_round"),
              ("pod_bytes", "pod_per_round"))
    out = []
    for rec in rounds:
        if rec.get("kind", "round") != "round":
            continue
        for metric, limit_key in checks:
            if metric not in rec or limit_key not in budget:
                continue
            observed = float(rec[metric])
            limit = float(budget[limit_key])
            if observed > limit * (1.0 + rtol):
                out.append({
                    "kind": "drift", "metric": metric,
                    "t": rec.get("t"), "observed": observed,
                    "budget": limit,
                    "ratio": (observed / limit if limit > 0
                              else float("inf")),
                    "message": (f"round {rec.get('t')}: {metric}="
                                f"{observed:.1f} exceeds the contract "
                                f"byte budget {limit:.1f}"),
                })
    return out
