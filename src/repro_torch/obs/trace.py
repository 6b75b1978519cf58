"""Span tracing: where a run's time goes, on the host and on the card.

The engines' simulated clock (``hetero.cost``) prices the *modeled*
cluster; this module meters the run itself, as explicit ``with
span("execute"): ...`` blocks collected by a :class:`Tracer`.

Zero-cost by default: ``span`` and ``count`` are no-ops unless a tracer
has been activated (``with tracing() as tr:``), so the hooks in
``repro_torch.run``, in the RANL round (``optim.ranl_llm``) and in the
train CLI launch nothing and never synchronise in an untraced run.
Spans and counters touch no tensor of the run, so a traced run is bit
for bit an untraced one.

Each span keeps ``dur``, host ``perf_counter`` seconds, as the
reference's do, and its start and end in ns on the torch profiler's
clock (``start_ns``/``end_ns``: ``perf_counter_ns`` plus one offset to
``time.time_ns``, taken when the tracer is made; the profiler's Chrome
export puts an event at ``baseTimeNanoseconds + 1000·ts``), so a span
can be laid over a ``torch.profiler`` trace of the same run.  A span
given a CUDA ``device`` also records a
``torch.cuda.Event(enable_timing=True)`` pair on that device's current
stream; the elapsed time between them, ``device_s``, is resolved when
the records are read (``span_records``, ``chrome_trace``, ``totals``),
after one synchronise, never inside the run.  A CPU span has no
``device_s``.  ``count(name, n)`` adds to the tracer's counter ``name``
(``Tracer.metrics``, an ``obs.metrics.MetricsRegistry``).

Exports:

* ``Tracer.chrome_trace()`` / ``Tracer.write_chrome(path)`` — the
  Chrome-trace ("Perfetto"/``chrome://tracing``) JSON event form, on
  the profiler's clock (it lines up with a ``torch.profiler`` trace);
* ``Tracer.span_records()`` — the journal form (``kind="span"``
  records, appended by ``obs.journal.write_run_journal``);
* ``torch_profiler(log_dir)`` — ``torch.profiler`` over the CPU and the
  card, its trace written into ``log_dir``; ``device_ops`` lists the
  operations that took the most device time in it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

from .metrics import MetricsRegistry

__all__ = ["SpanRecord", "Tracer", "tracing", "span", "count",
           "current_tracer", "torch_profiler", "device_ops"]


@dataclass(frozen=True)
class SpanRecord:
    """One closed span: ``t0``/``dur`` are host ``perf_counter`` seconds
    (``t0`` relative to the tracer's epoch); ``device_s`` the seconds the
    card's stream took between the span's CUDA events (None on the CPU,
    and until the tracer resolves it); ``start_ns``/``end_ns`` the host
    interval in ns on the torch profiler's clock."""
    name: str
    t0: float
    dur: float
    meta: tuple[tuple[str, object], ...] = ()
    device_s: float | None = None
    start_ns: int | None = None
    end_ns: int | None = None


def _profiler_offset_ns() -> int:
    """What turns a ``perf_counter_ns`` stamp into the torch profiler's
    clock: ns since the Unix epoch, ``time.time_ns``'s."""
    return time.time_ns() - time.perf_counter_ns()


def _cuda_device(device):
    """``device`` as a ``torch.device`` when it is a CUDA device, else
    None (the span then records no events)."""
    if device is None:
        return None
    import torch
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def _record_event(dev):
    import torch
    with torch.cuda.device(dev):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
    return ev


@dataclass
class Tracer:
    """Collects :class:`SpanRecord` entries; reentrant and nestable.
    ``spans`` holds them in close order; read them through
    ``span_records``/``chrome_trace``/``totals`` (or call ``resolve``
    first) to have the CUDA spans' ``device_s``.  ``metrics`` holds the
    counters ``count`` adds to."""
    epoch: float = field(default_factory=time.perf_counter)
    spans: list[SpanRecord] = field(default_factory=list)
    metrics: MetricsRegistry = field(default_factory=MetricsRegistry)
    offset_ns: int = field(default_factory=_profiler_offset_ns)
    _events: dict = field(default_factory=dict, repr=False, init=False)

    @contextmanager
    def span(self, name: str, *, device=None, **meta):
        dev = _cuda_device(device)
        start = _record_event(dev) if dev is not None else None
        t0 = time.perf_counter_ns()
        try:
            yield self
        finally:
            t1 = time.perf_counter_ns()
            if dev is not None:
                self._events[len(self.spans)] = (dev, start,
                                                 _record_event(dev))
            self.spans.append(SpanRecord(
                name=str(name), t0=t0 * 1e-9 - self.epoch,
                dur=(t1 - t0) * 1e-9, meta=tuple(sorted(meta.items())),
                start_ns=t0 + self.offset_ns, end_ns=t1 + self.offset_ns))

    def count(self, name: str, n: float = 1) -> None:
        self.metrics.counter(name).inc(n)

    def resolve(self) -> list[SpanRecord]:
        """Fill in ``device_s`` of every closed CUDA span: one
        synchronise of each card, then the events' elapsed times."""
        if self._events:
            import torch
            for dev in {dev for dev, _, _ in self._events.values()}:
                torch.cuda.synchronize(dev)
            for i, (_, start, end) in self._events.items():
                self.spans[i] = dataclasses.replace(
                    self.spans[i], device_s=start.elapsed_time(end) / 1e3)
            self._events.clear()
        return self.spans

    def totals(self) -> dict[str, float]:
        """Total host seconds per span name (the report's span
        breakdown); resolves the CUDA spans' ``device_s`` too."""
        out: dict[str, float] = {}
        for s in self.resolve():
            out[s.name] = out.get(s.name, 0.0) + s.dur
        return out

    def span_records(self) -> list[dict]:
        """Journal-form records (``kind="span"``), in close order."""
        return [{"kind": "span", "name": s.name,
                 "t0_s": round(s.t0, 9), "dur_s": round(s.dur, 9),
                 **({"device_s": round(s.device_s, 9)}
                    if s.device_s is not None else {}),
                 **({"meta": dict(s.meta)} if s.meta else {})}
                for s in self.resolve()]

    def chrome_trace(self) -> dict:
        """Chrome-trace JSON object (open with Perfetto or
        ``chrome://tracing``): complete ("X") events in microseconds
        after ``baseTimeNanoseconds``, the tracer's epoch on the torch
        profiler's clock, as the profiler's own export writes them; a
        CUDA span carries its ``device_s`` in ``args``."""
        events = [{"name": s.name, "ph": "X", "pid": 0, "tid": 0,
                   "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
                   "args": {**dict(s.meta),
                            **({"device_s": s.device_s}
                               if s.device_s is not None else {})}}
                  for s in self.resolve()]
        return {"baseTimeNanoseconds": round(self.epoch * 1e9)
                + self.offset_ns, "traceEvents": events}

    def write_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
            f.write("\n")
        return path


# -- module-level tracer stack (spans wrap host-side phases of one thread)
_STACK: list[Tracer] = []


def current_tracer() -> Tracer | None:
    return _STACK[-1] if _STACK else None


@contextmanager
def tracing(tracer: Tracer | None = None):
    """Activate a tracer for the block: every ``span(...)`` and
    ``count(...)`` inside (the hooks in ``repro_torch.run`` and in the
    RANL round among them) records into it.  Yields the
    :class:`Tracer`."""
    t = tracer or Tracer()
    _STACK.append(t)
    try:
        yield t
    finally:
        _STACK.pop()


_NO_SPAN = nullcontext()


def span(name: str, *, device=None, **meta):
    """Record a span on the active tracer — a no-op when none is active
    (the zero-cost default for the hooks in hot paths).  On a CUDA
    ``device`` the span also times the card's stream.  ``with span(...)
    as t`` binds the tracer, or None."""
    t = current_tracer()
    if t is None:
        return _NO_SPAN
    return t.span(name, device=device, **meta)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the active tracer's counter ``name`` — a no-op when
    none is active."""
    t = current_tracer()
    if t is not None:
        t.count(name, n)


@contextmanager
def torch_profiler(log_dir: str, *, cuda: bool = True):
    """``torch.profiler.profile`` over the CPU and, with ``cuda``, the
    card; yields the profiler and writes its Chrome trace to
    ``log_dir/trace.json`` when the block ends.  Asking for the card's
    activity where torch sees no CUDA device raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("torch_profiler: CUDA activity asked for, "
                               "but torch sees no CUDA device")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_ops(prof) -> list[dict]:
    """The device operations (kernels, copies) of a finished profile,
    ``[{"name", "device_ms", "calls"}]``, the most device time first; a
    profile without device activity lists its operators by the same
    measure (all zero)."""
    from torch.autograd import DeviceType

    def device_us(e):
        v = getattr(e, "self_device_time_total", None)
        return getattr(e, "self_cuda_time_total", 0.0) if v is None else v
    events = list(prof.key_averages())
    on_card = [e for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    rows = sorted(on_card or events, key=device_us, reverse=True)
    return [{"name": e.key, "device_ms": device_us(e) / 1e3,
             "calls": int(e.count)} for e in rows]

