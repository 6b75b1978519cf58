"""Span tracing: where a run's time goes, on the host and on the card.

The engines' simulated clock (``hetero.cost``) prices the *modeled*
cluster; this module meters the run itself, as explicit ``with
span("execute"): ...`` blocks collected by a :class:`Tracer`.

Zero-cost by default: ``span`` is a no-op ``nullcontext`` unless a
tracer has been activated (``with tracing() as tr:`` or
``push_tracer``), so the hooks in ``repro_torch.run`` and the train CLI
launch nothing and never synchronise in an untraced run.  Spans touch no
tensor of the run, so a traced run is bit for bit an untraced one.

Each span keeps ``dur``, host ``perf_counter`` seconds, as the
reference's do.  A span given a CUDA ``device`` also records a
``torch.cuda.Event(enable_timing=True)`` pair on that device's current
stream; the elapsed time between them, ``device_s``, is resolved when
the records are read (``span_records``, ``chrome_trace``, ``totals``),
after one synchronise, never inside the run.  A CPU span has no
``device_s``.

Exports:

* ``Tracer.chrome_trace()`` / ``Tracer.write_chrome(path)`` — the
  Chrome-trace ("Perfetto"/``chrome://tracing``) JSON event form;
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
from contextlib import contextmanager
from dataclasses import dataclass, field

__all__ = ["SpanRecord", "Tracer", "tracing", "span", "current_tracer",
           "push_tracer", "pop_tracer", "torch_profiler", "device_ops"]


@dataclass(frozen=True)
class SpanRecord:
    """One closed span: ``t0``/``dur`` are host ``perf_counter`` seconds
    (``t0`` relative to the tracer's epoch); ``device_s`` the seconds the
    card's stream took between the span's CUDA events (None on the CPU,
    and until the tracer resolves it)."""
    name: str
    t0: float
    dur: float
    meta: tuple[tuple[str, object], ...] = ()
    device_s: float | None = None


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
    first) to have the CUDA spans' ``device_s``."""
    epoch: float = field(default_factory=time.perf_counter)
    spans: list[SpanRecord] = field(default_factory=list)
    _events: dict = field(default_factory=dict, repr=False, init=False)

    @contextmanager
    def span(self, name: str, *, device=None, **meta):
        dev = _cuda_device(device)
        start = _record_event(dev) if dev is not None else None
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dur = time.perf_counter() - t0
            if dev is not None:
                self._events[len(self.spans)] = (dev, start,
                                                 _record_event(dev))
            self.spans.append(SpanRecord(
                name=str(name), t0=t0 - self.epoch, dur=dur,
                meta=tuple(sorted(meta.items()))))

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
        ``chrome://tracing``): complete ("X") events in microseconds; a
        CUDA span carries its ``device_s`` in ``args``."""
        return {"traceEvents": [
            {"name": s.name, "ph": "X", "pid": 0, "tid": 0,
             "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
             "args": {**dict(s.meta),
                      **({"device_s": s.device_s}
                         if s.device_s is not None else {})}}
            for s in self.resolve()]}

    def write_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
            f.write("\n")
        return path


# -- module-level tracer stack (spans wrap host-side phases of one thread)
_STACK: list[Tracer] = []


def current_tracer() -> Tracer | None:
    return _STACK[-1] if _STACK else None


def push_tracer(tracer: Tracer | None = None) -> Tracer:
    tracer = tracer or Tracer()
    _STACK.append(tracer)
    return tracer


def pop_tracer() -> Tracer:
    return _STACK.pop()


@contextmanager
def tracing(tracer: Tracer | None = None):
    """Activate a tracer for the block: every ``span(...)`` inside
    (including the hook inside ``repro_torch.run``) records into it.
    Yields the :class:`Tracer`."""
    t = push_tracer(tracer)
    try:
        yield t
    finally:
        pop_tracer()


@contextmanager
def span(name: str, *, device=None, **meta):
    """Record a span on the active tracer — a no-op when none is active
    (the zero-cost default for the hooks in hot paths).  On a CUDA
    ``device`` the span also times the card's stream."""
    t = current_tracer()
    if t is None:
        yield None
        return
    with t.span(name, device=device, **meta):
        yield t


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

