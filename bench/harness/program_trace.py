"""The program's own view of a few rounds: the spans the port's RANL
round opens and its ``host_syncs`` counter (``repro_torch.obs``), under
the program's tracer, in two passes of as many rounds each, for every
rank after the traced run's profiled rounds (``run.py`` does not call
``measure`` yet: its readers read nothing until it does).

Pass (a) runs the rounds under the program's tracer alone: each span
name's device seconds (its CUDA events) summed a round, and each counter
a round.  Pass (b) runs them under the tracer and a profiler that
records the device's activity alone, and lays the ``ranl.worker_pass``
spans' host intervals (ns on the profiler's clock, the tracer's
``start_ns``/``end_ns``) over the device pass's busy intervals, reduced
by ``harness.trace``'s helpers: the device's idle share inside those
intervals, and the lag from each span's opening to the first launch
inside it and to that launch's device operation.

The port is reached through the program object (``harness/port.py``),
imported when the passes run.  A program whose tracer has no counters,
or whose round opens none of these spans, gives None where it has
nothing, and no metric is read from it."""

from __future__ import annotations

import bisect
import importlib
import json
import statistics
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from harness import trace

ROUNDS = 3
WORKER = "ranl.worker_pass"
API_CAT = "cuda_"      # the host's CUDA API calls (runtime and lower level)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _tracer(prog, run_rounds, rounds, device):
    """``rounds`` rounds under the program's tracer: the tracer, its
    spans resolved."""
    obs = importlib.import_module(prog.rt.__name__ + ".obs")
    with obs.tracing() as tr:
        run_rounds(rounds)
        _sync(device)
    tr.resolve()
    return tr


def per_round(tr, rounds: int) -> dict:
    """{"span_ms": {name: ms a round, by the spans' CUDA events (None
    where a span has none)}, "counters": {name: a round}, or None where
    the tracer keeps no counters}."""
    ms = {}
    for s in tr.spans:
        prev = ms.get(s.name, 0.0)
        ms[s.name] = (None if prev is None or s.device_s is None
                      else prev + s.device_s * 1e3)
    registry = getattr(tr, "metrics", None)
    counters = None
    if registry is not None:
        counters = {name: c["value"] / rounds
                    for name, c in registry.to_dict().items()
                    if c.get("type") == "counter"}
    return {"span_ms": {k: (None if v is None else v / rounds)
                        for k, v in ms.items()},
            "counters": counters}


def idle_inside(spans, busy) -> float | None:
    """100 × the time inside the intervals ``spans`` [(start, end)] in
    which no interval of ``busy`` (merged, sorted; one clock) is open,
    ÷ their total length; None without spans."""
    total = sum(e - s for s, e in spans)
    if total <= 0:
        return None
    starts = [s for s, _ in busy]
    covered = 0.0
    for s, e in spans:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
    return 100.0 * (1.0 - covered / total)


def launches(events) -> list:
    """[(host start, device start)] of every launch (a host CUDA API
    event, category ``cuda_*``) whose device operation (same correlation
    id) the trace holds, sorted; the trace's µs."""
    ops = {}
    for e in events:
        if e.get("cat") in trace.DEVICE_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                ops.setdefault(c, float(e["ts"]))
    return sorted(
        (float(e["ts"]), ops[c]) for e in events
        if str(e.get("cat", "")).startswith(API_CAT)
        and (c := (e.get("args") or {}).get("correlation")) in ops)


def first_launches(spans, pairs) -> list:
    """For each span [(start, end)] with a launch inside it, the first
    such launch's (host start − span start, device start − span start);
    ``pairs`` as ``launches`` gives them."""
    at = [t for t, _ in pairs]
    out = []
    for s, e in spans:
        i = bisect.bisect_left(at, s)
        if i < len(pairs) and pairs[i][0] < e:
            out.append((pairs[i][0] - s, pairs[i][1] - s))
    return out


def _ms(xs):
    return ({"median": statistics.median(xs) / 1e3, "min": min(xs) / 1e3}
            if xs else None)


def measure(prog, run_rounds, device, out: Path,
            rounds: int = ROUNDS) -> dict:
    """Passes (a) and (b) of ``rounds`` rounds each (``run_rounds(n)``
    runs n rounds of the training object); the device pass's trace goes
    to ``out``.  Returns ``per_round`` of pass (a) with
    ``"worker_pass_idle_pct"`` and ``"first_launch"`` (the lag from each
    worker pass's opening to its first launch and to that launch's
    device operation) from pass (b)."""
    got = per_round(_tracer(prog, run_rounds, rounds, device), rounds)
    acts = ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda"
            else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        tr = _tracer(prog, run_rounds, rounds, device)
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    with open(out) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    busy = trace._union((s, e) for s, e, _ in trace._device(events))
    spans = [((s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3)
             for s in tr.spans if s.name == WORKER]
    pairs = launches(events)
    first = first_launches(spans, pairs)
    got["worker_pass_idle_pct"] = idle_inside(spans, busy) if busy else None
    # the shared clock: each worker pass's first launch after the span
    # opens (host), its device operation after that (device); a device
    # operation before its own launch is the profiler's skew between the
    # host's and the device's clocks
    got["first_launch"] = {
        "spans": len(spans), "with_launch": len(first),
        "host_ms": _ms([h for h, _ in first]),
        "device_ms": _ms([d for _, d in first]),
        "device_before_open": sum(1 for _, d in first if d < 0),
        "skew_ms": _ms([d - h for h, d in pairs])}
    return got


def reading(run, key: str):
    """``run.program[key]`` (None where the run has no program passes)."""
    p = getattr(run, "program", None)
    return None if not p else p.get(key)


def span_ms(run, *names):
    """ms a round of the program's spans ``names`` together (a name the
    rounds never opened counts 0: the mesh path decodes no memory where
    every region is covered), or None where the run has none of them or
    one without device time."""
    ms = reading(run, "span_ms") or {}
    vals = [ms[n] for n in names if n in ms]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals)
