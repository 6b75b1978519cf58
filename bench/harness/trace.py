"""The profiler's view of a few rounds: ``torch.profiler`` (CUPTI),
reduced to what the per-layer metrics and the breakdown read, in two
profiled passes over as many rounds each.

First as many rounds run unprofiled, timed by the host's clock between
two synchronisations: the profiler's own host work slows a round that
the host paces, even with the device's activity alone recorded.  The
device pass records the device's activity alone between two
synchronisations: its busy time (the union of the trace's ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` intervals), its operations, and the
window's length by the host's clock.  The host pass adds the host's
operators and the ``bench.*`` spans inside the range ``bench.window``;
it only names the idle gaps: each by what the host was doing when it
began, the innermost ``bench.*`` span open then and the innermost
operator under it."""

from __future__ import annotations

import bisect
import json
import time
from contextlib import nullcontext
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
TOP = 10
NAME_CHARS = 160   # a kernel's name, cut in the breakdown


def _events(prof, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    with open(out) as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X" and "dur" in e]


def record(run_rounds, rounds: int, device, out: Path, count,
           spanned=nullcontext) -> dict:
    """``rounds`` rounds unprofiled, a throwaway profiled round, then
    the device pass and the host pass of ``rounds`` rounds each, the
    host pass inside ``spanned()`` (the layer spans); both traces go
    beside ``out``.  Returns ``device_summary`` of the device pass with
    ``"plain_window_s"`` (the unprofiled rounds' time), ``"gaps"`` from
    the host pass, ``"host_window_s"`` and ``"host_busy_s"`` (what the
    host pass costs), and ``"launches"``: what ``count()`` (counters, as
    a dict) rose by over the device pass."""
    cuda = torch.device(device).type == "cuda"
    dev_acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    host_acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                          else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()
    sync()
    start = time.perf_counter()
    run_rounds(rounds)
    sync()
    plain_window_s = time.perf_counter() - start
    with profile(activities=dev_acts):      # the profiler's own start-up
        run_rounds(1)
        sync()
    with profile(activities=dev_acts) as prof:
        before = count()
        start = time.perf_counter()
        run_rounds(rounds)
        sync()
        window_s = time.perf_counter() - start
        after = count()
    summary = device_summary(_events(prof, out.with_suffix(".device.json")),
                             window_s)
    with spanned(), profile(activities=host_acts) as prof:
        with record_function(WINDOW):
            run_rounds(rounds)
            sync()
    host = host_gaps(_events(prof, out))
    summary["plain_window_s"] = plain_window_s
    summary["launches"] = {k: v - before.get(k, 0) for k, v in after.items()}
    summary["gaps"] = host.pop("gaps")
    summary.update(host)
    return summary


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class _Ranges:
    """Host ranges [(start, end, name)] sorted by start: ``at(t)`` is
    the shortest that holds t among the ``LOOK`` that began last before
    it (ranges of several threads interleave)."""
    LOOK = 2000

    def __init__(self, ranges):
        self.r = sorted(ranges)
        self.starts = [s for s, _, _ in self.r]

    def at(self, t):
        best = None
        i = bisect.bisect_right(self.starts, t)
        for s, e, name in self.r[max(0, i - self.LOOK):i][::-1]:
            if e > t and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return None if best is None else best[2]


def _device(events):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in DEVICE_CATS]


def device_summary(events, window_s: float) -> dict:
    """{"window_s", "busy_s", "ops": {name: s}, "counts": {name: n}} of
    a device pass's events (µs in the trace) over a window of
    ``window_s`` by the host's clock."""
    ops, counts = {}, {}
    dev = _device(events)
    for s, e1, name in dev:
        ops[name] = ops.get(name, 0.0) + (e1 - s) * 1e-6
        counts[name] = counts.get(name, 0) + 1
    busy = _union((s, e1) for s, e1, _ in dev)
    return {"window_s": window_s,
            "busy_s": sum(e1 - s for s, e1 in busy) * 1e-6,
            "ops": ops, "counts": counts}


def host_gaps(events) -> dict:
    """{"gaps": {host activity: idle s}, "host_window_s", "host_busy_s"}
    of a host pass's events inside ``bench.window``; no gaps where the
    trace has no such window."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {"gaps": {}, "host_window_s": None, "host_busy_s": None}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    busy = _union((s, e1) for s, e1, _ in _device(events)
                  if s >= w0 and e1 <= w1)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in ("user_annotation", "cpu_op")
            and e["name"] != WINDOW]
    marks = _Ranges(r for r in host if r[2].startswith("bench."))
    opers = _Ranges(r for r in host if not r[2].startswith("bench."))
    gaps, t = {}, w0
    for s, e1 in busy + [[w1, w1]]:
        if s > t:
            name = (f"{marks.at(t) or 'outside spans'} / "
                    f"{opers.at(t) or 'no operator'}")
            gaps[name] = gaps.get(name, 0.0) + (s - t) * 1e-6
        t = max(t, e1)
    return {"gaps": gaps, "host_window_s": (w1 - w0) * 1e-6,
            "host_busy_s": sum(e1 - s for s, e1 in busy) * 1e-6}


def breakdown(summary: dict) -> dict:
    """The ``breakdown`` of a result line: the costliest device
    operations and the idle time by host activity, ``TOP`` of each."""
    def top(d):
        return [[k[:NAME_CHARS], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(summary["ops"]),
            "idle_gaps": top(summary["gaps"])}
