"""Layer spans from the benchmark's own side: module attributes that the
program looks up when it calls them are wrapped, for the traced run
only, in a ``record_function`` range and a pair of CUDA events (host
clock on the CPU).  A name the program no longer has is left out, and
its metric reads nothing."""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function


class Spans:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = {}

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wrap(self, fn, name):
        marks = self.marks.setdefault(name, [])

        def wrapped(*args, **kwargs):
            with record_function(f"bench.{name}"):
                start = self._mark()
                out = fn(*args, **kwargs)
                marks.append((start, self._mark()))
            return out
        return wrapped

    @contextmanager
    def around(self, module, names):
        """Wrap ``module.<name>`` for each name it has, restored on
        exit."""
        saved = {n: getattr(module, n) for n in names if hasattr(module, n)}
        for n, fn in saved.items():
            setattr(module, n, self.wrap(fn, n))
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(module, n, fn)

    def ms(self) -> dict:
        """{name: [ms of each call]}, after the device has finished."""
        if self.cuda:
            torch.cuda.synchronize()
            return {n: [a.elapsed_time(b) for a, b in m]
                    for n, m in self.marks.items()}
        return {n: [(b - a) * 1e3 for a, b in m]
                for n, m in self.marks.items()}


def per_round(run, name: str):
    """Mean ms a round of span ``name`` over the traced run's span rounds,
    or None where the run has no such span."""
    ms = (run.spans or {}).get(name)
    if not ms or not run.span_rounds:
        return None
    return sum(ms) / run.span_rounds
