"""The program's own spans and counters as the benchmark reads them
(``harness/program_trace.py`` and the readers ``forward_ms``,
``backward_ms``, ``memory_codec_ms``, ``worker_pass_idle_pct`` and
``host_syncs``): the reducer on synthetic spans and device intervals,
the readers on runs without the program's passes, the passes on a smoke
cell (on the CPU, and on the card where one is found), and the import
guard."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from bench_helpers import BENCH, ROOT, smoke

import run
from harness import program_trace as pt
from harness.cell import Cell, reader

NEW = ("forward_ms", "backward_ms", "memory_codec_ms",
       "worker_pass_idle_pct", "host_syncs")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_idle_inside_the_spans():
    busy = [[0.0, 2.0], [3.0, 4.0], [6.0, 10.0]]
    # [1, 5]: busy 1–2 and 3–4, idle 2 of 4; [7, 9]: busy throughout
    assert pt.idle_inside([(1.0, 5.0), (7.0, 9.0)], busy) == \
        pytest.approx(100.0 * 2 / 6)
    assert pt.idle_inside([(4.5, 5.5)], busy) == 100.0
    assert pt.idle_inside([(0.0, 10.0)], []) == 100.0
    assert pt.idle_inside([], busy) is None


def test_first_launches_follow_the_correlation_ids():
    def ev(cat, ts, c):
        return {"ph": "X", "cat": cat, "ts": ts, "dur": 1.0,
                "args": {"correlation": c}}
    events = [ev("cuda_runtime", 10.0, 1), ev("kernel", 30.0, 1),
              ev("cuda_runtime", 12.0, 2), ev("kernel", 40.0, 2),
              ev("cuda_runtime", 55.0, 3), ev("gpu_memcpy", 60.0, 3),
              ev("cuda_runtime", 70.0, 4)]    # no device operation
    pairs = pt.launches(events)
    assert pairs == [(10.0, 30.0), (12.0, 40.0), (55.0, 60.0)]
    # span 1 launches 1 first; span 2 launches 3; span 3 launches
    # nothing with a device operation
    assert pt.first_launches([(5.0, 20.0), (50.0, 65.0), (66.0, 80.0)],
                             pairs) == [(5.0, 25.0), (5.0, 10.0)]


def _tracer(spans, counters=None):
    from repro_torch.obs import MetricsRegistry
    reg = None
    if counters is not None:
        reg = MetricsRegistry()
        for name, v in counters.items():
            reg.counter(name).inc(v)
    return SimpleNamespace(spans=[SimpleNamespace(name=n, device_s=d)
                                  for n, d in spans], metrics=reg)


def test_sums_a_round_and_counters():
    tr = _tracer([("forward", 0.010), ("backward", 0.020),
                  ("forward", 0.012), ("backward", 0.018),
                  ("ranl.memory_decode", 0.001), ("host", None)],
                 {"host_syncs": 16})
    got = pt.per_round(tr, 2)
    assert got["span_ms"]["forward"] == pytest.approx(11.0)
    assert got["span_ms"]["backward"] == pytest.approx(19.0)
    assert got["span_ms"]["host"] is None      # a span with no device_s
    assert got["counters"] == {"host_syncs": 8.0}
    run_ = SimpleNamespace(program=got)
    assert reader("forward_ms").read(run_) == pytest.approx(11.0)
    assert reader("backward_ms").read(run_) == pytest.approx(19.0)
    # a round that encodes no memory reads the decode half alone
    assert reader("memory_codec_ms").read(run_) == pytest.approx(0.5)
    assert reader("host_syncs").read(run_) == 8.0
    # a tracer without counters (an older program) gives none
    assert pt.per_round(_tracer([("forward", 0.01)]), 1)["counters"] is None


@pytest.mark.parametrize("program", [None, {}, {
    "span_ms": {}, "counters": None, "worker_pass_idle_pct": None}],
    ids=["no_passes", "empty", "older_program"])
@pytest.mark.parametrize("name", NEW)
def test_a_reader_reads_nothing_without_the_programs_passes(name, program):
    run_ = SimpleNamespace(trace=None, spans=None)
    if program is not None:
        run_.program = program
    assert reader(name).read(run_) is None


def _passes(cell, device, tmp_path):
    """The smoke cell's training object driven through its first rounds,
    then the program's two passes."""
    prog, fd, _, _, params, state, _, _ = run.setup(cell, 11, device)
    r = cell.traffic["check_steps"] + 1

    def rounds(n):
        nonlocal params, state, r
        for _ in range(n):
            params, state, _ = prog.step(params, state, fd.batch(r),
                                         fd.mask(r))
            r += 1
    return prog, pt.measure(prog, rounds, device, tmp_path / "dev.json")


def test_the_passes_on_a_smoke_cell_on_the_cpu(tmp_path):
    cell = smoke(Cell.resolve("phi4-mini-3.8b.ranl.n4.s512"))
    prog, got = _passes(cell, "cpu", tmp_path)
    layers = cell.config["num_layers"]
    assert got["counters"]["host_syncs"] == layers * cell.traffic["workers"]
    # every span of the round, none timed on the CPU
    assert set(got["span_ms"]) >= {"ranl.round", "ranl.worker_pass",
                                   "forward", "backward", "ranl.aggregate",
                                   "ranl.memory_decode",
                                   "ranl.memory_encode", "ranl.newton"}
    assert all(v is None for v in got["span_ms"].values())
    assert got["worker_pass_idle_pct"] is None      # no device activity
    run_ = SimpleNamespace(program=got)
    assert reader("host_syncs").read(run_) == layers * \
        cell.traffic["workers"]
    assert reader("forward_ms").read(run_) is None


@pytest.mark.gpu
def test_all_five_read_on_a_traced_smoke_on_the_card(cuda, tmp_path):
    cell = smoke(Cell.resolve("phi4-mini-3.8b.ranl.n4.s512"))
    _, got = _passes(cell, cuda, tmp_path)
    run_ = SimpleNamespace(program=got)
    vals = {name: reader(name).read(run_) for name in NEW}
    assert all(isinstance(v, float) for v in vals.values()), vals
    assert vals["forward_ms"] > 0 and vals["backward_ms"] > 0
    assert vals["memory_codec_ms"] > 0
    assert 0.0 <= vals["worker_pass_idle_pct"] <= 100.0
    assert vals["host_syncs"] == cell.config["num_layers"] * \
        cell.traffic["workers"]
    first = got["first_launch"]
    assert first["with_launch"] == first["spans"] > 0, first
    assert first["host_ms"]["min"] >= 0.0, first


def test_the_program_trace_loads_no_jax():
    names = list(NEW)
    code = f"""
import json, sys
sys.path.insert(0, {str(BENCH)!r})
from harness import program_trace
from harness.cell import reader
for name in {names!r}:
    reader(name)
print(json.dumps(sorted({{m.split('.')[0] for m in list(sys.modules)}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not FORBIDDEN & tops, tops
    assert "repro_torch" not in tops       # the port is reached at run time
