"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name only begins with it), and
the plain reference loads nothing of the port.  Each check imports in a
fresh interpreter."""

import json
import subprocess
import sys

from bench_helpers import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PRELUDE = f"""
import json, sys
sys.path.insert(0, {str(BENCH)!r})
def tops():
    return sorted({{m.split('.')[0] for m in list(sys.modules)}})
"""


def _tops(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code
                          + "\nprint(json.dumps(tops()))"],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_reference_and_readers_load_no_jax():
    names = [p.stem for p in (BENCH / "metrics").glob("*.py")]
    tops = _tops(f"""
import run, calibrate
from harness import cell, check, faults, feed, port, ranks, spans, trace
from harness.cell import reader
from reference import load, ranl
for arch in ("dense", "rwkv6"):
    load(arch)
for name in {names!r}:
    reader(name)
""")
    assert not FORBIDDEN & set(tops), tops


def test_reference_loads_nothing_of_the_port():
    tops = _tops("""
from reference import load, ranl
for arch in ("dense", "rwkv6"):
    load(arch)
""")
    assert "repro_torch" not in tops and not FORBIDDEN & set(tops), tops


def test_a_run_through_the_port_loads_no_jax():
    tops = _tops(f"""
sys.path.insert(0, {str(BENCH / 'tests')!r})
import torch
torch.set_num_threads(1)
from bench_helpers import smoke
import run
from harness.cell import Cell
name = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))["workloads"][0]["name"]
run.run_cell(smoke(Cell.resolve(name)), 3, 0.01, False, "cpu")
assert not run.forbidden_modules(), run.forbidden_modules()
""")
    assert "repro_torch" in tops and not FORBIDDEN & set(tops), tops
