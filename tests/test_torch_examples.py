"""The port's examples (``examples/torch_*.py``) run on the CPU with
``--device cpu``, and the quickstart prints what the reference's
``examples/quickstart.py`` prints, line for line: the same rows, the
same GD column, coverage, uplink and tau*; RANL's error, at f32's
rounding floor after round 5 in both, below 1e-9 in both."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402, F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {
    "torch_quickstart": ["--device", "cpu"],
    "torch_convex_comparison": ["--device", "cpu"],
    "torch_serve_decode": ["--device", "cpu"],
    "torch_train_lm": ["--tiny", "--steps", "2", "--device", "cpu"],
    "quickstart": [],                       # the reference, to compare
}


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Every example at once, each in its own process."""
    tmp = tmp_path_factory.mktemp("examples")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {}
    for name, argv in RUNS.items():
        if name == "torch_train_lm":
            argv = argv + ["--ckpt", str(tmp / "ckpt")]
        procs[name] = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", f"{name}.py")]
            + argv, cwd=tmp, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        out[name] = (p.returncode, stdout, stderr)
    return tmp, out


def _lines(outputs, name):
    rc, stdout, stderr = outputs[1][name]
    assert rc == 0, stderr[-4000:]
    return [line for line in stdout.splitlines() if line.strip()]


def test_quickstart_prints_what_the_reference_prints(outputs):
    pytest.importorskip("jax")
    got, want = (_lines(outputs, "torch_quickstart"),
                 _lines(outputs, "quickstart"))
    assert len(got) == len(want) == 11
    assert got[0] == want[0]
    for a, b in zip(got[1:8], want[1:8]):          # the table
        ta, tb = a.split(), b.split()
        assert (ta[0], ta[2], ta[3]) == (tb[0], tb[2], tb[3])
        if ta[0] == "0":
            assert ta[1] == tb[1]
        else:
            assert float(ta[1]) < 1e-9 and float(tb[1]) < 1e-9
    assert got[8:10] == want[8:10]                 # uplink, tau*
    assert got[10].split("tau* range")[1] == want[10].split("tau* range")[1]


def test_convex_comparison_prints_its_table(outputs):
    lines = _lines(outputs, "torch_convex_comparison")
    assert lines[0].startswith("rounds to ||x-x*||^2 <= 1e-08")
    rows = [line.split() for line in lines[2:6]]
    assert [r[0] for r in rows] == ["10", "100", "1000", "10000"]
    for r in rows:
        assert int(r[1]) <= 60 and r[2].startswith("[")
    assert lines[-1].startswith("GD degrades linearly")


def test_serve_decode_runs_one_arch_per_family(outputs):
    lines = _lines(outputs, "torch_serve_decode")
    assert [line for line in lines if line.startswith("===")] == [
        f"=== {a} ===" for a in ("phi4-mini-3.8b", "rwkv6-3b",
                                 "hymba-1.5b", "musicgen-medium")]
    assert sum(line.startswith("prefill 4x32:") for line in lines) == 4
    gen = [line for line in lines if line.startswith("generated:")]
    assert len(gen) == 4


def test_train_lm_tiny_trains_and_checkpoints(outputs):
    tmp, _ = outputs
    lines = _lines(outputs, "torch_train_lm")
    assert lines[0].startswith("config phi4-mini-3.8b-smoke:")
    assert [line.split()[1] for line in lines[1:3]] == ["0", "1"]
    final = json.loads(lines[-1])
    assert final["steps"] == 2 and np.isfinite(final["final_loss"])
    manifest = json.loads((tmp / "ckpt" / "manifest.json").read_text())
    assert manifest["step"] == 2
