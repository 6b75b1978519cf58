"""The harness takes its cells as data: each cell of ``BENCHMARK.json``
resolves to its own files, a configuration, a traffic mix and a metric
added as new files are found by name with no existing file edited, the
file keeps to the benchmark's contract, and a run without a card prints
nothing and fails."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_helpers import BENCH, ROOT, SMOKE, benchmark, cell_names

import run
from harness.cell import Cell, reader
from reference import load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                   r"_rank$|d_model|d_ff|expan|experts_per|width)")


@pytest.mark.parametrize("name", cell_names())
def test_a_cell_resolves_to_its_own_files(name):
    cell = Cell.resolve(name)
    load(cell.config["reference"]).param_specs(cell.config)
    assert {"workers", "batch", "seq", "masks", "ranl",
            "check_steps"} <= set(cell.traffic)
    assert cell.limits and all(isinstance(v, float)
                               for v in cell.limits.values())
    # the first round's loss, and a number each of curvature, first
    # gradient and change
    assert "loss.1" in cell.limits
    for kind in ("curvature", "grad", "change"):
        assert any(k.split(".")[0] == kind for k in cell.limits), kind
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "train_tokens_per_s"}
    assert cell.per_layer


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and
    a cell as new files and entries: they resolve and run (at a smoke
    size on the CPU) with every file that was there unchanged."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "bench")
    b = tmp_path / "bench"
    cfg = {**json.loads((b / "configs" / "phi4-mini-3.8b.json").read_text()),
           **SMOKE["dense"], "name": "tiny-dense"}
    (b / "configs" / "tiny-dense.json").write_text(json.dumps(cfg))
    mix = {**json.loads((b / "traffic" / "ranl.n4.s512.json").read_text()),
           "workers": 2, "batch": 2, "seq": 16, "mask_rounds": 8}
    (b / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (b / "metrics" / "rounds_run.py").write_text(
        "def read(run):\n    return float(run.rounds)\n")
    (b / "limits" / "tiny-dense.tiny.json").write_text(json.dumps(
        {"limits": {"loss.1": 1e-4, "curvature": 1e-3, "grad": 1e-3,
                    "change": 1e-2}}))
    bj = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bj["configs"].append({"name": "tiny-dense", "source": "test",
                          "file": "bench/configs/tiny-dense.json",
                          "reduced": [], "why": "test"})
    bj["workloads"].append({"name": "tiny-dense.tiny", "config": "tiny-dense",
                            "traffic": "tiny", "chips": 1, "why": "test"})
    bj["end_to_end"].append({"name": "rounds_run", "unit": "rounds",
                             "better": "higher", "bound": 0.25,
                             "source": "host_clock",
                             "workloads": ["tiny-dense.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bj))

    cell = Cell.resolve("tiny-dense.tiny", root=tmp_path)
    assert cell.config["d_model"] == SMOKE["dense"]["d_model"]
    assert cell.traffic["seq"] == 16
    res = run.run_cell(cell, 5, 0.01, False, "cpu", out=tmp_path / "out")
    assert res["correct"], res["checks"]
    assert res["metrics"]["rounds_run"]["value"] == res["attempted"]
    after = _digest(tmp_path / "bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_without_a_card_a_run_prints_nothing_and_fails():
    name = cell_names()[0]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", name,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_the_file_keeps_to_the_contract():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "bench/run.py"]
    assert b["paths"] == ["bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's time
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in b["workloads"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        for w in m.get("workloads", []):
            assert w in cell_names()
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in cell_names():
        cell = Cell.resolve(w)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(json.dumps(b)) <= 64 * 1024
