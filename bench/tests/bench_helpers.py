"""Helpers of the benchmark's tests: ``bench/`` on the import path, and
cells cut to a size a CPU test can hold."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

# every width of a configuration cut to a CPU test's size (the tests'
# own data: the cells keep their files' sizes)
SMOKE = {"dense": {"d_model": 128, "num_heads": 4, "num_kv_heads": 2,
                   "head_dim": 32, "d_ff": 256, "vocab_size": 512},
         "rwkv6": {"d_model": 128, "d_ff": 256, "vocab_size": 512,
                   "rwkv_head_dim": 32}}
SMOKE_SEQ = 32


def smoke(cell):
    """``cell`` at the smoke size: widths and vocabulary cut, one row a
    worker of ``SMOKE_SEQ`` tokens, its limits kept."""
    cfg = {**cell.config, **SMOKE[cell.config["reference"]]}
    traffic = {**cell.traffic, "batch": cell.traffic["workers"],
               "seq": SMOKE_SEQ, "mask_rounds": 64}
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_names():
    return [w["name"] for w in benchmark()["workloads"]]


def config_names():
    return [c["name"] for c in benchmark()["configs"]]
