"""A cell, resolved by name from ``BENCHMARK.json`` to the files of its
own: ``configs/<config>.json`` (sizes and where they come from),
``traffic/<traffic>.json`` (workers, batch, masks, the RANL settings),
``limits/<cell>.json`` (under ``"limits"``, the numbers the comparison
holds and their limits; beside it the readings they were set from) and
one reader
``metrics/<metric>.py`` a metric.  A later cell, mix or metric is new
files and entries; no file here names one."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def reader(name: str, bench: Path = BENCH):
    """The module ``metrics/<name>.py``: its ``read(run)`` gives the
    metric, or None where the run has nothing to read it from."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict | None   # the comparison's limits, None where not set
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench: Path = BENCH   # the folder its files were found in

    @classmethod
    def resolve(cls, name: str, root: Path = ROOT) -> "Cell":
        b = load_benchmark(root)
        work = {w["name"]: w for w in b["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r}; known: {sorted(work)}")
        w = work[name]
        conf = {c["name"]: c for c in b["configs"]}[w["config"]]
        bench = root / BENCH.name
        limits_path = bench / "limits" / f"{name}.json"

        def here(m):
            return name in m.get("workloads", [name])
        return cls(
            name=name, chips=int(w["chips"]),
            config=_json(root / conf["file"]),
            traffic=_json(bench / "traffic" / f"{w['traffic']}.json"),
            limits=(_json(limits_path)["limits"] if limits_path.is_file()
                    else None),
            end_to_end=[m for m in b["end_to_end"] if here(m)],
            per_layer=[m for m in b["per_layer"] if here(m)], bench=bench)
