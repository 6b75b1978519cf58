"""Structured run journal: one JSONL record per recorded round.

Every engine run (and every ``launch.train`` step loop) can leave behind
a machine-readable journal.  A journal is a JSON-Lines file (or an
in-memory record list) with the reference's **versioned schema**, so
either package's report reads either package's journals:

* record 0 is the run **header** (``kind="header"``): schema version,
  engine, ``RanlOptions`` as a dict, mesh shape/axes, scenario spec,
  the contract key from ``analysis.contracts``, the package version and
  the per-round byte budget the drift alarm checks against (the port
  compiles no HLO, so it writes no ``hlo`` block of its own; a caller
  that has one passes it to ``make_header``);
* then one ``kind="round"`` record per round with the per-round traces
  (coverage, comm_floats/comm_bytes, pod_bytes, round_time, cumulative
  ``sim_s``, max_stale) plus loss/dist_sq on the rounds whose iterate
  the run recorded (``record_every`` thins iterates, never the
  per-round traces);
* ``kind="drift"`` records from the live contract-drift alarm
  (``obs.metrics.check_byte_drift``);
* ``kind="span"`` records from an active ``obs.trace`` tracer (with
  ``device_s`` where the span timed the card);
* a final ``kind="summary"`` record (τ*, totals, final loss).

Everything here runs on the host on the finished result, which the
writer copies off the card once: a run with a journal attached is bit
for bit the run without one.  On a sharded run every rank calls the
writer: a journal given as a path is written by global rank 0 alone, a
:class:`Journal` object is filled on every rank.

This module imports the stdlib only (numpy, torch and the analysis
package load inside the writer), so the report CLI reads journals
without the engine stack.
"""

from __future__ import annotations

import io
import json
import os
import types

SCHEMA_VERSION = 1

#: Record kinds a schema-1 journal may contain, in the (partial) order
#: validate_journal enforces: header first, summary (if present) last.
RECORD_KINDS = ("header", "round", "drift", "span", "summary")

_REQUIRED_HEADER = ("schema", "engine", "options", "version")
_REQUIRED_ROUND = ("t",)
_NUMERIC_ROUND = ("loss", "dist_sq", "coverage", "comm_floats",
                  "comm_bytes", "pod_bytes", "round_time", "sim_s")

_RESULT_FIELDS = ("losses", "dist_sq", "coverage", "comm_floats",
                  "round_time", "max_stale", "comm_bytes", "pod_bytes",
                  "tau_star", "tau_covered")

_VERSION: str | None = None


def package_version() -> str:
    """The installed distribution's version (the one that ships both
    packages), resolved once per process; ``0+unknown`` uninstalled."""
    global _VERSION
    if _VERSION is None:
        from importlib.metadata import PackageNotFoundError, version
        try:
            _VERSION = version("repro")
        except PackageNotFoundError:
            _VERSION = "0+unknown"
    return _VERSION


class Journal:
    """Append-only journal: records go to ``path`` as JSON lines and are
    kept in ``.records`` (so in-memory journals need no file at all —
    pass ``path=None``, or pass a ``Journal`` straight to
    ``repro_torch.run(journal=...)``)."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = os.fspath(path) if path is not None else None
        self.records: list[dict] = []
        self._fh: io.TextIOBase | None = (
            open(self.path, "w") if self.path is not None else None)

    def write(self, record: dict) -> dict:
        if "kind" not in record:
            raise ValueError(f"journal record needs a 'kind': {record!r}")
        self.records.append(record)
        if self._fh is not None:
            self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        return record

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _mesh_dict(mesh) -> dict | None:
    """A ``DeviceMesh``'s extents and dimension names."""
    if mesh is None:
        return None
    return {"shape": [int(s) for s in mesh.mesh.shape],
            "axes": [str(a) for a in mesh.mesh_dim_names]}


def _options_dict(options) -> dict:
    """``RanlOptions`` (or any dataclass) -> plain JSON-able dict; plain
    dicts pass through (the train CLI's config records)."""
    import dataclasses
    if dataclasses.is_dataclass(options) and not isinstance(options, type):
        d = dataclasses.asdict(options)
    elif isinstance(options, dict):
        d = dict(options)
    else:
        raise TypeError(f"options must be a dataclass or dict, "
                        f"got {options!r}")
    return json.loads(json.dumps(d, default=str))   # tuples/enums -> JSON


def make_header(*, engine: str, options, mesh=None, scenario=None,
                contract_key=None, problem=None, byte_budget=None,
                hlo=None, seeds=None, extra=None) -> dict:
    header = {
        "kind": "header", "schema": SCHEMA_VERSION,
        "engine": str(engine),
        "options": _options_dict(options),
        "mesh": _mesh_dict(mesh),
        "scenario": scenario if scenario is None else str(scenario),
        "contract_key": contract_key,
        "version": package_version(),
    }
    if problem is not None:
        header["problem"] = {"dim": int(problem.dim),
                             "num_workers": int(problem.num_workers)}
    if byte_budget is not None:
        header["byte_budget"] = {k: float(v)
                                 for k, v in byte_budget.items()}
    if hlo is not None:
        header["hlo"] = hlo
    if seeds is not None:
        header["seeds"] = int(seeds)
    if extra:
        header.update(extra)
    return header


def _np(x, dtype=None):
    """A tensor (on any device), an int or an array -> numpy, on the
    host."""
    import numpy as np
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _on_host(result):
    """The journal's fields of a ``RanlResult``, copied off the card
    once, as numpy arrays."""
    return types.SimpleNamespace(**{
        f: (None if getattr(result, f, None) is None
            else _np(getattr(result, f))) for f in _RESULT_FIELDS})


def _recorded_rounds(num_rounds: int, record_every: int) -> list[int]:
    """The rounds whose iterate a ``record_every``-thinned trace kept
    (every k-th round plus T)."""
    T, k = int(num_rounds), int(record_every)
    if k <= 1:
        return list(range(1, T + 1))
    return sorted(set(range(k, T + 1, k)) | ({T} if T > 0 else set()))


def result_round_records(result, *, record_every: int = 1) -> list[dict]:
    """``RanlResult`` -> per-round journal records (host-side).

    Per-round traces (coverage/comm/round_time/max_stale/bytes) are full
    length; iterate-indexed traces (loss/dist_sq) may be thinned, so
    those fields appear only on the recorded rounds.  Batched results
    (leading seed axis) are reduced to their across-seed mean (the
    staleness to its maximum).
    """
    def tr(x, reduce="mean"):
        if x is None:
            return None
        a = _np(x, "float64")
        if a.ndim == 2:                       # (B, T) batched runs
            a = a.mean(axis=0) if reduce == "mean" else a.max(axis=0)
        return a

    losses, dists = tr(result.losses), tr(result.dist_sq)
    cov, comm = tr(result.coverage), tr(result.comm_floats)
    times, stale = tr(result.round_time), tr(result.max_stale, "max")
    cbytes, pbytes = tr(result.comm_bytes), tr(result.pod_bytes)
    T = 0 if cov is None else int(cov.shape[0])
    kept = _recorded_rounds(T, record_every)
    # iterate traces carry [x0, x1, kept rounds...]: kept[j] <-> idx j+2
    iter_of = {r: j + 2 for j, r in enumerate(kept)}
    sim = 0.0
    out = []
    for t in range(1, T + 1):
        rec = {"kind": "round", "t": t,
               "coverage": float(cov[t - 1]),
               "comm_floats": float(comm[t - 1])}
        if times is not None and times.shape[0] == T:
            sim += float(times[t - 1])
            rec["round_time"] = float(times[t - 1])
            rec["sim_s"] = sim
        if stale is not None and stale.shape[0] == T:
            rec["max_stale"] = int(stale[t - 1])
        if cbytes is not None and cbytes.shape[0] == T:
            rec["comm_bytes"] = float(cbytes[t - 1])
        if pbytes is not None and pbytes.shape[0] == T:
            rec["pod_bytes"] = float(pbytes[t - 1])
        j = iter_of.get(t)
        if j is not None and losses is not None and j < losses.shape[0]:
            rec["loss"] = float(losses[j])
            rec["dist_sq"] = float(dists[j])
        out.append(rec)
    return out


def result_summary(result) -> dict:
    tau = _np(result.tau_star)
    tau_cov = _np(result.tau_covered)
    losses = _np(result.losses, "float64")
    if losses.ndim == 2:
        losses = losses.mean(axis=0)
    rec = {"kind": "summary",
           "rounds": (0 if result.coverage is None
                      else int(_np(result.coverage).shape[-1])),
           "tau_star": int(tau.min()),
           "tau_covered": int(tau_cov.min()),
           "final_loss": float(losses[-1])}
    for name in ("comm_bytes", "pod_bytes"):
        v = getattr(result, name)
        if v is not None:
            rec[f"{name}_total"] = float(_np(v, "float64").sum())
    if result.round_time is not None:
        rec["sim_total"] = float(_np(result.round_time, "float64")
                                 .sum(axis=-1).max())
    return rec


def _global_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def write_run_journal(journal, result, *, engine: str, options,
                      mesh=None, problem=None, scenario=None,
                      tracer=None, hlo=None, check_drift: bool = True,
                      close: bool | None = None) -> "Journal":
    """Serialize one engine run into ``journal`` (a path or a
    :class:`Journal`): header, per-round records, drift-alarm records,
    span records from ``tracer`` (or the active ``obs.trace`` tracer),
    and the summary.  Runs on the host on the finished result.

    Returns the :class:`Journal`; when ``journal`` came in as a path the
    file is closed before returning (``close=False`` keeps it open).  A
    path is written by global rank 0 only; the other ranks of a
    ``torch.distributed`` run fill an in-memory journal with the same
    records.
    """
    owns = not isinstance(journal, Journal)
    if owns:
        journal = Journal(journal if _global_rank() == 0 else None)
    close = owns if close is None else close
    if not (hasattr(problem, "dim") and hasattr(problem, "num_workers")):
        problem = None              # custom problems: no wire-model budget

    from ..analysis.contracts import contract_key, round_byte_budget
    budget = None
    key = None
    try:
        key = contract_key(engine, options)
    except AttributeError:
        pass                        # plain-dict options (train CLI path)
    if problem is not None and hasattr(options, "compression_spec"):
        budget = round_byte_budget(options, dim=problem.dim,
                                   num_workers=problem.num_workers)

    result = _on_host(result)
    seeds = (int(result.losses.shape[0]) if result.losses.ndim == 2
             else None)
    record_every = getattr(options, "record_every", 1)

    journal.write(make_header(engine=engine, options=options, mesh=mesh,
                              scenario=scenario, contract_key=key,
                              problem=problem, byte_budget=budget, hlo=hlo,
                              seeds=seeds))
    rounds = result_round_records(result, record_every=record_every)
    for rec in rounds:
        journal.write(rec)
    if check_drift and budget is not None:
        from .metrics import check_byte_drift
        for rec in check_byte_drift(rounds, budget):
            journal.write(rec)
    if tracer is None:
        from .trace import current_tracer
        tracer = current_tracer()
    if tracer is not None:
        for rec in tracer.span_records():
            journal.write(rec)
    journal.write(result_summary(result))
    if close:
        journal.close()
    return journal


def read_journal(path: str | os.PathLike) -> list[dict]:
    """Parse a JSONL journal file back into its record list."""
    records = []
    with open(os.fspath(path)) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not valid JSON: "
                                 f"{e.msg}") from e
    return records


def validate_journal(records) -> list[str]:
    """Schema check -> list of problems (empty = valid).

    Accepts a record list, a :class:`Journal`, or a path.  Enforces:
    header first (with schema version and required fields), known record
    kinds only, strictly increasing round indices, numeric round fields,
    summary (when present) last.
    """
    if isinstance(records, Journal):
        records = records.records
    elif isinstance(records, (str, os.PathLike)):
        records = read_journal(records)
    problems: list[str] = []
    if not records:
        return ["empty journal (no header record)"]
    head = records[0]
    if head.get("kind") != "header":
        problems.append(f"record 0 must be the header, got "
                        f"kind={head.get('kind')!r}")
    else:
        if head.get("schema") != SCHEMA_VERSION:
            problems.append(f"unsupported schema={head.get('schema')!r} "
                            f"(this reader: {SCHEMA_VERSION})")
        for k in _REQUIRED_HEADER:
            if k not in head:
                problems.append(f"header missing required field {k!r}")
        if not isinstance(head.get("options", {}), dict):
            problems.append("header 'options' must be a dict")
    last_t = 0
    for i, rec in enumerate(records[1:], start=1):
        kind = rec.get("kind")
        if kind not in RECORD_KINDS:
            problems.append(f"record {i}: unknown kind {kind!r}")
            continue
        if kind == "header":
            problems.append(f"record {i}: duplicate header")
        if kind == "summary" and i != len(records) - 1:
            problems.append(f"record {i}: summary must be the last "
                            f"record")
        if kind == "round":
            for k in _REQUIRED_ROUND:
                if k not in rec:
                    problems.append(f"record {i}: round missing {k!r}")
            t = rec.get("t")
            if isinstance(t, int):
                if t <= last_t:
                    problems.append(f"record {i}: round t={t} not "
                                    f"increasing (previous {last_t})")
                last_t = t
            else:
                problems.append(f"record {i}: round t={t!r} must be an "
                                f"int")
            for k in _NUMERIC_ROUND:
                if k in rec and not isinstance(rec[k], (int, float)):
                    problems.append(f"record {i}: round field {k!r} "
                                    f"must be numeric, got {rec[k]!r}")
    return problems
