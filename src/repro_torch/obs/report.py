"""Journal reports: render/diff run journals, terminal or Markdown.

``python -m repro_torch.obs.report run.jsonl`` summarizes a journal —
convergence, time-to-target, bytes/round, staleness histogram, pod
traffic, span breakdown (and the spans' device seconds, where a span
timed the card), drift alarms; ``--diff A B`` compares two runs side by
side (A/B compression, quorum, hierarchy experiments); ``--validate``
schema-checks without rendering.  Both packages write the same schema,
so this renders either package's journals, a reference journal exactly
as the reference's report does.

Cookbook::

    python -m repro_torch.obs.report run.jsonl                # text summary
    python -m repro_torch.obs.report run.jsonl --md           # Markdown table
    python -m repro_torch.obs.report run.jsonl --target 1e-3  # time-to-target
    python -m repro_torch.obs.report --diff base.jsonl cand.jsonl
    python -m repro_torch.obs.report run.jsonl --validate     # schema only

Stdlib-only: it reads journals without torch.
"""

from __future__ import annotations

import argparse
import json
import sys

from .journal import read_journal, validate_journal

__all__ = ["emit", "summarize", "render", "render_md", "diff",
           "render_diff", "main"]


def emit(msg: str = "", *, err: bool = False) -> None:
    """The obs layer's output chokepoint.  Always flushes — callers use
    it for live progress in piped logs."""
    stream = sys.stderr if err else sys.stdout
    stream.write(str(msg) + "\n")
    stream.flush()


def _split(records):
    header = records[0] if records and records[0].get("kind") == "header" \
        else {}
    by_kind = {"round": [], "drift": [], "span": [], "summary": []}
    for rec in records:
        k = rec.get("kind")
        if k in by_kind:
            by_kind[k].append(rec)
    return header, by_kind


def _time_to_target(rounds, target: float):
    """First (round t, sim_s) whose recorded loss reaches ``target``."""
    for rec in rounds:
        if "loss" in rec and rec["loss"] <= target:
            return rec["t"], rec.get("sim_s")
    return None, None


def _histogram(values, *, width: int = 24) -> list[tuple[str, int, str]]:
    """(label, count, bar) rows over the distinct sorted values — per-
    round staleness takes a handful of small ints, so exact buckets beat
    ranged ones."""
    counts: dict[float, int] = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    if not counts:
        return []
    peak = max(counts.values())
    return [(f"{k:g}", n, "#" * max(1, round(width * n / peak)))
            for k, n in sorted(counts.items())]


def summarize(records) -> dict:
    """Journal records -> one flat stats dict (the render/diff basis)."""
    header, by = _split(records)
    rounds, spans = by["round"], by["span"]
    losses = [(r["t"], r["loss"]) for r in rounds if "loss" in r]
    cbytes = [r["comm_bytes"] for r in rounds if "comm_bytes" in r]
    pbytes = [r["pod_bytes"] for r in rounds if "pod_bytes" in r]
    stale = [r["max_stale"] for r in rounds if "max_stale" in r]
    summary = by["summary"][-1] if by["summary"] else {}
    span_totals: dict[str, float] = {}
    span_device: dict[str, float] = {}
    for s in spans:
        span_totals[s["name"]] = (span_totals.get(s["name"], 0.0)
                                  + s["dur_s"])
        if "device_s" in s:
            span_device[s["name"]] = (span_device.get(s["name"], 0.0)
                                      + s["device_s"])
    out = {
        "engine": header.get("engine"),
        "contract_key": header.get("contract_key"),
        "version": header.get("version"),
        "mesh": header.get("mesh"),
        "scenario": header.get("scenario"),
        "rounds": len(rounds),
        "recorded_losses": len(losses),
        "first_loss": losses[0][1] if losses else None,
        "final_loss": (summary.get("final_loss")
                       if summary.get("final_loss") is not None
                       else (losses[-1][1] if losses else None)),
        "tau_star": summary.get("tau_star"),
        "tau_covered": summary.get("tau_covered"),
        "sim_total": summary.get("sim_total"),
        "comm_bytes_total": sum(cbytes) if cbytes else None,
        "comm_bytes_per_round": (sum(cbytes) / len(cbytes)
                                 if cbytes else None),
        "pod_bytes_total": sum(pbytes) if pbytes else None,
        "pod_bytes_per_round": (sum(pbytes) / len(pbytes)
                                if pbytes else None),
        "stale_max": max(stale) if stale else None,
        "stale_values": stale,
        "drift_count": len(by["drift"]),
        "drift": by["drift"],
        "span_totals": span_totals,
        "span_device_totals": span_device,
        "byte_budget": header.get("byte_budget"),
        "hlo": header.get("hlo"),
    }
    return out


_ROWS = (  # (label, key, format)
    ("engine", "engine", "{}"),
    ("contract key", "contract_key", "{}"),
    ("mesh", "mesh", "{}"),
    ("scenario", "scenario", "{}"),
    ("rounds", "rounds", "{}"),
    ("final loss", "final_loss", "{:.6g}"),
    ("tau*", "tau_star", "{}"),
    ("tau covered", "tau_covered", "{}"),
    ("sim clock [s]", "sim_total", "{:.4g}"),
    ("uplink bytes/round", "comm_bytes_per_round", "{:,.1f}"),
    ("uplink bytes total", "comm_bytes_total", "{:,.0f}"),
    ("pod bytes/round", "pod_bytes_per_round", "{:,.1f}"),
    ("pod bytes total", "pod_bytes_total", "{:,.0f}"),
    ("max staleness", "stale_max", "{}"),
    ("drift alarms", "drift_count", "{}"),
)


def _fmt(value, fmt: str) -> str:
    if value is None:
        return "-"
    if isinstance(value, dict):
        return json.dumps(value, sort_keys=True)
    return fmt.format(value)


def _fmt_md(value, fmt: str) -> str:
    return _fmt(value, fmt).replace("|", "\\|")


def render(records, *, target: float | None = None) -> str:
    """Terminal summary of one journal."""
    s = summarize(records)
    lines = ["run journal summary", "-" * 42]
    for label, key, fmt in _ROWS:
        lines.append(f"{label:<22}{_fmt(s[key], fmt)}")
    if target is not None:
        _, by = _split(records)
        t, sim = _time_to_target(by["round"], target)
        hit = (f"round {t}" + (f", sim {sim:.4g}s" if sim is not None
                               else "")) if t is not None else "not reached"
        lines.append(f"{f'target {target:g}':<22}{hit}")
    if s["stale_values"]:
        lines.append("staleness histogram")
        for label, n, bar in _histogram(s["stale_values"]):
            lines.append(f"  {label:>4}  {n:>5}  {bar}")
    if s["span_totals"]:
        lines.append("span breakdown [s]")
        for name, dur in sorted(s["span_totals"].items(),
                                key=lambda kv: -kv[1]):
            lines.append(f"  {name:<20}{dur:.4f}")
    if s["span_device_totals"]:
        lines.append("span device time [s]")
        for name, dur in sorted(s["span_device_totals"].items(),
                                key=lambda kv: -kv[1]):
            lines.append(f"  {name:<20}{dur:.6f}")
    for d in s["drift"]:
        lines.append(f"DRIFT {d.get('message', d)}")
    return "\n".join(lines)


def render_md(records, *, target: float | None = None) -> str:
    """Markdown summary of one journal."""
    s = summarize(records)
    lines = ["# Run journal summary", "",
             "| metric | value |", "| --- | --- |"]
    for label, key, fmt in _ROWS:
        lines.append(f"| {label} | {_fmt_md(s[key], fmt)} |")
    if target is not None:
        _, by = _split(records)
        t, sim = _time_to_target(by["round"], target)
        hit = (f"round {t}" + (f", sim {sim:.4g}s" if sim is not None
                               else "")) if t is not None else "not reached"
        lines.append(f"| target {target:g} | {hit} |")
    if s["span_totals"]:
        lines += ["", "## Span breakdown", "",
                  "| span | total [s] |", "| --- | --- |"]
        for name, dur in sorted(s["span_totals"].items(),
                                key=lambda kv: -kv[1]):
            lines.append(f"| {name} | {dur:.4f} |")
    if s["span_device_totals"]:
        lines += ["", "## Span device time", "",
                  "| span | device [s] |", "| --- | --- |"]
        for name, dur in sorted(s["span_device_totals"].items(),
                                key=lambda kv: -kv[1]):
            lines.append(f"| {name} | {dur:.6f} |")
    if s["drift"]:
        lines += ["", "## Drift alarms", ""]
        for d in s["drift"]:
            lines.append(f"- {d.get('message', d)}")
    return "\n".join(lines)


_DIFF_KEYS = ("engine", "contract_key", "rounds", "final_loss",
              "tau_star", "tau_covered", "sim_total",
              "comm_bytes_per_round", "comm_bytes_total",
              "pod_bytes_per_round", "pod_bytes_total", "stale_max",
              "drift_count")


def diff(a_records, b_records) -> dict:
    """A/B comparison of two journals -> {key: {a, b, ratio}} (ratio for
    numeric pairs with a nonzero base)."""
    a, b = summarize(a_records), summarize(b_records)
    out = {}
    for key in _DIFF_KEYS:
        va, vb = a[key], b[key]
        row = {"a": va, "b": vb}
        if (isinstance(va, (int, float)) and isinstance(vb, (int, float))
                and va):
            row["ratio"] = vb / va
        out[key] = row
    return out


def render_diff(a_records, b_records, *, md: bool = False) -> str:
    d = diff(a_records, b_records)
    fmts = {key: fmt for _, key, fmt in _ROWS}
    if md:
        lines = ["# Journal diff (A vs B)", "",
                 "| metric | A | B | B/A |", "| --- | --- | --- | --- |"]
        for key, row in d.items():
            r = f"{row['ratio']:.4g}" if "ratio" in row else "-"
            lines.append(
                f"| {key} | {_fmt_md(row['a'], fmts.get(key, '{}'))}"
                f" | {_fmt_md(row['b'], fmts.get(key, '{}'))}"
                f" | {r} |")
        return "\n".join(lines)
    lines = ["journal diff (A vs B)", "-" * 56]
    for key, row in d.items():
        r = f"  (B/A {row['ratio']:.4g})" if "ratio" in row else ""
        lines.append(f"{key:<24}{_fmt(row['a'], fmts.get(key, '{}')):>14}"
                     f" -> {_fmt(row['b'], fmts.get(key, '{}'))}{r}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render or diff RANL run journals.")
    p.add_argument("journal", nargs="?", help="journal JSONL path")
    p.add_argument("--md", action="store_true",
                   help="emit Markdown instead of terminal text")
    p.add_argument("--target", type=float, default=None,
                   help="loss target for time-to-target")
    p.add_argument("--validate", action="store_true",
                   help="schema-check only; exit 1 on problems")
    p.add_argument("--diff", nargs=2, metavar=("A", "B"), default=None,
                   help="diff two journals instead of rendering one")
    args = p.parse_args(argv)

    if args.diff is not None:
        a, b = (read_journal(path) for path in args.diff)
        problems = [f"{path}: {msg}" for path, recs in
                    zip(args.diff, (a, b))
                    for msg in validate_journal(recs)]
        if problems:
            for msg in problems:
                emit(msg, err=True)
            return 1
        emit(render_diff(a, b, md=args.md))
        return 0

    if args.journal is None:
        p.error("a journal path (or --diff A B) is required")
    records = read_journal(args.journal)
    problems = validate_journal(records)
    if args.validate:
        for msg in problems:
            emit(f"{args.journal}: {msg}", err=True)
        emit(f"{args.journal}: "
             + ("INVALID" if problems else
                f"valid (schema {records[0].get('schema')}, "
                f"{len(records)} records)"))
        return 1 if problems else 0
    if problems:
        for msg in problems:
            emit(f"{args.journal}: {msg}", err=True)
        return 1
    renderer = render_md if args.md else render
    emit(renderer(records, target=args.target))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
