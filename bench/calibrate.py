"""The readings the comparison's limits are set from, for one cell, on
the card, in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 3] [--faults half_batch,token_altered] [--fault-seeds 3] \
        [--out FILE]
    python3 bench/calibrate.py --workload <cell> --limits FILE [FILE ...] \
        --compare loss.1,curvature,... [--note TEXT]

For each seed: the program's set-up (round 0 and the first rounds, as a
run drives them) against the plain reference, the gaps as
``harness/check.py`` takes them.  For the first ``--control`` seeds also
the control: the reference with TF32 on, one precision step below the
configuration's float32, in the program's place.  For the first
``--fault-seeds`` seeds each named fault of ``harness/faults.py``
planted under the program.  Prints one JSON line a reading and writes
them all to ``--out``.  With ``--limits``, it needs no card: it sets the
cell's limits from such files (``derive``) and writes
``limits/<cell>.json``.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def free():
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def program_readings(cell, seed, device, fault=None):
    """The program's readings of ``seed`` (with ``fault`` planted), its
    state freed; returns (readings, feed, specs, arch, seconds)."""
    import run
    from contextlib import nullcontext
    from harness.faults import FAULTS
    t = time.perf_counter()
    with (FAULTS[fault]() if fault else nullcontext()):
        prog, fd, specs, arch, params, state, got, _ = run.setup(cell, seed,
                                                                 device)
    del prog, params, state
    free()
    return got, fd, specs, arch, time.perf_counter() - t


def _leaves(got, want):
    """Every leaf's gap of each norm, by its path (for a reading's
    ``"leaves"``)."""
    from harness import check
    return {n: {"/".join(map(str, k)): v for k, v in g.items()}
            for n, g in check.leaf_gaps(got, want).items() if n != "loss"}


def readings(cell, seeds, control: int, faults, fault_seeds: int, device,
             rank: int = 0):
    """Yields one dict a reading on rank 0: {"seed", "kind", "gaps",
    "s"}.  On a mesh every rank drives the program; rank 0 alone runs
    the reference and yields."""
    import run
    from harness import check
    for i, seed in enumerate(seeds):
        got, fd, specs, arch, secs = program_readings(cell, seed, device)
        bad = {f: program_readings(cell, seed, device, f)
               for f in (faults if i < fault_seeds else ())}
        if rank:
            continue
        t = time.perf_counter()
        want = run.reference_readings(arch, cell.config, cell.traffic,
                                      specs, fd, seed, device)
        ref_s = time.perf_counter() - t
        yield {"seed": seed, "kind": "program", "gaps": check.gaps(got, want),
               "s": secs, "reference_s": ref_s, "loss": got["loss"],
               "loss_ref": want["loss"], "leaves": _leaves(got, want)}
        if i < control:
            t = time.perf_counter()
            ctl = run.reference_readings(arch, cell.config, cell.traffic,
                                         specs, fd, seed, device, tf32=True)
            yield {"seed": seed, "kind": "control_tf32",
                   "gaps": check.gaps(ctl, want),
                   "s": time.perf_counter() - t,
                   "leaves": _leaves(ctl, want)}
        for fault, (b, _, _, _, secs) in bad.items():
            yield {"seed": seed, "kind": f"fault_{fault}",
                   "gaps": check.gaps(b, want), "s": secs}
        del fd, want
        free()


# a fault's reading counts as a number's upper reading from this many
# times its lower reading on (a state left unchanged: from 3 times, and
# it reads 1 on the change without a run); the control's from 3 times
UPPER_FROM = {"control_tf32": 3.0, "fault_unchanged": 3.0}
FAULT_UPPER_FROM = 10.0


def derive(readings, numbers=None):
    """{number: {"lower", "upper", "by", "limit"}} from a cell's
    readings: the lower reading is the largest of the program's seeds;
    the upper the smallest, over the control and each fault, of its
    smallest seed, where that is far enough above the lower; the limit
    lies between them at two thirds of the way up in logarithm (the more
    room above the lower), to two significant digits.  A number with no
    upper reading gets no limit."""
    kinds = sorted({r["kind"] for r in readings if r["kind"] != "program"})
    out = {}
    for name in numbers or dict.fromkeys(k for r in readings
                                         for k in r["gaps"]):
        # readings taken before a number was defined do not count for it
        have = [r for r in readings if name in r["gaps"]]
        lower = max(r["gaps"][name] for r in have if r["kind"] == "program")
        cands = {}
        for kind in kinds + ["fault_unchanged"]:
            vals = [r["gaps"][name] for r in have if r["kind"] == kind]
            if kind == "fault_unchanged" and not vals and name.startswith(
                    "change"):
                vals = [1.0]
            if not vals:
                continue
            low = min(vals)
            if low >= UPPER_FROM.get(kind, FAULT_UPPER_FROM) * lower:
                cands[kind] = low
        row = {"lower": lower}
        if cands:
            by = min(cands, key=cands.get)
            upper = cands[by]
            limit = lower ** (1 / 3) * upper ** (2 / 3) if lower else upper / 100
            row.update(upper=upper, by=by, limit=float(f"{limit:.2g}"))
        out[name] = row
    return out


def write_limits(cell, readings, chosen, note):
    """``limits/<cell>.json``: the compared numbers' limits, and every
    number's readings beside them."""
    d = derive(readings)
    for name in chosen:
        if "limit" not in d[name]:
            raise ValueError(f"{name} has no upper reading: no limit holds")
    path = cell.bench / "limits" / f"{cell.name}.json"
    path.write_text(json.dumps(
        {"limits": {k: d[k]["limit"] for k in chosen},
         "readings": d, "seeds": sorted({r["seed"] for r in readings
                                         if r["kind"] == "program"}),
         "note": note}, indent=1) + "\n")
    return d


def rank_readings(rank, world, cell, seeds, control, faults, fault_seeds,
                  device):
    """``readings`` on one rank of a cell on several chips."""
    import run
    run.set_caches()
    out = []
    for r in readings(cell, seeds, control, faults, fault_seeds, device,
                      rank):
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds",
                    help="comma-separated seeds of the program's readings")
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="half_batch,token_altered")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--limits", type=Path, nargs="+",
                    help="readings files to set the limits from (no card)")
    ap.add_argument("--compare", help="comma-separated numbers compared")
    ap.add_argument("--note", default="")
    args = ap.parse_args(argv)
    import run
    from harness.cell import Cell
    if args.limits:
        readings = [r for path in args.limits
                    for r in json.loads(path.read_text())["readings"]]
        d = write_limits(Cell.resolve(args.workload), readings,
                         args.compare.split(","), args.note)
        print(json.dumps(d, indent=1))
        return 0
    if not args.seeds:
        ap.error("--seeds is needed to take readings")
    run.set_caches()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    if cell.chips > 1:
        from harness import ranks
        out = ranks.launch(rank_readings, cell.chips, args.device, cell,
                           seeds, args.control, faults, args.fault_seeds,
                           args.device)
    else:
        out = rank_readings(0, 1, cell, seeds, args.control, faults,
                            args.fault_seeds, args.device)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"workload": cell.name,
                                        "readings": out}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
