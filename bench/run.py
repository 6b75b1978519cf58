"""Runs one cell of the benchmark once and prints one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``src/repro_torch``)
and a CUDA card for each chip the cell asks for.  The cell is an entry
of ``BENCHMARK.json``; its configuration, traffic, limits and metric
readers are files under ``bench/`` found by name (``harness/cell.py``).

A run makes the weights and the traffic from the seed on the card, runs
the program's round 0 (``init_state``) and its first rounds, reading
from that same training object what the comparison needs, then either
measures ``--seconds`` of back-to-back rounds (``--trace 0``: the cell's
end-to-end metrics) or runs a few rounds with layer spans and a few
under the profiler (``--trace 1``: its per-layer metrics).  After the
window it frees the program's state and runs the plain reference from
the same weights, batches and masks (``harness/check.py``).  A cell on
several chips runs one process a card (``harness/ranks.py``) on the
program's mesh path; rank 0 prints the line.  Without enough cards it
prints nothing and exits 2.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
OUT = ROOT / "build" / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SPANNED = ("train_step", "per_worker_grads", "aggregate", "newton_step")
SPAN_ROUNDS = 3
PROFILED_ROUNDS = 3

if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def set_caches():
    """Every build and kernel cache at a fixed directory of the checkout
    (the port's nvcc libraries already go to ``build/kernels``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(ROOT / "build" / sub)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the port's own name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _sum_ranks(tree):
    """Each tensor of ``tree`` summed over the ranks, in place."""
    import torch.distributed as dist
    for t in tree.values():
        dist.all_reduce(t)
    return tree


def drive(prog, fd, weights, steps, device):
    """Round 0 and rounds 1..``steps`` of one training object, with the
    readings the comparison takes from it; ``weights()`` makes the
    starting weights (again, for the change, so no copy is held through
    the rounds).  Returns (params, state, readings, seconds of the last
    round, synchronised)."""
    import torch
    from reference import ranl as ref
    params = ref.unflatten(weights())
    state = prog.init_state(params, fd.batch(0))
    got = {"loss": [], "curvature": ref.norms(ref.flatten(state["precond"]))}
    for t in range(1, steps + 1):
        _sync(device)
        start = time.perf_counter()
        params, state, m = prog.step(params, state, fd.batch(t), fd.mask(t))
        got["loss"].append(float(m["loss"]))
        _sync(device)
        last_s = time.perf_counter() - start
        if t == 1:
            g = ref.grad_from_memory(ref.flatten(state["memory"]), fd.mask(1),
                                     prog.workers)
            got["grad"] = ref.norms(_sum_ranks(g) if prog.on_mesh else g)
            del g
    flat, flat0 = ref.flatten(params), weights()
    got["change"] = {p: float(torch.linalg.vector_norm(flat[p] - flat0[p]))
                     for p in flat0}
    del flat, flat0
    return params, state, got, last_s


def reference_readings(arch, cfg, traffic, specs, fd, seed, device,
                       tf32=False):
    """The plain reference's readings from the same weights (made again
    from the seed), batches and masks."""
    from harness import feed
    from reference import ranl as ref
    steps = traffic["check_steps"]
    with ref.precision(tf32):
        return ref.run(arch, cfg, feed.make_weights(specs, seed, device),
                       [fd.batch(t) for t in range(steps + 1)],
                       fd.masks[:steps], traffic["ranl"], steps)


def inputs(cell, seed, device):
    """What the benchmark makes for ``cell`` and ``seed`` besides the
    weights: (the reference architecture, its parameter specs, the
    feed of batches and masks).  Every rank makes the same."""
    from harness import feed
    from reference import load
    cfg = cell.config
    arch = load(cfg["reference"])
    specs = arch.param_specs(cfg)
    regions = cfg["num_layers"] + sum(1 for p, _, _ in specs
                                      if p[0] != "layers")
    return arch, specs, feed.Feed(cell.traffic, cfg["vocab_size"], regions,
                                  seed, device)


def setup(cell, seed, device):
    """The program's training object for ``cell`` and ``seed``, driven
    through its first rounds: (program, feed, specs, arch, params,
    state, readings, seconds of the last of those rounds)."""
    import torch
    from harness import feed, port
    arch, specs, fd = inputs(cell, seed, device)
    prog = port.Program(cell.config, cell.traffic,
                        torch.device(device).type)
    params, state, got, last_s = drive(
        prog, fd, lambda: feed.make_weights(specs, seed, device),
        cell.traffic["check_steps"], device)
    return prog, fd, specs, arch, params, state, got, last_s


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t0: float = T0, out: Path = OUT, rank: int = 0,
             world: int = 1):
    """One run of ``cell`` (on this rank of ``world``): the result line
    as a dict on rank 0, None on the others.  ``t0``: the run's start,
    by ``time.time()``."""
    import torch
    from harness import check, spans, trace
    from harness.cell import reader
    entered = time.time()
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    dist = None
    if world > 1:
        import torch.distributed as dist

    prog, fd, specs, arch, params, state, got, last_s = setup(cell, seed,
                                                              device)
    built = time.time()
    traffic = cell.traffic
    r = traffic["check_steps"] + 1
    losses = []

    def rounds(n):
        nonlocal params, state, r
        for _ in range(n):
            params, state, m = prog.step(params, state, fd.batch(r),
                                         fd.mask(r))
            losses.append(m["loss"])
            r += 1

    run = SimpleNamespace(cell=cell, cfg=cell.config, traffic=traffic,
                          arch=arch, specs=specs, chips=cell.chips,
                          device=device,
                          tokens_per_round=traffic["batch"] * traffic["seq"],
                          spans=None, span_rounds=0, trace=None,
                          profiled_rounds=0)
    if world > 1:
        # every rank runs as many rounds: rank 0's last check round sets
        # how many fill the window
        n = [max(1, round(seconds / last_s))]
        dist.broadcast_object_list(n, src=0)
        dist.barrier()
    _sync(device)
    run.setup_s = time.time() - t0
    if rank == 0:
        print(f"set-up {run.setup_s!r} s: start to the run "
              f"{entered - t0!r} s, weights, round 0 and the first rounds "
              f"{built - entered!r} s, the rest {time.time() - built!r} s",
              file=sys.stderr)
    if not traced:
        start = time.perf_counter()
        if world > 1:
            rounds(n[0])
        else:
            while True:
                rounds(1)
                if time.perf_counter() - start >= seconds:
                    break
        _sync(device)
        if world > 1:
            dist.barrier()
        run.window_s = time.perf_counter() - start
    else:
        # the span rounds give the layers' times; the spans are on again
        # in the profiler's host pass, where they name what the host did
        # in idle gaps
        sp = spans.Spans(device)
        with sp.around(prog.ranl, SPANNED):
            rounds(SPAN_ROUNDS)
            run.spans, run.span_rounds = sp.ms(), SPAN_ROUNDS
        run.trace = trace.record(
            rounds, PROFILED_ROUNDS, device,
            out / f"{cell.name}.{seed}.rank{rank}.trace.json",
            prog.launches, lambda: sp.around(prog.ranl, SPANNED))
        run.profiled_rounds = PROFILED_ROUNDS
        t = run.trace
        if rank == 0:
            print(f"{PROFILED_ROUNDS} rounds unprofiled "
                  f"{t['plain_window_s']!r} s; profiler's device pass "
                  f"{t['window_s']!r} s, busy {t['busy_s']!r} s; host pass "
                  f"{t['host_window_s']!r} s, busy {t['host_busy_s']!r} s",
                  file=sys.stderr)
        if world > 1:
            every = [None] * world
            dist.all_gather_object(every, run.trace)
            for k in ("busy_s", "window_s", "plain_window_s"):
                # averaged over the chips
                run.trace[k] = sum(t[k] for t in every) / world
    run.rounds = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = torch.tensor(float(torch.cuda.max_memory_allocated() if cuda
                              else 0), device=device)
    if world > 1:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)   # the fullest card
        if rank == 0:
            print(f"collectives of round {r - 1}: " + "; ".join(
                f"{c.op} over {c.dim}, {c.dtype}, {c.nbytes} bytes"
                for c in prog.coll.log if c.round == r - 1),
                file=sys.stderr)
    run.peak_bytes = int(peak.item())
    del params, state, prog, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return None

    want = reference_readings(arch, cell.config, traffic, specs, fd, seed,
                              device)
    correct, checks = check.judge(check.gaps(got, want), cell.limits)

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"], cell.bench).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
    result = {"correct": correct, "attempted": run.rounds, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        result["breakdown"] = trace.breakdown(run.trace)
    result["checks"] = checks
    return result


def emit(result) -> int:
    """Print the line, its checks last on standard error; refuse when
    this process has loaded JAX or the JAX package."""
    leaked = forbidden_modules()
    if leaked:
        print(f"the run loaded {leaked}: the benchmark may not load JAX or "
              f"the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def rank_main(rank, world, cell, seed, seconds, traced, device, t0,
              fault=None):
    """One rank of a cell on several chips (``harness.ranks.launch``):
    rank 0 prints the line.  ``fault`` plants one of
    ``harness.faults`` (tests only).  Returns rank 0's result."""
    from contextlib import nullcontext
    from harness.faults import FAULTS
    set_caches()
    with (FAULTS[fault]() if fault else nullcontext()):
        result = run_cell(cell, seed, seconds, traced, device, t0,
                          rank=rank, world=world)
    if rank == 0 and emit(result):
        raise SystemExit(3)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.cell import Cell
    cell = Cell.resolve(args.workload)
    set_caches()
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {have}", file=sys.stderr)
        return 2
    if cell.chips > 1:
        from harness import ranks
        ranks.launch(rank_main, cell.chips, "cuda", cell, args.seed,
                     args.seconds, bool(args.trace), "cuda", T0)
        return 0
    return emit(run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda"))


if __name__ == "__main__":
    sys.exit(main())
