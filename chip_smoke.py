#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written Triton kernels from the sources under
``src/repro_torch/kernels/``, holds each against its plain PyTorch version
on the card and times both, then drives the port's main path through
``repro_torch.run`` at full width:

1. device: the card's name and power limit (``nvidia-smi``);
2. kernels against their plain versions at (N, D) = (32, 2²²+37),
   (7, 513), (1, 1) and the main path's shapes, with random, all-false
   and all-true masks (C′ bit-equal; ḡ and x′ within rtol 1e-5, atol
   1e-6 — the N-sum runs in another order); times at the main path's
   shapes and at (32, 2²²);
3. dense main path: quadratic, N=32, d=8192, κ=1e3, 64 regions, 30
   rounds (dist² must fall by 1e-6 — the condition-independent rate of
   homogeneous workers), held against the same run on the plain path;
4. diag main path: logistic, N=32, 4096 samples per worker, d=4096, 30
   rounds through the fused ``ranl_update`` kernel, held against the same
   run on the plain path (``use_kernel=False``) on the card;
5. scan engine against the reference engine on the card (N=16, d=1024),
   and the card against the CPU at a small size.

Launch counts are set to 0 just before each main-path run and read just
after.  A kernel's ``ms`` is its time on the card: a CUDA graph of
back-to-back calls, replayed, over enough input sets that they do not
stay in L2.  ``call_ms`` is one call as a caller sees it, host launch
included.  Kernels compile into ``build/triton/`` beside this script.  TF32 is switched off for matmuls and cuDNN, so every product runs
in full float32.  Prints the kernels' JSON line, then, last,
``{"ok": true, "device": {...}}``; exits non-zero, with no result line,
when there is no CUDA device, the package is missing, or any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published HBM3 rate
L2_BYTES = 50 << 20              # H100 L2
TIMED_CALLS = 20
KERNEL_SOURCE = "src/repro_torch/kernels/region_aggregate.py"
REPLACES = {"region_aggregate": "src/repro/kernels/region_aggregate.py:75",
            "ranl_update": "src/repro/kernels/region_aggregate.py:138"}
# main-path shapes (N, D) each kernel sees: dense rounds (K1), diag (K2)
MAIN_SHAPE = {"region_aggregate": (32, 8192), "ranl_update": (32, 4096)}
LARGE_SHAPE = (32, 1 << 22)


def log(msg):
    print(msg, flush=True)


def kernel_bytes(name, n, d):
    """HBM bytes of one call: G, M (1 byte), C read once, C′ written once,
    plus ḡ written (K1) or x, h read and x′ written (K2)."""
    per_worker = 4 + 1 + 4 + 4
    return (per_worker * n + (4 if name == "region_aggregate" else 12)) * d


def make_inputs(torch, n, d, mask_kind, gen):
    dev = "cuda"
    if mask_kind == "random":
        m = torch.rand(n, d, device=dev, generator=gen) < 0.5
    else:
        m = torch.full((n, d), mask_kind == "all_true", dtype=torch.bool,
                       device=dev)
    g = torch.randn(n, d, device=dev, generator=gen) * m
    c = torch.randn(n, d, device=dev, generator=gen)
    x = torch.randn(d, device=dev, generator=gen)
    h = torch.rand(d, device=dev, generator=gen) + 0.05
    return g, m, c, x, h


def calls(name):
    from repro_torch.kernels import ref
    from repro_torch.kernels import region_aggregate as K
    mu, lr = 0.1, 1.0
    if name == "region_aggregate":
        return (lambda g, m, c, x, h: K.region_aggregate(g, m, c),
                lambda g, m, c, x, h: ref.region_aggregate_ref(g, m, c))
    return (lambda g, m, c, x, h: K.ranl_update(x, h, g, m, c, mu=mu, lr=lr),
            lambda g, m, c, x, h: ref.ranl_update_ref(x, h, g, m, c, mu=mu,
                                                      lr=lr))


def event_ms(torch, fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def call_ms(torch, fn, args, flush):
    """Median of single-call CUDA-event times, the host's launch included;
    the L2 is flushed before each call."""
    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(TIMED_CALLS):
        flush.zero_()
        times.append(event_ms(torch, lambda: fn(*args)))
    return statistics.median(times)


def device_ms(torch, fn, arg_sets):
    """Time on the card of one call: a CUDA graph of back-to-back calls,
    cycling through ``arg_sets`` (each set is out of L2 when its turn
    comes), replayed ``TIMED_CALLS`` times; the median replay over the
    calls in it."""
    calls_per_replay = max(len(arg_sets), 4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls_per_replay):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    times = [event_ms(torch, graph.replay) / calls_per_replay
             for _ in range(TIMED_CALLS)]
    del graph
    return statistics.median(times)


def phase_kernels(torch, report):
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    for name in ("region_aggregate", "ranl_update"):
        kern, _ = calls(name)
        kern(*make_inputs(torch, 2, 3, "random", gen))
    torch.cuda.synchronize()
    log(f"kernel build + first launch: {time.time() - t0:.2f} s")

    for name in ("region_aggregate", "ranl_update"):
        kern, plain = calls(name)
        worst = 0.0
        for n, d in ((32, (1 << 22) + 37), (7, 513), (1, 1),
                     MAIN_SHAPE[name]):
            for mk in ("random", "all_false", "all_true"):
                args = make_inputs(torch, n, d, mk, gen)
                out_k, out_p = kern(*args), plain(*args)
                torch.cuda.synchronize()
                if not torch.equal(out_k[1], out_p[1]):
                    raise AssertionError(f"{name} {n}x{d} {mk}: C' differs")
                if not torch.allclose(out_k[0], out_p[0], rtol=1e-5,
                                      atol=1e-6):
                    raise AssertionError(f"{name} {n}x{d} {mk}: first "
                                         f"output beyond rtol 1e-5")
                err = (out_k[0] - out_p[0]).abs().max().item()
                worst = max(worst, err)
        report[name] = {"max_abs_err": worst}
        log(f"{name}: matches its plain version (C' bit-equal, "
            f"max |err| {worst:.3e})")

    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    for name in ("region_aggregate", "ranl_update"):
        kern, plain = calls(name)
        for label, (n, d) in (("", MAIN_SHAPE[name]), ("_large", LARGE_SHAPE)):
            nbytes = kernel_bytes(name, n, d)
            sets = [make_inputs(torch, n, d, "random", gen)
                    for _ in range(min(64, -(-2 * L2_BYTES // nbytes)))]
            row = {f"ms{label}": device_ms(torch, kern, sets),
                   f"plain_ms{label}": device_ms(torch, plain, sets),
                   f"call_ms{label}": call_ms(torch, kern, sets[0], flush),
                   f"plain_call_ms{label}": call_ms(torch, plain, sets[0],
                                                    flush),
                   f"bound_ms{label}": nbytes / HBM_BYTES_PER_S * 1e3,
                   f"shape{label}": [n, d]}
            report[name].update(row)
            log(f"{name} at {n}x{d}: on the card {row[f'ms{label}']:.5f} ms "
                f"(plain {row[f'plain_ms{label}']:.5f} ms) over {len(sets)} "
                f"input sets; one call {row[f'call_ms{label}']:.5f} ms "
                f"(plain {row[f'plain_call_ms{label}']:.5f} ms); bound "
                f"{row[f'bound_ms{label}']:.5f} ms = {nbytes} B at 3.35 TB/s")
            del sets
            torch.cuda.empty_cache()


def sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def init_seconds(torch, run_init):
    """Seconds of a warm ``num_rounds=0`` run: the first one pays the
    process's one-time costs (library handles, first-use setup), so it
    runs once untimed."""
    run_init()
    return sync_time(torch, run_init)[1]


def check_finite(torch, res):
    for f in ("xs", "dist_sq", "losses", "coverage", "round_time"):
        if not torch.isfinite(getattr(res, f).float()).all():
            raise AssertionError(f"non-finite {f}")


def main_path_run(torch, rt, problem, key, launches, **opts):
    """One counted run of the main path through repro_torch.run; returns
    (result, seconds, launches of this run)."""
    from repro_torch.kernels import region_aggregate as K
    K.reset_launches()
    res, secs = sync_time(torch, lambda: rt.run(problem, key, **opts))
    counts = dict(K.LAUNCHES)
    for name, v in counts.items():
        launches[name] += v
    return res, secs, counts


def same_run(torch, res, plain, label, atol):
    """Hold a kernel run against the same run on the plain path: integer
    traces equal, xs within rtol 1e-4 and ``atol`` (ḡ sums the N rows in
    another order, and the step carries that rounding on).  Returns the
    largest |xs − plain xs|."""
    for f in ("coverage", "comm_floats", "max_stale", "round_time",
              "comm_bytes"):
        if not torch.equal(getattr(res, f), getattr(plain, f)):
            raise AssertionError(f"{label} kernel vs plain: {f} differs")
    if (res.tau_star, res.tau_covered) != (plain.tau_star, plain.tau_covered):
        raise AssertionError(f"{label} kernel vs plain: tau differs")
    err = (res.xs - plain.xs).abs().max().item()
    if not torch.allclose(res.xs, plain.xs, rtol=1e-4, atol=atol):
        raise AssertionError(f"{label} kernel vs plain: xs max |err| {err}")
    return err


def phase_dense(torch, rt, report, launches):
    from repro_torch import prng
    T = 30
    problem, build_s = sync_time(torch, lambda: rt.make_quadratic(
        prng.PRNGKey(0), num_workers=32, dim=8192, kappa=1e3, coupling=0.0,
        num_regions=64, device="cuda"))
    log(f"dense: make_quadratic N=32 d=8192 built in {build_s:.2f} s "
        f"(A is {problem.A.numel() * 4 / 1e9:.2f} GB)")
    pol = rt.PolicyConfig(keep_prob=0.5, tau_star=1)
    init_s = init_seconds(torch, lambda: rt.run(
        problem, prng.PRNGKey(1), num_rounds=0, num_regions=64, policy=pol))
    res, total_s, counts = main_path_run(
        torch, rt, problem, prng.PRNGKey(1), launches, num_rounds=T,
        num_regions=64, policy=pol)
    check_finite(torch, res)
    if res.tau_star < 1:
        raise AssertionError(f"tau_star {res.tau_star} < 1")
    d0, dT = float(res.dist_sq[0]), float(res.dist_sq[-1])
    if not dT <= 1e-6 * d0:
        raise AssertionError(f"dist_sq fell only from {d0:.3e} to {dT:.3e}")
    if counts != {"region_aggregate": T, "ranl_update": 0}:
        raise AssertionError(f"dense path launches {counts}")
    xs_err = same_run(torch, res, rt.run(
        problem, prng.PRNGKey(1), use_kernel=False, num_rounds=T,
        num_regions=64, policy=pol), "dense", atol=1e-5)
    per_round_ms = (total_s - init_s) / T * 1e3
    report["dense"] = {"init_s": init_s, "round_ms": per_round_ms,
                       "total_s": total_s, "dist_sq_0": d0,
                       "dist_sq_T": dT, "tau_star": res.tau_star,
                       "xs_vs_plain_max_abs": xs_err, "launches": counts}
    log(f"dense: init {init_s:.2f} s, {per_round_ms:.3f} ms/round, "
        f"dist_sq {d0:.4e} -> {dT:.4e}, tau_star {res.tau_star}; kernel vs "
        f"plain xs max |err| {xs_err:.3e}; launches {counts}")
    del problem, res
    torch.cuda.empty_cache()


def phase_diag(torch, rt, report, launches):
    from repro_torch import prng
    T = 30
    problem, build_s = sync_time(torch, lambda: rt.make_logistic(
        prng.PRNGKey(0), num_workers=32, per_worker=4096, dim=4096,
        device="cuda"))
    log(f"diag: make_logistic N=32 n=4096 d=4096 built in {build_s:.2f} s "
        f"(X is {problem.X.numel() * 4 / 1e9:.2f} GB)")
    opts = dict(curvature="diag", num_rounds=T, num_regions=64)
    init_s = init_seconds(torch, lambda: rt.run(
        problem, prng.PRNGKey(1), curvature="diag", num_rounds=0,
        num_regions=64))
    res, total_s, counts = main_path_run(torch, rt, problem, prng.PRNGKey(1),
                                         launches, **opts)
    check_finite(torch, res)
    if counts != {"region_aggregate": 0, "ranl_update": T}:
        raise AssertionError(f"diag path launches {counts}")
    l0, l1, lT = (float(res.losses[i]) for i in (0, 1, -1))
    if not lT < l0:
        raise AssertionError(f"loss did not fall below x0's: {l0} -> {lT}")
    xs_err = same_run(torch, res, rt.run(
        problem, prng.PRNGKey(1), use_kernel=False, **opts), "diag",
        atol=1e-6)
    per_round_ms = (total_s - init_s) / T * 1e3
    report["diag"] = {"init_s": init_s, "round_ms": per_round_ms,
                      "total_s": total_s, "loss_0": l0, "loss_1": l1,
                      "loss_T": lT, "loss_star": float(problem.loss(
                          problem.x_star)),
                      "xs_vs_plain_max_abs": xs_err, "launches": counts}
    log(f"diag: init {init_s:.2f} s, {per_round_ms:.3f} ms/round, loss "
        f"{l0:.5f} -> {l1:.5f} (x1) -> {lT:.5f} (x_T), loss(x*) "
        f"{report['diag']['loss_star']:.5f}; kernel vs plain xs max |err| "
        f"{xs_err:.3e}; launches {counts}")
    del problem, res
    torch.cuda.empty_cache()


def phase_engines(torch, rt, report):
    from repro_torch import prng
    from repro_torch.kernels import region_aggregate as K
    T = 20
    problem = rt.make_quadratic(prng.PRNGKey(2), num_workers=16, dim=1024,
                                kappa=100.0, coupling=0.0, num_regions=16,
                                grad_noise=0.1, device="cuda")
    opts = dict(num_rounds=T, num_regions=16,
                policy=rt.PolicyConfig(keep_prob=0.5, tau_star=1))
    K.reset_launches()
    scan = rt.run(problem, prng.PRNGKey(3), **opts)
    torch.cuda.synchronize()
    if K.LAUNCHES["region_aggregate"] != T:
        raise AssertionError(f"scan engine K1 launches {K.LAUNCHES}")
    ref = rt.run(problem, prng.PRNGKey(3), engine="reference", **opts)
    for f in ("coverage", "comm_floats", "max_stale", "round_time"):
        if not torch.equal(getattr(scan, f), getattr(ref, f)):
            raise AssertionError(f"scan vs reference: {f} differs")
    if (scan.tau_star, scan.tau_covered) != (ref.tau_star, ref.tau_covered):
        raise AssertionError("scan vs reference: tau differs")
    scan_err = (scan.xs - ref.xs).abs().max().item()
    if not scan_err <= 1e-5:
        raise AssertionError(f"scan vs reference xs max |err| {scan_err}")

    # the card against the host, on identical arrays
    small = rt.make_quadratic(prng.PRNGKey(4), num_workers=8, dim=64,
                              kappa=50.0, coupling=0.0, num_regions=8,
                              grad_noise=0.1, device="cpu")
    on_card = dataclasses.replace(small, A=small.A.cuda(), b=small.b.cuda(),
                                  x_star=small.x_star.cuda())
    errs = {}
    for curv in ("dense", "diag"):
        kw = dict(num_rounds=10, num_regions=8, curvature=curv)
        host = rt.run(small, prng.PRNGKey(5), device="cpu", **kw)
        card = rt.run(on_card, prng.PRNGKey(5), **kw)
        for f in ("coverage", "comm_floats", "max_stale", "round_time"):
            if not torch.equal(getattr(host, f), getattr(card, f).cpu()):
                raise AssertionError(f"card vs host ({curv}): {f} differs")
        errs[curv] = (host.xs - card.xs.cpu()).abs().max().item()
        if not errs[curv] <= 1e-4:
            raise AssertionError(f"card vs host ({curv}) xs max |err| "
                                 f"{errs[curv]}")
    report["engines"] = {"scan_vs_reference_xs_max_abs": scan_err,
                         "card_vs_host_xs_max_abs": errs}
    log(f"engines: scan vs reference on the card, integer traces equal, "
        f"xs max |err| {scan_err:.3e}; card vs host xs max |err| {errs}")


def kernels_line(report, launches):
    rows = []
    for name in ("region_aggregate", "ranl_update"):
        r = report[name]
        rows.append({"name": name, "route": "triton",
                     "source": KERNEL_SOURCE, "replaces": REPLACES[name],
                     "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "bytes", "library_ms": None,
                     "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
                     "shape": r["shape"], "ms_large": r["ms_large"],
                     "plain_ms_large": r["plain_ms_large"],
                     "call_ms_large": r["call_ms_large"],
                     "bound_ms_large": r["bound_ms_large"],
                     "shape_large": r["shape_large"]})
    return json.dumps({"kernels": rows})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import repro_torch as rt
    except ImportError as e:
        print(f"chip_smoke: the port is missing ({e})", file=sys.stderr)
        return 2
    os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "build", "triton")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN: products run in full float32")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
        else f"nvidia-smi failed: {smi.stderr.strip()}")

    report = {}
    launches = {"region_aggregate": 0, "ranl_update": 0}
    failed = []
    t_all = time.time()
    for label, fn in (("kernels", lambda: phase_kernels(torch, report)),
                      ("dense", lambda: phase_dense(torch, rt, report,
                                                    launches)),
                      ("diag", lambda: phase_diag(torch, rt, report,
                                                  launches)),
                      ("engines", lambda: phase_engines(torch, rt, report))):
        t0 = time.time()
        try:
            fn()
            log(f"phase {label}: ok ({time.time() - t0:.1f} s)")
        except Exception:   # report every phase, then fail the run
            failed.append(label)
            traceback.print_exc()
            log(f"phase {label}: FAILED ({time.time() - t0:.1f} s)")
    log(f"total {time.time() - t_all:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    for name in launches:
        if launches[name] < 1:
            print(f"chip_smoke: {name} never launched on the main path",
                  file=sys.stderr)
            return 1
    log(json.dumps({k: v for k, v in report.items()
                    if k in ("dense", "diag", "engines")}))
    log(kernels_line(report, launches))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
