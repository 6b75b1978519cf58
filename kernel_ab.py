#!/usr/bin/env python3
"""Time one of the port's kernels on one card in several checkouts, in
turns.

    python3 kernel_ab.py --kernel NAME [--seeds B] TREE [TREE ...]

NAME is one of flash_attention, rwkv_wkv, region_aggregate, ranl_update,
flash_attention_bwd, rwkv_wkv_bwd.
``--seeds B`` times the aggregation kernels in their seed-batched form,
(B, N, D) at each shape, as the batch engine launches them (a tree whose
kernel has no seed axis fails its check).
Each TREE is a directory that holds a checkout of this repository, e.g.
the parent commit unpacked with ``git archive`` into a git-ignored
directory.  The trees run first to last and then last to first, each run
in a fresh process that builds that tree's kernels (into the tree's own
``build/``), holds the kernel against its plain version at the first
shape (the tolerances of ``chip_smoke.py``), and times it at every shape
as ``chip_smoke.py`` does: a CUDA-graph replay of back-to-back calls over
input sets that do not fit in L2, beside the bound and, for
flash_attention, ``scaled_dot_product_attention`` on the same inputs;
the aggregation kernels also get one call with the host's launch
(``call_ms``).  Shapes per kernel (``SHAPES``):

- flash_attention, causal bf16 (B, S, H, KV, hd): phi4-mini's prefill
  (4, 1024, 24, 8, 128), a long sequence (1, 4096, 24, 8, 128), hd 64
  (2, 1024, 16, 4, 64);
- rwkv_wkv, bf16 r/k/v/u (B, S, H, hd): rwkv6-3b's prefill
  (4, 1024, 40, 64) and decode (4, 1, 40, 64), few heads (1, 1024, 4, 64);
- region_aggregate (N, D): the dense path's (32, 8192) and (32, 2²²);
- ranl_update (N, D): the diag path's (32, 4096) and (32, 2²²);
- flash_attention_bwd, rwkv_wkv_bwd: the backward kernels at the train
  shapes, phi4-mini's (2, 512, 24, 8, 128) and rwkv6-3b's (2, 512, 40,
  64), in f32 (the train path's type) and bf16, beside the plain backward
  and, for flash_attention_bwd, the backward of
  ``scaled_dot_product_attention`` through autograd (``chip_smoke.py``'s
  train_grad timings).

Prints the card's name and power limit, then one line per (run, shape).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = {
    "flash_attention": ((4, 1024, 24, 8, 128), (1, 4096, 24, 8, 128),
                        (2, 1024, 16, 4, 64)),
    "rwkv_wkv": ((4, 1024, 40, 64), (4, 1, 40, 64), (1, 1024, 4, 64)),
    "region_aggregate": ((32, 8192), (32, 1 << 22)),
    "ranl_update": ((32, 4096), (32, 1 << 22)),
    "flash_attention_bwd": (((2, 512, 24, 8, 128), "float32"),
                            ((2, 512, 24, 8, 128), "bfloat16")),
    "rwkv_wkv_bwd": (((2, 512, 40, 64), "float32"),
                     ((2, 512, 40, 64), "bfloat16")),
}
RUN_TIMEOUT_S = 300


def _sets(C, nbytes, make):
    return [make() for _ in range(max(2, -(-2 * C.L2_BYTES // nbytes)))]


def time_attention(C, torch, tree, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    for i, shape in enumerate(SHAPES["flash_attention"]):
        nb, fl, peak = C.attn_bound(*shape, 0, "bfloat16")
        sets = _sets(C, nb, lambda: C.attn_inputs(torch, *shape,
                                                  torch.bfloat16, gen))
        if i == 0:
            got = flash_attention(*sets[0])
            want = ref.flash_attention_ref(*sets[0])
            if not torch.allclose(got.float(), want.float(), rtol=2e-2,
                                  atol=2e-2):
                raise AssertionError(f"{tree}: flash_attention differs from "
                                     f"its plain version at {shape}")
        lib_ms, _ = C.library_attention_ms(torch, sets)
        ms = C.device_ms(torch, lambda q, k, v: flash_attention(q, k, v),
                         sets)
        bound = C.bound_row(nb, fl, peak)["bound_ms"]
        print(f"{tree} {shape}: {ms:.5f} ms ({fl / ms * 1e-9:.1f} TFLOP/s; "
              f"bound {bound:.5f} ms); scaled_dot_product_attention "
              f"{lib_ms:.5f} ms ({fl / lib_ms * 1e-9:.1f} TFLOP/s)",
              flush=True)
        del sets
        torch.cuda.empty_cache()


def time_wkv(C, torch, tree, gen):
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv
    for i, shape in enumerate(SHAPES["rwkv_wkv"]):
        nb, fl, peak = C.wkv_bound(*shape, "bfloat16")
        sets = _sets(C, nb, lambda: C.wkv_inputs(torch, *shape,
                                                 torch.bfloat16, gen, True))
        if i == 0:
            y, sf = rwkv_wkv(*sets[0])
            y_ref, sf_ref = ref.rwkv_wkv_ref(*sets[0])
            if not (torch.allclose(y, y_ref, rtol=2e-4, atol=2e-4)
                    and torch.allclose(sf, sf_ref, rtol=2e-4, atol=2e-4)):
                raise AssertionError(f"{tree}: rwkv_wkv differs from its "
                                     f"plain version at {shape}")
        ms = C.device_ms(torch, rwkv_wkv, sets)
        b = C.bound_row(nb, fl, peak)
        print(f"{tree} {shape}: {ms:.5f} ms (bound {b['bound_ms']:.5f} ms "
              f"by {b['bound_by']})", flush=True)
        del sets
        torch.cuda.empty_cache()


def time_aggregate(C, torch, tree, gen, name, seeds=None):
    kern, plain = C.calls(name)
    flush = torch.empty(2 * C.L2_BYTES, dtype=torch.uint8, device="cuda")
    lead = () if seeds is None else (seeds,)
    for i, (n, d) in enumerate(SHAPES[name]):
        nb = C.kernel_bytes(name, n, d, *lead)
        sets = [C.make_inputs(torch, n, d, "random", gen, *lead)
                for _ in range(min(64, -(-2 * C.L2_BYTES // nb)))]
        if i == 0:
            got, want = kern(*sets[0]), plain(*sets[0])
            if not (torch.equal(got[1], want[1]) and torch.allclose(
                    got[0], want[0], rtol=1e-5, atol=1e-6)):
                raise AssertionError(f"{tree}: {name} differs from its "
                                     f"plain version at {lead + (n, d)}")
        ms = C.device_ms(torch, kern, sets)
        one = C.call_ms(torch, kern, sets[0], flush)
        print(f"{tree} {lead + (n, d)}: {ms:.5f} ms, one call {one:.5f} ms "
              f"(bound {nb / C.HBM_BYTES_PER_S * 1e3:.5f} ms by bytes)",
              flush=True)
        del sets
        torch.cuda.empty_cache()


def time_backward(C, torch, tree, gen, name):
    """A backward kernel at each shape: checked against its plain version
    (``chip_smoke.bwd_against_plain``: the tolerances of its train_grad
    phase, one launch a call, two calls bit-equal), then timed beside the
    plain backward and (K3) the library's backward."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_wkv as wkv
    kernel = name[:-len("_bwd")]
    fn, plain = ((fa.flash_attention_bwd, ref.flash_attention_bwd_ref)
                 if kernel == "flash_attention" else
                 (wkv.rwkv_wkv_bwd, ref.rwkv_wkv_bwd_ref))
    for shape, dt in SHAPES[name]:
        dtype = getattr(torch, dt)
        tol = 2e-4 if dt == "float32" else (
            2e-2 if kernel == "flash_attention" else C.BF16_STEP)
        C.bwd_against_plain(torch, kernel, shape, dtype, gen, tol)
        nb, fl, peak = (C.attn_bwd_bound(*shape, 0, dt)
                        if kernel == "flash_attention"
                        else C.wkv_bwd_bound(*shape, dt))
        sets = _sets(C, nb, lambda: C.grad_inputs(torch, kernel, shape,
                                                  dtype, gen))
        ms = C.device_ms(torch, fn, sets)
        plain_ms = C.device_ms(torch, plain, sets[:2])
        lib = (f"; scaled_dot_product_attention backward "
               f"{C.library_attention_bwd_ms(torch, sets):.5f} ms"
               if kernel == "flash_attention" else "")
        b = C.bound_row(nb, fl, peak)
        print(f"{tree} {shape} {dt}: {ms:.5f} ms (bound {b['bound_ms']:.5f}"
              f" ms by {b['bound_by']}); plain {plain_ms:.5f} ms{lib}",
              flush=True)
        del sets
        torch.cuda.empty_cache()


def run_one(kernel: str, tree: str, seeds=None):
    """Build, check and time the kernel of one tree (in this process)."""
    import chip_smoke as C            # timing helpers of this checkout
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    os.environ["TRITON_CACHE_DIR"] = os.path.join(os.path.abspath(tree),
                                                  "build", "triton")
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    if kernel == "flash_attention":
        time_attention(C, torch, tree, gen)
    elif kernel == "rwkv_wkv":
        time_wkv(C, torch, tree, gen)
    elif kernel.endswith("_bwd"):
        time_backward(C, torch, tree, gen, kernel)
    else:
        time_aggregate(C, torch, tree, gen, kernel, seeds)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True, choices=sorted(SHAPES))
    ap.add_argument("--seeds", type=int, default=None,
                    help="time region_aggregate/ranl_update over this many "
                         "seeds in one launch")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    if args.seeds is not None and args.kernel not in ("region_aggregate",
                                                      "ranl_update"):
        ap.error("--seeds applies to region_aggregate and ranl_update")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    failed = 0
    for tree in args.trees + args.trees[::-1]:
        try:
            r = subprocess.run([sys.executable, __file__, "--one",
                                args.kernel, tree]
                               + ([] if args.seeds is None
                                  else [str(args.seeds)]),
                               capture_output=True, text=True,
                               timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            print(f"{tree}: ran past {RUN_TIMEOUT_S} s", flush=True)
            failed += 1
            continue
        print(r.stdout, end="", flush=True)
        if r.returncode != 0:
            print(f"{tree}: failed (exit {r.returncode})\n{r.stderr[-3000:]}",
                  flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        sys.path.insert(0, HERE)
        run_one(sys.argv[2], sys.argv[3],
                int(sys.argv[4]) if len(sys.argv) > 4 else None)
    else:
        sys.exit(main(sys.argv[1:]))
