#!/usr/bin/env python3
"""Time K3 (the port's flash_attention kernel) on one card in several
checkouts, in turns.

    python3 attn_ab.py TREE [TREE ...]

Each TREE is a directory that holds a checkout of this repository, e.g.
the parent commit unpacked with ``git archive`` into a git-ignored
directory.  The trees run first to last and then last to first, each run
in a fresh process that builds that tree's library (into the tree's own
``build/``), holds it against the plain version at phi4-mini's prefill
shape (2e-2 in bf16, as ``chip_smoke.py``), and times it as
``chip_smoke.py`` does (a CUDA-graph replay of back-to-back calls over
input sets that do not fit in L2) beside ``scaled_dot_product_attention``
on the same inputs.  Shapes, all causal bf16 (B, S, H, KV, hd): phi4-mini's
prefill (4, 1024, 24, 8, 128), a long sequence (1, 4096, 24, 8, 128) and
hd 64 (2, 1024, 16, 4, 64).  Prints the card's name and power limit, then
one line per (run, shape).  Needs a CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((4, 1024, 24, 8, 128), (1, 4096, 24, 8, 128), (2, 1024, 16, 4, 64))
RUN_TIMEOUT_S = 300


def run_one(tree: str):
    """Build, check and time the kernel of one tree (in this process)."""
    import chip_smoke as C            # timing helpers of this checkout
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        nb, fl, _ = C.attn_bound(*shape, 0, "bfloat16")
        sets = [C.attn_inputs(torch, *shape, torch.bfloat16, gen)
                for _ in range(max(2, -(-2 * C.L2_BYTES // nb)))]
        if shape == SHAPES[0]:
            got = flash_attention(*sets[0])
            want = ref.flash_attention_ref(*sets[0])
            if not torch.allclose(got.float(), want.float(), rtol=2e-2,
                                  atol=2e-2):
                raise AssertionError(f"{tree}: flash_attention differs from "
                                     f"its plain version at {shape}")
        lib_ms, _ = C.library_attention_ms(torch, sets)
        ms = C.device_ms(torch, lambda q, k, v: flash_attention(q, k, v),
                         sets)
        print(f"{tree} {shape}: {ms:.5f} ms ({fl / ms * 1e-9:.1f} TFLOP/s); "
              f"scaled_dot_product_attention {lib_ms:.5f} ms "
              f"({fl / lib_ms * 1e-9:.1f} TFLOP/s)", flush=True)
        del sets
        torch.cuda.empty_cache()


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    failed = 0
    for tree in list(trees) + list(reversed(trees)):
        try:
            r = subprocess.run([sys.executable, __file__, "--one", tree],
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
        run_one(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
