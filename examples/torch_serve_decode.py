"""Batched serving on the PyTorch port: prefill a batch of prompts, then
greedy-decode with the KV-cache / recurrent-state serve path, for one
arch per family (the CUDA card; ``--device cpu`` runs on the host).

  PYTHONPATH=src python examples/torch_serve_decode.py
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import run  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="default: the CUDA card; 'cpu' runs on the host")
args = ap.parse_args()
device = [] if args.device is None else ["--device", args.device]

for arch in ("phi4-mini-3.8b",      # dense, GQA KV cache
             "rwkv6-3b",            # attention-free, O(1) state
             "hymba-1.5b",          # hybrid: SWA cache + SSM state
             "musicgen-medium"):    # audio: 4-codebook decoding
    print(f"\n=== {arch} ===")
    run(["--arch", arch, "--batch", "4", "--prompt-len", "32",
         "--gen", "12"] + device)
