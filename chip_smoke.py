#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --consistent-seeds 2,3,4,5,6

The second form only logs serve_consistent's full-depth gaps (phase 9)
at those seeds, with the kernels and with their plain twins, one JSON
line each, and exits: the readings ``FULL_DEPTH_RATIO`` is set from.
The first:
Builds the hand-written kernels from the sources in the checkout (the
Triton K1/K2 under ``src/repro_torch/kernels/``, the CUDA C++ K3/K4 and
chol_update under ``src/repro_torch/csrc/``), holds each against its plain PyTorch version on
the card and times both, then drives the port's paths at full width:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` on each CUDA source, all started together, into
   ``build/kernels/`` (registers and spills from ``-Xptxas -v``), and the
   count of tensor-core (HGMMA) and TMA-load (UTMALDG) instructions in the
   flash_attention library (``cuobjdump -sass``, where the toolkit has it);
3. kernels (K1/K2) against their plain versions at (N, D) = (32, 2²²+37),
   (7, 513), (1, 1) and the main path's shapes, with random, all-false
   and all-true masks (C′ bit-equal; ḡ and x′ within rtol 1e-5, atol
   1e-6 — the N-sum runs in another order), at the hierarchy phase's
   pod rows (``POD_ROW_SHAPES``), and K2 on an offset d-slice at
   ``SLICE_SHAPE`` (the 2-D engine's); times at the main path's shapes,
   at (32, 2²²) and K2's at the slice;
4. kernels (K3/K4) against their plain twins: flash attention at
   phi4-mini's prefill (4, 1024, 24, 8, 128) in bf16, at a ragged S, at
   a ragged S below one tile, with a window, at hd 64 in bf16 and in f32
   and with one kv head, each with the body its (dtype, hd) routes to
   (bf16 at hd 64/128: the tensor-core body; f32: the SIMT body); the
   wkv recurrence at rwkv6-3b's prefill (4, 1024, 40, 64), its decode
   (4, 1, 40, 64), a ragged (1, 37, 3, 64), a T over many chunks and not
   a multiple of one (2, 300, 40, 64), B * H = 1 at hd 128 and a strided
   r, from a non-zero state; a 1024-step prefill and 31 decode steps
   against one run over the 1055 steps, bit for bit; K4's launch geometry
   and its registers and spills (``-Xptxas -v``) go into its row.
   Tolerances are those of tests/test_kernels.py (2e-4 f32, 2e-2 bf16 for
   K3; 2e-4 for K4): the sums run in another order.  Times at the serve
   shapes, beside the bound, K3's achieved TFLOP/s and
   ``scaled_dot_product_attention``'s time;
5. dense main path: quadratic, N=32, d=8192, κ=1e3, 64 regions, 30
   rounds (dist² must fall by 1e-6 — the condition-independent rate of
   homogeneous workers), held against the same run on the plain path;
6. diag main path: logistic, N=32, 4096 samples per worker, d=4096, 30
   rounds through the fused ``ranl_update`` kernel, held against the same
   run on the plain path (``use_kernel=False``) on the card;
   obs (right after it, on the same problem): the run with ``journal=``
   under ``obs.tracing()`` and without either, two of each in turns: xs
   and every trace bit-equal, 30 K2 launches each; the journal valid, no
   drift record, its ``execute`` span's ``device_s`` (CUDA events) > 0;
   ``python -m repro_torch.obs.report`` renders it; ``torch_profiler``
   over a 3-round run logs the five device operations that took the most
   time and the CPU operator chains that launched them; journal-on and
   journal-off round times beside the card's name and power limit;
7. scan engine against the reference engine on the card (N=16, d=1024),
   and the card against the CPU at a small size;
8. serve_rwkv / serve_dense: ``repro_torch.launch.serve.generate`` on
   rwkv6-3b and phi4-mini-3.8b at full width and depth in bf16 (random
   weights from a seed), batch 4, a 1024-token bigram prompt, 32 new
   tokens: prefill seconds and warm decode ms per token; K4 must launch
   32 × (1 + 31) times, K3 32 times;
9. serve_consistent: both configs at full width in f32, teacher-forced
   prefill (192 tokens) then decode to 256 against the full forward: cut
   to 2 layers within 2e-3 (prefill) and 3e-3 (decode), as
   tests/test_models.py; at full depth, where random weights amplify
   cuBLAS's row-count-dependent rounding past those bounds, within
   ``FULL_DEPTH_RATIO`` times the gaps of the kernels' plain twins on the
   same weights (see ``phase_serve_consistent``);
10. models_card_vs_host: rwkv6-3b, phi4-mini-3.8b, hymba-1.5b (2560
   tokens, past its 2048 window), phi3.5-moe-42b-a6.6b, llava-next-
   mistral-7b (576 projected patches, then 128 tokens) and musicgen-medium
   at full width cut to 2 layers, batch 1, 128 tokens unless said, f32:
   logits (and the MoE aux loss) on the card (kernels) against the CPU
   (plain twins), within 1e-3 (f32 sums in another order over 1600–14336-
   wide products and up to 2560 recurrence or scan steps);
11. batch_dense / batch_diag: ``engine="batch"`` over 8 seeds on the dense
   and diag main paths (30 rounds): one seed-batched K1 or K2 launch a
   round (30 in all), each row's integer traces equal to a scan run of
   its seed on the card and its xs within ``BATCH_XS_RTOL`` x max |x|;
   ms per round and per round and seed beside the single seed's and the
   A or X read floor (2.56 / 0.64 ms at 3.35 TB/s);
12. options: on the scan engine at the main paths' sizes, dense with
   ``compression="int8"``, dense with ``quorum=0.75, max_delay=2`` on
   ``pareto-stragglers``, diag with ``compression="topk:8"`` and the
   ``"resource"`` controller on ``churn-stragglers``, diag with the
   ``"staleness-bounded"`` controller on ``dropout``: finite, converging
   (see ``phase_options``), integer traces, comm_bytes and round_time
   equal to a host run of the same problem and key, x¹ within
   ``INIT_XS_TOL`` of it and x² … x^T within the CPU tests' tolerances;
   ms per round;
13. hierarchy: pod-of-pods rounds at the main paths' sizes, dense
   ``pods=2,period=5`` on ``geo-distributed:pods=2`` (K1 at (2, 16,
   8192)) and diag ``pods=4,period=3,gamma=0.5,compression=int8`` on
   ``edge-cohort:pods=4`` (K2 at (4, 8, 4096)): one launch a round (30),
   integer traces, pod_bytes and round_time equal to a host run of the
   same problem and key, x¹ within ``INIT_XS_TOL`` and x² … x^T of
   xs_pods within the CPU tests' tolerances; ms per round beside the
   flat run of the same problem and cost; then ``engine="batch"`` over 8
   seeds of the diag run, one K2 launch a round at (32, 8, 4096), each
   row equal to the scan run of its key;
14. lowrank_init: the chol_update kernel against the plain loop on the
   card (one worker's rank-4 fold at d = 8192, the whole factor at
   d = 512, within ``CHOL_RTOL`` x max |L|) and their times; the chain
   alone (``chol_update.chain``: the dependent path of one column, 8192
   times, in one thread) beside the byte bound, and the kernel's ratio to
   each; one call as the init's split times it (host clock between two
   synchronisations) beside the clone of L it makes; the init of
   ``hessian_rank=4`` on the dense main-path problem (N = 32, d = 8192),
   31 launches, its seconds split between eigh and the kernel; and
   ``hessian_rank=4`` at N = 32, d = 512, card against host;
15. train_grad: the backward kernels of K3 and K4 against their plain
   versions (``ref.flash_attention_bwd_ref``, ``ref.rwkv_wkv_bwd_ref``)
   at the serve prefill shapes (4, 1024, 24, 8, 128) and (4, 1024, 40,
   64) and the train shapes (2, 512, 24, 8, 128) and (2, 512, 40, 64),
   each in f32 (within 2e-4) and bf16 (2e-2 for K3, one bf16 step,
   ``BF16_STEP``, for K4's bf16 gradients), x (max |grad| + |grad|): one
   launch a call, and two calls on the same inputs bit-equal; each timed
   alone at the train shape in f32 (its row's numbers) and at the prefill
   shape in bf16, beside its plain version, its bound and (K3) the
   backward of ``scaled_dot_product_attention`` through autograd; and
   gradients of a scalar loss through ``ops.flash_attention`` /
   ``ops.rwkv_wkv`` at the train shapes (the kernel forward and the
   backward kernel, one launch of each) against autograd through the
   plain forwards; K4's backward also with its launch geometry
   (``wkv_bwd_geometry``), its registers and spills (``-Xptxas -v``) and
   K4's forward timed on the same inputs;
16. sharded: the 1-D sharded engine on ``torch.distributed`` (run after
   hierarchy).  (a) NCCL at world size 1 in this process: the dense and
   diag main paths, diag with ``overlap=True`` and dense with
   ``compression="int8"`` on ``engine="sharded"`` with a ``("data",)``
   mesh, each against the scan run of the same problem and key (integer
   traces, comm_bytes and round_time equal, x¹ bit-equal, x² … x^T
   within 2e-5 x max |x|, 5e-2 for int8; overlap bit-equal to the
   sequential run; no kernel launched), and ``engine="batch"`` over 8
   seeds with the mesh against the unsharded batch; (b) two ranks on
   the one card over gloo (``torch.multiprocessing`` spawn): diag on
   ``("data",) = 2`` and diag ``pods=2,period=3,gamma=0.5,
   compression=int8`` on ``("pod", "data") = (2, 1)``, each against the
   scan run within 2e-5 (5e-2 under the int8 exchange).  Every run's collective log passes the
   engine's contract (``repro_torch.analysis``); ms per round beside
   the scan run's;
17. sharded2d: the 2-D engine (``engine="sharded2d"``, workers over
   "data", the parameter dimension over "model").  (a) NCCL at world size
   1 in this process on ("data", "model") = (1, 1): the dense main path
   (the init fully on panels: Newton–Schulz over one 268 MB panel, the
   blocked factor, the first step), dense int8, diag (K2 on the slice,
   here all of d: 30 launches) and diag ``overlap=True``, each against
   the scan run of the same problem and key (``projection="ns"`` for
   dense): integer traces equal, x¹ within ``SHARDED2D_X1_TOL`` (dense;
   bit-equal for diag), x² … x^T within 2e-5 x max |x| (5e-2 int8),
   overlap bit-equal; the dense init's seconds split into its parts;
   (b) two ranks on the card over gloo: diag on (1, 2) (K2 at (32, 2048)
   on each rank's slice, 30 launches a rank), diag on (2, 1) (no kernel,
   the data all-reduce) and dense at d = 2048 on (1, 2).  Every log
   within the ``sharded2d`` contract; the dense runs' largest tensor
   (``analysis.LargestTensors``) within one (d/n_model, d) panel, beside
   ``torch.cuda.max_memory_allocated``; ms per round and init seconds
   beside the scan run's.

18. train_dense / train_rwkv: RANL (``repro_torch.optim``) on phi4-mini-
   3.8b and rwkv6-3b at full width cut to 2 layers, f32, N = 4 workers,
   global batch 8, seq 512, the train CLI's ``RanlLLMConfig``:
   ``init_state`` then 5 ``train_step``s.  K3 (K4) and its backward
   kernel launch 4 x 2 x 6 = 48 times each, the masked aggregate once a
   leaf a step; each round, run again from the same inputs through the
   plain versions (forward, backward and aggregate), launches none and
   is held to the kernels' round: masks
   (coverage, uplink) equal, loss, params and precond within
   ``TRAIN_TOL`` (1e-3 for K3, 1e-2 for K4).  init seconds, step seconds
   split into the per-worker forwards and backwards, the aggregate and
   the Newton step, tokens a second, peak memory, and the kernel at the
   train shape in f32 against its bound (K3 also against
   ``scaled_dot_product_attention``);
19. train_adamw: the AdamW baseline at train_dense's size, 3 steps on the
   full batch, against the twins' run (K3 and its backward 6 launches
   each);
20. train_cli: ``repro_torch.launch.train.run`` with --smoke on the card:
   RANL under pareto-stragglers with the resource controller and a 0.75
   quorum, then AdamW with --checkpoint-dir build/ckpt, restored bit-
   equal to the trained params; both with --journal and --trace: the
   journals valid, an ``execute`` span a step timed on the card, the
   ``checkpoint`` span, rendered by the report CLI;
21. examples: ``examples/torch_quickstart.py`` on the card, exit 0;
22. train_sharded (run after train_cli, before examples): RANL with
   ``mesh=`` (``optim.ranl_llm``).  (a) NCCL at world size 1 in this
   process on ("data", "model") = (1, 1): train_dense's setup,
   ``init_state`` then 3 ``train_step``s, K3 and its backward launched
   4 x 2 x 4 = 32 times each; each step (and the init) held to the
   unsharded step from the same inputs on the card: coverage and uplink
   equal, loss, params and
   precond within ``TRAIN_TOL``; the collective log within
   ``analysis.train_contract``; s a step beside the unsharded step's
   and train_dense's, peak memory beside the unsharded step's.  (b) two
   gloo ranks on the card (spawn) on ("data",) = 2 and ("data",
   "model") = (1, 2): phi4-mini at full width cut to 1 layer, N = 4,
   batch 4 x 256, 2 steps, each held to the unsharded run of the same
   init_state and steps; each rank's persistent RANL state bytes and
   ``max_memory_allocated`` beside the unsharded run's (at most
   ``HALF_STATE`` of it at (1, 2)); and the train CLI with ``--smoke
   --data-shards 2`` on the two ranks, its final line within
   ``TRAIN_TOL`` of the one-rank CLI run's.

masked_aggregate (run after the kernels phase): the deep-net aggregate's
kernel against its plain version on the card at phi4-mini's head at N = 4
(4, 200064 x 3072), rwkv6-3b's embedding at N = 12 (12, 65536 x 2560)
and small leaves (N = 1, rows not a multiple of 8), in bf16 and f32
memory, with all, some, one and no workers trained: C' and g bit-equal;
then timed at the two cells' shapes beside the (8N + 4) P byte bound and
the plain version's time.

grouped_matmul (run after masked_aggregate): the expert layer's grouped
f32 product and its two backward products (``grouped_matmul_bwd``: dx
and dw) against their plain versions on the card at the AFMoE cell's
shapes, 32768 rows of which 8192 are routed over 32 experts, (d, width)
= (2048, 1024) and (1024, 2048), with even groups, skewed groups and
one empty group: within ``GMM_RTOL`` of the largest entry, rows outside
every group exactly 0, and the plain version with TF32 on outside that
tolerance.  Then timed at the gate's shape beside the f32 operations'
bound, the plain per-group loop and ``torch._grouped_mm`` (the
yardstick); last, one main-path run of the cell's expert layer, forward
and backward, whose launches it counts.

K1 and K2 are also held against their plain versions at the batch
engine's (8, 32, 8192) and (8, 32, 4096), a ragged (3, 7, 513) and B = 1,
and their row's ``ms``/``bound_ms`` are those batched shapes'.

Launch counts are set to 0 just before each main-path run and read just
after.  A kernel's ``ms`` is its time on the card: a CUDA graph of
back-to-back calls, replayed, over enough input sets that they do not
stay in L2.  ``call_ms`` is one call as a caller sees it, host launch
included.  Triton kernels compile into ``build/triton/`` beside this
script.  TF32 is switched off for matmuls and cuDNN, so every f32 product
runs in full float32.  Prints the kernels' JSON line, then, last,
``{"ok": true, "device": {...}}``; exits non-zero, with no result line,
when there is no CUDA device, the package is missing, or any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM published HBM3 rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
L2_BYTES = 50 << 20              # H100 L2
TIMED_CALLS = 20
KERNELS = ("region_aggregate", "ranl_update", "flash_attention", "rwkv_wkv",
           "chol_update", "flash_attention_bwd", "rwkv_wkv_bwd",
           "masked_aggregate", "grouped_matmul", "grouped_matmul_bwd")
ZERO = {name: 0 for name in KERNELS}
SOURCES = {"region_aggregate": "src/repro_torch/kernels/region_aggregate.py",
           "ranl_update": "src/repro_torch/kernels/region_aggregate.py",
           "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
           "rwkv_wkv": "src/repro_torch/csrc/rwkv_wkv.cu",
           "chol_update": "src/repro_torch/csrc/chol_update.cu",
           "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "rwkv_wkv_bwd": "src/repro_torch/csrc/rwkv_wkv_bwd.cu",
           "masked_aggregate": "src/repro_torch/csrc/masked_aggregate.cu",
           "grouped_matmul": "src/repro_torch/csrc/grouped_matmul.cu",
           "grouped_matmul_bwd": "src/repro_torch/csrc/grouped_matmul.cu"}
ROUTES = {"region_aggregate": "triton", "ranl_update": "triton",
          "flash_attention": "cuda", "rwkv_wkv": "cuda",
          "chol_update": "cuda", "flash_attention_bwd": "cuda",
          "rwkv_wkv_bwd": "cuda", "masked_aggregate": "cuda",
          "grouped_matmul": "cuda", "grouped_matmul_bwd": "cuda"}
# chol_update ports no Pallas kernel: it replaces the reference's rank-1
# sweep, a compiled lax.scan.  No Pallas kernel has a backward: the two
# backward kernels replace XLA's autodiff of the reference's attention
# and checkpointed wkv scan.  masked_aggregate ports none either: the
# reference's deep-net aggregate is plain jnp.  Nor does grouped_matmul:
# the reference's MoE multiplies a capacity buffer by einsum.
REPLACES = {"region_aggregate": "src/repro/kernels/region_aggregate.py:75",
            "ranl_update": "src/repro/kernels/region_aggregate.py:138",
            "flash_attention": "src/repro/kernels/flash_attention.py:77",
            "rwkv_wkv": "src/repro/kernels/rwkv_wkv.py:57",
            "chol_update": "src/repro/core/compression.py:303",
            "flash_attention_bwd": "src/repro/models/attention.py:50",
            "rwkv_wkv_bwd": "src/repro/models/rwkv.py:65",
            "masked_aggregate": "src/repro/optim/ranl_llm.py:162",
            "grouped_matmul": "src/repro/models/moe.py:75",
            "grouped_matmul_bwd": "src/repro/models/moe.py:75"}
# main-path shapes (N, D) each kernel sees: dense rounds (K1), diag (K2)
MAIN_SHAPE = {"region_aggregate": (32, 8192), "ranl_update": (32, 4096)}
SEEDS = 8                       # the batch engine's seeds (batch_* phases)
# the seed-batched shapes (B, N, D) of the batch engine's rounds
BATCH_SHAPE = {name: (SEEDS,) + shape for name, shape in MAIN_SHAPE.items()}
LARGE_SHAPE = (32, 1 << 22)
# the pod rows (B·P, N/P, D) the hierarchy phase's runs give K1/K2: dense
# pods=2, diag pods=4, and the diag run over SEEDS seeds
POD_ROW_SHAPES = ((2, 16, 8192), (4, 8, 4096), (SEEDS * 4, 8, 4096))
# the masked aggregate's timed leaves (N, P): phi4-mini n4's tied head and
# rwkv6-3b n12's embedding
MASKED_SHAPES = {"phi4_head_n4": (4, 200064 * 3072),
                 "rwkv6_embed_n12": (12, 65536 * 2560)}
# the grouped product at the AFMoE cell: (rows, routed rows, experts held)
# and the two (K, N) of its products, gate/up and down
GMM_ROWS = (32768, 8192, 32)
GMM_SHAPES = ((2048, 1024), (1024, 2048))
# the grouped product against its plain version, x the largest entry: the
# same f32 sums in another order; TF32's 10-bit products miss it by far
GMM_RTOL = 1e-5
# K2 on a model shard's d-slice (the 2-D engine on two model ranks): x and
# hdiag are the second half of (2·D,) vectors, G, M, C (N, D) of their own
SLICE_SHAPE = (32, 2048)
# batch row b against a scan run of seed b on the card: xs within this
# times max |x| (the B-column oracle product rounds apart from one column)
BATCH_XS_RTOL = 1e-4
# x¹ of an options run, card against host, x max |x|: the init step
# (eigh, projection and Cholesky of the d = 8192 Hessian, κ = 1e3, in
# f32) is the same code in every run, options or none, and two linear-
# algebra libraries round it apart by up to about κ·2⁻²³·8 ≈ 1e-3; the
# rounds after it, where the options act, contract that gap.
INIT_XS_TOL = 1e-3
LOWRANK = dict(num_workers=32, dim=512, rank=4)   # lowrank_init's card-vs-host cut
# chol_update against the plain loop on the card, x max |L|: the same IEEE
# operations in the same order per element; what the two round apart (if
# anything) grows along the chain of d columns
CHOL_RTOL = 1e-5
# a bf16 rounding step (8 significant bits): train_grad's tolerance on
# K4's bf16 gradients, x (max |grad| + |grad|), which holds two values
# one step apart
BF16_STEP = 2.0 ** -8
# train_grad's shapes: (B, S, H, KV, hd) for K3, (B, S, H, hd) for K4
GRAD_SHAPES = {"flash_attention": {"prefill": (4, 1024, 24, 8, 128),
                                   "train": (2, 512, 24, 8, 128)},
               "rwkv_wkv": {"prefill": (4, 1024, 40, 64),
                            "train": (2, 512, 40, 64)}}
# the hierarchy phase's runs: (label, problem kind, hierarchy, scenario,
# x² … x^T tolerance x max |x| against the host run: the CPU tests', 2e-5
# for synchronous uncompressed pods, 5e-2 under the int8 exchange)
HIER_RUNS = (("dense", "dense", "pods=2,period=5", "geo-distributed:pods=2",
              2e-5),
             ("diag", "diag", "pods=4,period=3,gamma=0.5,compression=int8",
              "edge-cohort:pods=4", 5e-2))
CONSISTENT_LAYERS = 2           # depth of serve_consistent's tight check
CONSISTENT_TOL = (2e-3, 3e-3)   # its prefill and decode bounds
# serve_consistent at full depth: the kernels' gap to the full forward at
# most this times the plain twins' on the same weights (readings at seeds
# 2-6 in PERF.md section 6)
FULL_DEPTH_RATIO = 4.0
HELD = {}        # a problem one phase builds and a later phase reuses


def log(msg):
    print(msg, flush=True)


def kernel_bytes(name, n, d, b=1):
    """HBM bytes of one call over b seeds: G, M (1 byte), C read once, C′
    written once, plus ḡ written (K1) or x, h read and x′ written (K2)."""
    per_worker = 4 + 1 + 4 + 4
    return (per_worker * n + (4 if name == "region_aggregate" else 12)) * d * b


def make_inputs(torch, n, d, mask_kind, gen, b=None):
    """Random G, M, C (n, d) and x, h (d,), or (b, n, d) and (b, d)."""
    dev = "cuda"
    lead = () if b is None else (b,)
    if mask_kind == "random":
        m = torch.rand(*lead, n, d, device=dev, generator=gen) < 0.5
    else:
        m = torch.full(lead + (n, d), mask_kind == "all_true",
                       dtype=torch.bool, device=dev)
    g = torch.randn(*lead, n, d, device=dev, generator=gen) * m
    c = torch.randn(*lead, n, d, device=dev, generator=gen)
    x = torch.randn(*lead, d, device=dev, generator=gen)
    h = torch.rand(*lead, d, device=dev, generator=gen) + 0.05
    return g, m, c, x, h


def slice_inputs(torch, n, d, mask_kind, gen):
    """``make_inputs`` at (n, d) with x and h the second halves of (2d,)
    vectors: a model shard's d-slice, at an offset."""
    g, m, c, _, _ = make_inputs(torch, n, d, mask_kind, gen)
    x = torch.randn(2 * d, device="cuda", generator=gen)[d:]
    h = (torch.rand(2 * d, device="cuda", generator=gen) + 0.05)[d:]
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
        for shape in ((32, (1 << 22) + 37), (7, 513), (1, 1),
                      MAIN_SHAPE[name], BATCH_SHAPE[name], (3, 7, 513),
                      (1,) + MAIN_SHAPE[name]) + POD_ROW_SHAPES:
            *b, n, d = shape
            for mk in ("random", "all_false", "all_true"):
                args = make_inputs(torch, n, d, mk, gen, *b)
                out_k, out_p = kern(*args), plain(*args)
                torch.cuda.synchronize()
                if not torch.equal(out_k[1], out_p[1]):
                    raise AssertionError(f"{name} {shape} {mk}: C' differs")
                if not torch.allclose(out_k[0], out_p[0], rtol=1e-5,
                                      atol=1e-6):
                    raise AssertionError(f"{name} {shape} {mk}: first "
                                         f"output beyond rtol 1e-5")
                err = (out_k[0] - out_p[0]).abs().max().item()
                worst = max(worst, err)
        if name == "ranl_update":
            n, d = SLICE_SHAPE
            for mk in ("random", "all_false", "all_true"):
                args = slice_inputs(torch, n, d, mk, gen)
                out_k, out_p = kern(*args), plain(*args)
                torch.cuda.synchronize()
                if not (torch.equal(out_k[1], out_p[1]) and torch.allclose(
                        out_k[0], out_p[0], rtol=1e-5, atol=1e-6)):
                    raise AssertionError(f"{name} on an offset slice "
                                         f"{SLICE_SHAPE} {mk} differs")
                worst = max(worst, (out_k[0] - out_p[0]).abs().max().item())
        report[name] = {"max_abs_err": worst}
        log(f"{name}: matches its plain version (C' bit-equal, "
            f"max |err| {worst:.3e}), seed-batched and pod-row shapes "
            f"included" + (f", and {SLICE_SHAPE} on an offset d-slice"
                           if name == "ranl_update" else ""))

    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    for name in ("region_aggregate", "ranl_update"):
        kern, plain = calls(name)
        timed = [("_batch", BATCH_SHAPE[name]), ("_single", MAIN_SHAPE[name]),
                 ("_large", LARGE_SHAPE)]
        if name == "ranl_update":
            timed.append(("_slice", SLICE_SHAPE))
        for label, shape in timed:
            *b, n, d = shape
            nbytes = kernel_bytes(name, n, d, *b)
            sets = [(slice_inputs(torch, n, d, "random", gen)
                     if label == "_slice" else
                     make_inputs(torch, n, d, "random", gen, *b))
                    for _ in range(min(64, -(-2 * L2_BYTES // nbytes)))]
            row = {f"ms{label}": device_ms(torch, kern, sets),
                   f"plain_ms{label}": device_ms(torch, plain, sets),
                   f"call_ms{label}": call_ms(torch, kern, sets[0], flush),
                   f"plain_call_ms{label}": call_ms(torch, plain, sets[0],
                                                    flush),
                   f"bound_ms{label}": nbytes / HBM_BYTES_PER_S * 1e3,
                   f"shape{label}": list(shape)}
            report[name].update(row)
            log(f"{name} at {shape}: on the card {row[f'ms{label}']:.5f} ms "
                f"(plain {row[f'plain_ms{label}']:.5f} ms) over {len(sets)} "
                f"input sets; one call {row[f'call_ms{label}']:.5f} ms "
                f"(plain {row[f'plain_call_ms{label}']:.5f} ms); bound "
                f"{row[f'bound_ms{label}']:.5f} ms = {nbytes} B at 3.35 TB/s")
            del sets
            torch.cuda.empty_cache()
        # the row's contract numbers are the batch engine's shape
        for key in ("ms", "plain_ms", "bound_ms", "shape"):
            report[name][key] = report[name][f"{key}_batch"]


def masked_inputs(torch, n, p, kind, memory, gen):
    """G (n, p) f32, a mask (n,) of ``kind`` (all / some / one / none
    trained) and a memory (n, p) in ``memory``, on the card."""
    G = torch.randn(n, p, device="cuda", generator=gen)
    C = torch.randn(n, p, device="cuda", generator=gen).to(memory)
    m = torch.zeros(n, dtype=torch.bool, device="cuda")
    if kind == "all":
        m[:] = True
    elif kind == "some":
        m[::2] = True
    elif kind == "one":
        m[n - 1] = True
    return G, m, C


def masked_bytes(n, p, memory_bytes):
    """The masked aggregate's bytes: G and C read, C' and g written."""
    return (4 + 2 * memory_bytes) * n * p + 4 * p


def phase_masked_aggregate(torch, report):
    """The deep-net aggregate's kernel against its plain version (C' and g
    bit-equal), then timed at the cells' leaves beside its byte bound and
    the plain version's time."""
    from repro_torch.kernels import masked_aggregate as MA
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    MA.masked_aggregate(*masked_inputs(torch, 2, 8, "all", torch.bfloat16,
                                       gen))
    torch.cuda.synchronize()
    log(f"masked_aggregate build + first launch: {time.time() - t0:.2f} s")
    checked = 0
    for (n, p) in ((*MASKED_SHAPES.values(),) + ((1, 4096), (12, 999),
                                                 (3, 1037), (4, 3072))):
        for memory in (torch.bfloat16, torch.float32):
            for kind in ("all", "some", "one", "none"):
                args = masked_inputs(torch, n, p, kind, memory, gen)
                got = MA.masked_aggregate(*args)
                want = ref.masked_aggregate_ref(*args)
                if not (torch.equal(got[1], want[1])
                        and torch.equal(got[0], want[0])):
                    raise AssertionError(f"masked_aggregate ({n}, {p}) "
                                         f"{memory} {kind}: differs from "
                                         f"its plain version")
                checked += 1
                del args, got, want
        torch.cuda.empty_cache()
    row = {"max_abs_err": 0.0, "checked": checked}
    log(f"masked_aggregate: C' and g bit-equal to the plain version in "
        f"{checked} cases (bf16 and f32 memory; all, some, one, no "
        f"workers trained)")
    for label, (n, p) in MASKED_SHAPES.items():
        args = masked_inputs(torch, n, p, "some", torch.bfloat16, gen)
        nbytes = masked_bytes(n, p, 2)
        ms = device_ms(torch, MA.masked_aggregate, [args])
        torch.cuda.empty_cache()
        plain_ms = device_ms(torch, ref.masked_aggregate_ref, [args])
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row[label] = {"shape": [n, p], "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bytes": nbytes}
        log(f"masked_aggregate at {label} (N, P) = ({n}, {p}) bf16 memory: "
            f"on the card {ms:.5f} ms ({bound / ms:.1%} of its bound "
            f"{bound:.5f} ms = {nbytes} B at 3.35 TB/s); plain {plain_ms:.5f}"
            f" ms")
        del args
        torch.cuda.empty_cache()
    head = row["phi4_head_n4"]
    row.update(ms=head["ms"], plain_ms=head["plain_ms"],
               bound_ms=head["bound_ms"], shape=head["shape"])
    report["masked_aggregate"] = row


def gmm_inputs(torch, K, N, groups, gen):
    """x (rows, K), w (experts, K, N), dy (rows, N) on the card and int32
    offsets of ``groups``: "even", "skewed" (one expert a fifth of the
    routed rows) or "empty" (even, expert 3 empty)."""
    rows, routed, E = GMM_ROWS
    share = torch.ones(E, device="cuda")
    if groups == "skewed":
        share = torch.rand(E, device="cuda", generator=gen)
        share[7] = share.sum() / 4
    elif groups == "empty":
        share[3] = 0
    sizes = (share / share.sum() * routed).long()
    offsets = torch.zeros(E + 1, dtype=torch.int32, device="cuda")
    offsets[1:] = torch.cumsum(sizes, 0)
    return (torch.randn(rows, K, device="cuda", generator=gen),
            torch.randn(E, K, N, device="cuda", generator=gen),
            torch.randn(rows, N, device="cuda", generator=gen), offsets)


def gmm_plain(torch, bounds):
    """The plain per-group loop at host ``bounds`` (no host read, so a
    CUDA graph can hold it): (forward, dx, dw)."""
    def fwd(x, w):
        y = x.new_zeros((x.shape[0], w.shape[2]))
        for g in range(w.shape[0]):
            if bounds[g + 1] > bounds[g]:
                y[bounds[g]:bounds[g + 1]] = x[bounds[g]:bounds[g + 1]] @ w[g]
        return y

    def wgrad(x, dy, groups):
        dw = x.new_zeros((groups, x.shape[1], dy.shape[1]))
        for g in range(groups):
            s, e = bounds[g], bounds[g + 1]
            if e > s:
                dw[g] = x[s:e].T @ dy[s:e]
        return dw
    return fwd, lambda dy, w: fwd(dy, w.transpose(1, 2)), wgrad


def gmm_ops(routed, K, N, E):
    """(bytes, FLOPs) of one grouped product over ``routed`` rows."""
    return 4 * (routed * (K + N) + E * K * N), 2 * routed * K * N


def phase_grouped_matmul(torch, report, launches):
    """The grouped product and its backward products against their plain
    versions at the cell's shapes, then timed beside the operations'
    bound, the plain loop and the library's grouped product, then the
    cell's expert layer once on the main path."""
    from repro_torch.kernels import grouped_matmul as GM
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    offs = torch.tensor([0, 3, 8], dtype=torch.int32, device="cuda")
    GM.grouped_matmul(torch.ones(8, 4, device="cuda"),
                      torch.ones(2, 4, 4, device="cuda"), offs)
    torch.cuda.synchronize()
    log(f"grouped_matmul build + first launch: {time.time() - t0:.2f} s")
    errs = {"grouped_matmul": 0.0, "grouped_matmul_bwd": 0.0}
    tf32_least = math.inf
    checked = 0
    for K, N in GMM_SHAPES:
        for groups in ("even", "skewed", "empty"):
            x, w, dy, offsets = gmm_inputs(torch, K, N, groups, gen)
            got = (GM.grouped_matmul(x, w, offsets),
                   GM.grouped_matmul_dx(dy, w, offsets),
                   GM.grouped_matmul_wgrad(x, dy, offsets, w.shape[0]))
            want = (ref.grouped_matmul_ref(x, w, offsets),
                    ref.grouped_matmul_ref(dy, w.transpose(1, 2), offsets),
                    ref.grouped_matmul_wgrad_ref(x, dy, offsets, w.shape[0]))
            for name, a, b in zip(("forward", "dx", "dw"), got, want):
                rel = float((a - b).abs().max() / b.abs().max())
                if not rel <= GMM_RTOL:
                    raise AssertionError(f"grouped_matmul {name} ({K}, {N}) "
                                         f"{groups}: {rel:.3g} of the "
                                         f"largest entry")
                key = "grouped_matmul" if name == "forward" else \
                    "grouped_matmul_bwd"
                errs[key] = max(errs[key], rel)
            end = int(offsets[-1])
            if torch.count_nonzero(got[0][end:]) or torch.count_nonzero(
                    got[1][end:]):
                raise AssertionError("grouped_matmul: a row outside every "
                                     "group is not 0")
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = ref.grouped_matmul_ref(x, w, offsets)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            tf32_least = min(tf32_least, float((tf32 - want[0]).abs().max()
                                               / want[0].abs().max()))
            checked += 1
            del x, w, dy, got, want, tf32
    if not tf32_least > GMM_RTOL:
        raise AssertionError(f"grouped_matmul: TF32 products within "
                             f"{tf32_least:.3g}, inside GMM_RTOL")
    log(f"grouped_matmul: forward, dx and dw within {errs} of the largest "
        f"entry in {checked} cases (GMM_RTOL {GMM_RTOL}; TF32 products "
        f"{tf32_least:.3g} at the least)")
    rows, routed, E = GMM_ROWS
    K, N = GMM_SHAPES[0]
    x, w, dy, offsets = gmm_inputs(torch, K, N, "even", gen)
    bounds = offsets.tolist()
    nbytes, flops = gmm_ops(routed, K, N, E)
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]) * 1e3
    fwd, dx, wgrad = gmm_plain(torch, bounds)
    times = {
        "forward": device_ms(torch, GM.grouped_matmul, [(x, w, offsets)]),
        "dx": device_ms(torch, GM.grouped_matmul_dx, [(dy, w, offsets)]),
        "dw": device_ms(torch, GM.grouped_matmul_wgrad,
                        [(x, dy, offsets, E)]),
        "plain_forward": device_ms(torch, fwd, [(x, w)]),
        "plain_dx": device_ms(torch, dx, [(dy, w)]),
        "plain_dw": device_ms(torch, wgrad, [(x, dy, E)])}
    library = None
    try:        # the yardstick: PyTorch's private grouped product, which
        # copies from the host and so stays out of a CUDA graph
        a, o = x[:routed], offsets[1:]
        for _ in range(3):
            torch._grouped_mm(a, w, offs=o)
        library = event_ms(torch, lambda: [torch._grouped_mm(a, w, offs=o)
                                           for _ in range(TIMED_CALLS)])
        library /= TIMED_CALLS
    except Exception as e:      # noqa: BLE001 - absent or refusing f32
        log(f"grouped_matmul: torch._grouped_mm not timed "
            f"({type(e).__name__}: {e})")
    log(f"grouped_matmul at ({rows} rows, {routed} routed over {E}) x "
        f"({K}, {N}): forward {times['forward']:.4f} ms, dx "
        f"{times['dx']:.4f}, dw {times['dw']:.4f} against a bound of "
        f"{bound:.4f} ms each ({flops / 1e9:.1f} GFLOP at 67 TFLOP/s); "
        f"plain {times['plain_forward']:.4f} / {times['plain_dx']:.4f} / "
        f"{times['plain_dw']:.4f} ms; torch._grouped_mm {library}")
    del x, w, dy
    torch.cuda.empty_cache()
    counts = gmm_main_path(torch, launches)
    shape = [rows, routed, E, K, N]
    report["grouped_matmul"] = {
        "max_abs_err": errs["grouped_matmul"], "ms": times["forward"],
        "plain_ms": times["plain_forward"], "bound_ms": bound,
        "bound_by": "operations", "library_ms": library, "shape": shape,
        "tf32_rel_err": tf32_least, "launches": counts}
    report["grouped_matmul_bwd"] = {
        "max_abs_err": errs["grouped_matmul_bwd"], "ms": times["dx"],
        "plain_ms": times["plain_dx"], "bound_ms": bound,
        "bound_by": "operations", "shape": shape, "dw_ms": times["dw"],
        "plain_dw_ms": times["plain_dw"]}


def gmm_main_path(torch, launches):
    """The AFMoE cell's expert layer on one worker's 4096 tokens, forward
    and backward, as one main-path run: 3 grouped products and 6
    backward ones.  Returns its launch counts."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.moe import apply_routed_moe, init_routed_moe
    rows, routed, E = GMM_ROWS
    cfg = ModelConfig(name="trinity-mini-layer", family="moe", num_layers=1,
                      d_model=2048, num_heads=32, num_kv_heads=4, d_ff=1024,
                      vocab_size=64, num_experts=E, router_experts=128,
                      experts_per_token=8, score_func="sigmoid",
                      route_norm=True, route_scale=2.826, shared_d_ff=1024,
                      dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_routed_moe(cfg, gen)
    for v in (*(v for k, v in params.items() if k != "shared"),
              *params["shared"].values()):
        v.requires_grad_(True)
    x = torch.randn(1, rows // 8, 2048, device="cuda", generator=gen,
                    requires_grad=True)

    def layer():
        out, _ = apply_routed_moe(params, x, cfg)
        out.square().mean().backward()
    _, secs, counts = counted(torch, launches, layer)
    want = {**ZERO, "grouped_matmul": 3, "grouped_matmul_bwd": 6}
    if counts != want:
        raise AssertionError(f"expert layer: launches {counts}, expected "
                             f"{want}")
    log(f"grouped_matmul main path: the cell's expert layer, forward and "
        f"backward on 4096 tokens, {secs:.3f} s with the first launch")
    return counts


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


def counted(torch, launches, fn):
    """Run ``fn`` as one main-path run: every launch count set to 0 just
    before, read just after and added to ``launches``.  Returns (output,
    seconds, this run's counts)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    reset_launches()
    out, secs = sync_time(torch, fn)
    counts = dict(LAUNCHES)
    for name, v in counts.items():
        launches[name] += v
    return out, secs, counts


def main_path_run(torch, rt, problem, key, launches, **opts):
    """One counted run of the main path through repro_torch.run; returns
    (result, seconds, launches of this run)."""
    return counted(torch, launches, lambda: rt.run(problem, key, **opts))


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
    if counts != {**ZERO, "region_aggregate": T}:
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
    if counts != {**ZERO, "ranl_update": T}:
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
    HELD["diag"] = problem           # the obs phase runs it again
    del res
    torch.cuda.empty_cache()


OBS_RUNS = ("off", "on", "on", "off", "off", "on")  # journal + tracer
OBS_WRITES = 5                   # timed writes of the finished journal
OBS_PROFILE_ROUNDS = 3
OBS_TRACES = ("xs", "dist_sq", "losses", "coverage", "comm_floats",
              "round_time", "max_stale", "comm_bytes", "pod_bytes")


def phase_obs(torch, rt, report, launches):
    """The diag main path (N = 32, d = 4096, 30 rounds, K2 a round) with
    ``journal=`` under ``tracing()`` and without either, in turns: xs and
    every trace bit-equal, 30 K2 launches each; the journal valid, free
    of drift records, its ``execute`` span timed on the card; the report
    CLI renders it; the writer timed alone on the finished result;
    ``torch_profiler`` over a 3-round run names the five device
    operations that took the most time, the CPU operators that launched
    them, and their sum against the run's wall time."""
    from repro_torch import prng
    from repro_torch.obs import (Journal, device_ops, read_journal,
                                 torch_profiler, tracing, validate_journal,
                                 write_run_journal)
    T = 30
    problem = HELD.pop("diag", None)
    if problem is None:              # the diag phase failed before it
        problem = diag_problem(torch, rt)
    key = prng.PRNGKey(1)
    opts = dict(curvature="diag", num_rounds=T, num_regions=64)
    out_dir = os.path.join(HERE, "build", "obs")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "diag.jsonl")
    init_s = init_seconds(torch, lambda: rt.run(
        problem, key, curvature="diag", num_rounds=0, num_regions=64))
    runs = {"off": [], "on": []}
    for mode in OBS_RUNS:
        if mode == "on":
            with tracing() as tracer:
                res, secs, counts = main_path_run(
                    torch, rt, problem, key, launches, journal=path, **opts)
        else:
            res, secs, counts = main_path_run(torch, rt, problem, key,
                                              launches, **opts)
        if counts != {**ZERO, "ranl_update": T}:
            raise AssertionError(f"obs {mode} run launches {counts}")
        runs[mode].append((res, (secs - init_s) / T * 1e3))
    base = runs["off"][0][0]
    for mode, rs in runs.items():
        for res, _ in rs:
            for f in OBS_TRACES:
                if not torch.equal(getattr(res, f), getattr(base, f)):
                    raise AssertionError(f"obs: journal {mode}: {f} is not "
                                         f"bit-equal to the journal-off run")
            if (res.tau_star, res.tau_covered) != (base.tau_star,
                                                   base.tau_covered):
                raise AssertionError(f"obs: journal {mode}: tau differs")
    records = read_journal(path)
    problems = validate_journal(records)
    if problems:
        raise AssertionError(f"obs: invalid journal: {problems}")
    kinds = [r["kind"] for r in records]
    if "drift" in kinds or kinds.count("round") != T:
        raise AssertionError(f"obs: journal kinds {sorted(set(kinds))}, "
                             f"{kinds.count('round')} rounds")
    spans = [r for r in records if r["kind"] == "span"]
    if [s["name"] for s in spans] != ["execute"] or not (
            spans[0].get("device_s", 0.0) > 0.0):
        raise AssertionError(f"obs: spans {spans}")
    rendered = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", path],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    if rendered.returncode != 0 or "span device time" not in rendered.stdout:
        raise AssertionError(f"obs: the report CLI failed: "
                             f"{rendered.stderr[-2000:]}")
    write_ms = []
    for _ in range(OBS_WRITES):
        t0 = time.perf_counter()
        write_run_journal(Journal(), base, engine="scan", options=rt.
                          RanlOptions(**opts), problem=problem)
        write_ms.append((time.perf_counter() - t0) * 1e3)
    with torch_profiler(os.path.join(out_dir, "profile")) as prof:
        _, prof_s = sync_time(torch, lambda: rt.run(
            problem, key, curvature="diag", num_rounds=OBS_PROFILE_ROUNDS,
            num_regions=64))
    ops = device_ops(prof)
    device_ms = sum(op["device_ms"] for op in ops)
    for op in ops[:5]:
        op["launched_by"] = launched_by(prof, op["name"])[:3]
    on_ms = [ms for _, ms in runs["on"]]
    off_ms = [ms for _, ms in runs["off"]]
    report["obs"] = {
        "nvidia_smi": report.get("nvidia_smi"), "init_s": init_s,
        "round_ms_on": on_ms, "round_ms_off": off_ms,
        "on_over_off": statistics.mean(on_ms) / statistics.mean(off_ms),
        "write_ms": write_ms, "execute_host_s": spans[0]["dur_s"],
        "execute_device_s": spans[0]["device_s"],
        "journal_records": len(records), "launches": counts,
        "profile_rounds": OBS_PROFILE_ROUNDS,
        "profiled_run_ms": prof_s * 1e3, "profiled_device_ms": device_ms,
        "top_device_ops": ops[:5]}
    log(f"obs: {report.get('nvidia_smi')}: diag round with journal + "
        f"tracer {', '.join(f'{ms:.3f}' for ms in on_ms)} ms, without "
        f"{', '.join(f'{ms:.3f}' for ms in off_ms)} ms (on/off "
        f"{report['obs']['on_over_off']:.4f}); the writer alone "
        f"{statistics.median(write_ms):.3f} ms a run; xs and traces "
        f"bit-equal; journal valid, {len(records)} records, no drift; "
        f"execute span {spans[0]['dur_s']:.4f} s host, "
        f"{spans[0]['device_s']:.4f} s on the card; report CLI rendered it")
    log(f"obs: {report.get('nvidia_smi')}: a {OBS_PROFILE_ROUNDS}-round "
        f"diag run under torch_profiler: {prof_s * 1e3:.3f} ms, device "
        f"operations {device_ms:.3f} ms; the top five: " + "; ".join(
            f"{op['name'][:90]} {op['device_ms']:.3f} ms / {op['calls']}, "
            f"launched by " + ", ".join(f"{c} ({ms:.3f} ms / {n})"
                                        for c, ms, n in op["launched_by"])
            for op in ops[:5]))
    del problem, runs, base, res
    torch.cuda.empty_cache()


def launched_by(prof, name):
    """The CPU operator chains (innermost first) that launched the device
    operation ``name`` in a finished profile: [(chain, ms, calls)], the
    most device time first."""
    chains = {}
    for e in prof.events():
        for k in e.kernels:
            if k.name != name:
                continue
            chain, q = [], e
            while q is not None:
                chain.append(q.name)
                q = q.cpu_parent
            row = chains.setdefault(" < ".join(chain), [0.0, 0])
            row[0] += k.duration / 1e3
            row[1] += 1
    return sorted(((c, ms, n) for c, (ms, n) in chains.items()),
                  key=lambda r: -r[1])


def phase_examples():
    """``examples/torch_quickstart.py`` on the card, in a subprocess."""
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "examples",
                                      "torch_quickstart.py")],
        capture_output=True, text=True, timeout=300, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    if out.returncode != 0:
        raise AssertionError(f"torch_quickstart exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    log("examples: torch_quickstart on the card: " + " | ".join(
        lines[-4:]))


def phase_engines(torch, rt, report):
    from repro_torch import prng
    from repro_torch.kernels import LAUNCHES, reset_launches
    T = 20
    problem = rt.make_quadratic(prng.PRNGKey(2), num_workers=16, dim=1024,
                                kappa=100.0, coupling=0.0, num_regions=16,
                                grad_noise=0.1, device="cuda")
    opts = dict(num_rounds=T, num_regions=16,
                policy=rt.PolicyConfig(keep_prob=0.5, tau_star=1))
    reset_launches()
    scan = rt.run(problem, prng.PRNGKey(3), **opts)
    torch.cuda.synchronize()
    if LAUNCHES["region_aggregate"] != T:
        raise AssertionError(f"scan engine K1 launches {LAUNCHES}")
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


# --------------------------------------------------------------------------
# the batch engine, the round options and the low-rank init
# --------------------------------------------------------------------------

def dense_problem(torch, rt, device="cuda"):
    from repro_torch import prng
    return rt.make_quadratic(prng.PRNGKey(0), num_workers=32, dim=8192,
                             kappa=1e3, coupling=0.0, num_regions=64,
                             device=device)


def diag_problem(torch, rt, device="cuda"):
    from repro_torch import prng
    return rt.make_logistic(prng.PRNGKey(0), num_workers=32, per_worker=4096,
                            dim=4096, device=device)


def on_host(problem):
    """The same problem with its tensors copied to the CPU."""
    return dataclasses.replace(problem, **{
        f.name: getattr(problem, f.name).cpu()
        for f in dataclasses.fields(problem)
        if hasattr(getattr(problem, f.name), "cpu")})


INT_TRACES = ("coverage", "comm_floats", "max_stale", "round_time",
              "comm_bytes")


def same_traces(torch, a, b, label, seed=None):
    """Integer traces (and the simulated clock and wire bytes) of ``a``
    (row ``seed`` of a batched run, if given) equal ``b``'s."""
    for f in INT_TRACES:
        x = getattr(a, f) if seed is None else getattr(a, f)[seed]
        if not torch.equal(x.cpu(), getattr(b, f).cpu()):
            raise AssertionError(f"{label}: {f} differs")
    tau = ((a.tau_star, a.tau_covered) if seed is None else
           (int(a.tau_star[seed]), int(a.tau_covered[seed])))
    if tau != (b.tau_star, b.tau_covered):
        raise AssertionError(f"{label}: tau {tau} vs "
                             f"{(b.tau_star, b.tau_covered)}")


def phase_batch(torch, rt, report, launches, kind):
    """engine="batch" over SEEDS keys at the main path's full size: one
    seed-batched K1 (dense) or K2 (diag) launch a round, held against
    SEEDS separate scan runs on the card."""
    from repro_torch import prng
    T = 30
    name = "region_aggregate" if kind == "dense" else "ranl_update"
    problem = (dense_problem if kind == "dense" else diag_problem)(torch, rt)
    data = problem.A if kind == "dense" else problem.X
    keys = prng.split(prng.PRNGKey(1), SEEDS)
    opts = dict(num_rounds=T, num_regions=64, curvature=kind,
                policy=rt.PolicyConfig(keep_prob=0.5, tau_star=1))
    init_s = init_seconds(torch, lambda: rt.run(
        problem, keys, engine="batch", **{**opts, "num_rounds": 0}))
    res, total_s, counts = main_path_run(torch, rt, problem, keys, launches,
                                         engine="batch", **opts)
    check_finite(torch, res)
    if counts != {**ZERO, name: T}:
        raise AssertionError(f"batch {kind} launches {counts}")
    if tuple(res.xs.shape) != (SEEDS, T + 2, problem.dim):
        raise AssertionError(f"batch {kind}: xs shape {tuple(res.xs.shape)}")
    if kind == "dense":
        if not bool((res.dist_sq[:, -1] <= 1e-6 * res.dist_sq[:, 0]).all()):
            raise AssertionError("batch dense: dist_sq did not fall by 1e-6")
    elif not bool((res.losses[:, -1] < res.losses[:, 0]).all()):
        # below x0's, not x1's: as in the reference (phase_options)
        raise AssertionError("batch diag: loss did not fall below x0's")
    worst = 0.0
    for b in range(SEEDS):
        one = rt.run(problem, keys[b], **opts)
        same_traces(torch, res, one, f"batch {kind} seed {b} vs scan", b)
        scale = one.xs.abs().max().item()
        err = (res.xs[b] - one.xs).abs().max().item()
        if not err <= BATCH_XS_RTOL * scale:
            raise AssertionError(f"batch {kind} seed {b} vs scan: xs max "
                                 f"|err| {err} > {BATCH_XS_RTOL} x {scale}")
        worst = max(worst, err / scale)
    round_ms = (total_s - init_s) / T * 1e3
    floor_ms = data.numel() * 4 / HBM_BYTES_PER_S * 1e3
    solve = solve_ms(torch, problem) if kind == "dense" else {}
    report[f"batch_{kind}"] = {
        "seeds": SEEDS, "init_s": init_s, "total_s": total_s,
        "round_ms": round_ms, "round_ms_per_seed": round_ms / SEEDS,
        "single_seed_round_ms": report.get(kind, {}).get("round_ms"),
        "read_floor_ms": floor_ms, "launches": counts,
        "xs_vs_scan_max_rel": worst, **solve}
    if solve:
        log(f"batch_dense: one round's Cholesky step alone: "
            f"{solve['solve_ms_batch']:.3f} ms for {SEEDS} seeds at once, "
            f"{solve['solve_ms_single']:.3f} ms for one")
    log(f"batch_{kind}: {SEEDS} seeds, init {init_s:.2f} s, {round_ms:.3f} "
        f"ms/round = {round_ms / SEEDS:.3f} ms per round and seed (one seed: "
        f"{report.get(kind, {}).get('round_ms')} ms/round); "
        f"{'A' if kind == 'dense' else 'X'} read floor {floor_ms:.3f} ms a "
        f"round at 3.35 TB/s; launches {counts}; each row equals its scan "
        f"run (integer traces), xs max |err| {worst:.3e} x max |x|")
    del problem, res
    torch.cuda.empty_cache()


def solve_ms(torch, problem):
    """CUDA-event times of one round's dense step against the factor of
    the mean Hessian, median of 5: the port's ``cho_solve`` (two
    triangular solves) for SEEDS seeds at once (SEEDS factors, as the
    batch engine holds) and for one."""
    from repro_torch.core.hessian import cho_factor, cho_solve
    L = cho_factor(problem.mean_hessian())
    LB = L.expand(SEEDS, -1, -1).contiguous()
    g = torch.randn(SEEDS, problem.dim, device="cuda")
    out = {}
    for label, fn in (("batch", lambda: cho_solve(LB, g)),
                      ("single", lambda: cho_solve(L, g[0]))):
        fn()
        out[f"solve_ms_{label}"] = statistics.median(
            event_ms(torch, fn) for _ in range(5))
    del L, LB
    torch.cuda.empty_cache()
    return out


def option_runs():
    """(label, problem kind, options, controller, scenario, converges,
    xs tolerance) of the options phase: compression, quorum and the
    closed-loop controllers on the scan engine at the main paths' sizes.
    The top-k diag run does not converge, in the reference as in the
    port: each worker sends 8 of 64 regions, error feedback releases the
    rest rounds later, and the unit diagonal Newton step overshoots on
    that delayed mass (the loss climbs from 0.591 at x¹ to about 0.79 at
    x^T; ROADMAP Queue 3).  It is held to finite values and to the host
    run.  The tolerances of x² … x^T, x max |x|, are those the CPU
    tests hold the port to against the reference
    (tests/test_torch_options.py): 2e-5, 5e-5 with quorum's late folds,
    5e-2 (one quantization step) with int8, whose quantizer's inputs
    differ in the last bit between two summation orders."""
    return (
        ("dense_int8", "dense", dict(compression="int8"), None, None, True,
         5e-2),
        ("dense_quorum", "dense", dict(quorum=0.75, max_delay=2), None,
         "pareto-stragglers", True, 5e-5),
        ("diag_topk_resource", "diag", dict(compression="topk:8"),
         "resource", "churn-stragglers", False, 2e-5),
        ("diag_staleness_bounded", "diag", dict(), "staleness-bounded",
         "dropout", True, 2e-5))


def phase_options(torch, rt, report, launches):
    """Each option run on the card, then the same problem, key and options
    on the host: integer traces, comm_bytes and round_time equal; x¹
    within ``INIT_XS_TOL``, x² … x^T within the run's tolerance
    (``option_runs``).  The scenario's cost
    model is drawn on the host (pareto rates included) and moved, so card
    and host price the same cluster; quorum deadlines are differences of
    those rates' f32 quotients, equal on both, so no tolerance is needed.
    A converging dense run's dist_sq falls from x¹ to x^T.  A converging
    diag run's loss falls below x⁰'s but not below x¹'s: its first
    diagonal Newton step lands next to x*, and the pruned rounds settle a
    little above it, in the reference as in the port
    (tests/test_torch_options.py::
    test_diag_loss_settles_above_the_first_step_as_in_the_reference holds
    both to the same rise at N = 32; ROADMAP Queue 3).  ``option_runs``
    says which run does not converge, and why."""
    from repro_torch import prng
    from repro_torch.hetero.scenarios import make_scenario
    T = 30
    out = {}
    for kind in ("dense", "diag"):
        problem = (dense_problem if kind == "dense" else diag_problem)(
            torch, rt)
        host, N = on_host(problem), problem.num_workers
        for label, pk, kw, ctrl, scen, converges, tol in option_runs():
            if pk != kind:
                continue
            opts = dict(num_rounds=T, num_regions=64, curvature=kind,
                        controller=ctrl, **kw)
            card_cost = host_cost = None
            if scen is not None:
                card_cost = make_scenario(scen, prng.PRNGKey(7), N,
                                          device="cuda").cost
                host_cost = make_scenario(scen, prng.PRNGKey(7), N,
                                          device="cpu").cost
            init_s = init_seconds(torch, lambda: rt.run(
                problem, prng.PRNGKey(1), cost=card_cost,
                **{**opts, "num_rounds": 0}))
            res, total_s, counts = main_path_run(
                torch, rt, problem, prng.PRNGKey(1), launches,
                cost=card_cost, **opts)
            check_finite(torch, res)
            if converges and kind == "dense" and not float(
                    res.dist_sq[-1]) < float(res.dist_sq[1]):
                raise AssertionError(f"{label}: dist_sq did not fall from "
                                     f"x1 to x_T")
            if converges and kind == "diag" and not float(
                    res.losses[-1]) < float(res.losses[0]):
                raise AssertionError(f"{label}: loss did not fall below "
                                     f"x0's")
            t0 = time.time()
            ref = rt.run(host, prng.PRNGKey(1), device="cpu", cost=host_cost,
                         **opts)
            host_s = time.time() - t0
            same_traces(torch, res, ref, f"{label} card vs host")
            scale = ref.xs.abs().max().item()
            gap = (res.xs.cpu() - ref.xs).abs().amax(dim=-1) / scale
            init_err, err = gap[1].item(), gap[2:].max().item()
            if not init_err <= INIT_XS_TOL:
                raise AssertionError(f"{label} card vs host: x1 |err| "
                                     f"{init_err} x max |x| > {INIT_XS_TOL}")
            if not err <= tol:
                raise AssertionError(f"{label} card vs host: xs[2:] max "
                                     f"|err| {err} x max |x| > {tol}")
            round_ms = (total_s - init_s) / T * 1e3
            out[label] = {"init_s": init_s, "round_ms": round_ms,
                          "held_to_converge": converges,
                          "launches": counts, "host_run_s": host_s,
                          "x1_vs_host_max_rel": init_err,
                          "xs_vs_host_max_rel": err, "xs_tol": tol,
                          "dist_sq_1": float(res.dist_sq[1]),
                          "dist_sq_T": float(res.dist_sq[-1]),
                          "loss_0": float(res.losses[0]),
                          "loss_1": float(res.losses[1]),
                          "loss_T": float(res.losses[-1]),
                          "tau_star": res.tau_star,
                          "comm_bytes_total": float(res.comm_bytes.sum()),
                          "round_time_total": float(res.round_time.sum())}
            log(f"options {label}: {round_ms:.3f} ms/round (init "
                f"{init_s:.2f} s); dist_sq {out[label]['dist_sq_1']:.4e} "
                f"(x1) -> {out[label]['dist_sq_T']:.4e}, loss "
                f"{out[label]['loss_0']:.5f} -> {out[label]['loss_1']:.5f} "
                f"(x1) -> {out[label]['loss_T']:.5f}; integer traces, "
                f"comm_bytes and round_time equal the host run's "
                f"({host_s:.1f} s); max |err| x max |x|: x1 {init_err:.3e} "
                f"(tol {INIT_XS_TOL}), x2..xT {err:.3e} (tol {tol}); "
                f"launches {counts}")
        del problem, host
        torch.cuda.empty_cache()
    report["options"] = out


def phase_hierarchy(torch, rt, report, launches):
    """Hierarchical pod-of-pods rounds at the main paths' sizes
    (``HIER_RUNS``): one K1 (dense) or K2 (diag) launch a round for all
    pods, as (P, N/P, d) rows; integer traces, pod_bytes and round_time
    equal to a host run of the same problem, key and scenario, x¹
    within ``INIT_XS_TOL`` and x² … x^T of xs_pods within the run's
    tolerance; ms per round beside the flat run of the same problem and
    cost.  Then engine="batch" over SEEDS keys of the diag run: one K2
    launch a round at (SEEDS·P, N/P, d), each row equal to the scan run
    of its key."""
    from repro_torch import prng
    from repro_torch.hetero.scenarios import make_scenario
    T = 30
    pol = rt.PolicyConfig(keep_prob=0.5, tau_star=1)
    out = {}
    for label, kind, spec, scen, tol in HIER_RUNS:
        problem = (dense_problem if kind == "dense" else diag_problem)(
            torch, rt)
        N = problem.num_workers
        name = "region_aggregate" if kind == "dense" else "ranl_update"
        card_cost = make_scenario(scen, prng.PRNGKey(7), N,
                                  device="cuda").cost
        opts = dict(num_rounds=T, num_regions=64, curvature=kind,
                    policy=pol, cost=card_cost)
        # each timed run is the second of two (the first compiles the
        # kernels for its shapes), less a warm zero-round run (the init)
        flat_init = init_seconds(torch, lambda: rt.run(
            problem, prng.PRNGKey(1), **{**opts, "num_rounds": 0}))
        rt.run(problem, prng.PRNGKey(1), **opts)
        flat, flat_s = sync_time(torch, lambda: rt.run(
            problem, prng.PRNGKey(1), **opts))
        init_s = init_seconds(torch, lambda: rt.run(
            problem, prng.PRNGKey(1), hierarchy=spec,
            **{**opts, "num_rounds": 0}))
        rt.run(problem, prng.PRNGKey(1), hierarchy=spec, **opts)
        res, total_s, counts = main_path_run(
            torch, rt, problem, prng.PRNGKey(1), launches, hierarchy=spec,
            **opts)
        check_finite(torch, res)
        pods = int(spec.split(",")[0].split("=")[1])
        if counts != {**ZERO, name: T}:
            raise AssertionError(f"hierarchy {label} launches {counts}")
        if tuple(res.xs_pods.shape) != (T + 2, pods, problem.dim):
            raise AssertionError(f"hierarchy {label}: xs_pods shape "
                                 f"{tuple(res.xs_pods.shape)}")
        if kind == "dense" and not float(res.dist_sq[-1]) < float(
                res.dist_sq[1]):
            raise AssertionError(f"hierarchy {label}: dist_sq did not fall "
                                 f"from x1 to x_T")
        if kind == "diag" and not float(res.losses[-1]) < float(
                res.losses[0]):
            raise AssertionError(f"hierarchy {label}: loss did not fall "
                                 f"below x0's")
        host_cost = make_scenario(scen, prng.PRNGKey(7), N,
                                  device="cpu").cost
        host = on_host(problem)
        t0 = time.time()
        ref = rt.run(host, prng.PRNGKey(1), device="cpu", hierarchy=spec,
                     **{**opts, "cost": host_cost})
        host_s = time.time() - t0
        same_traces(torch, res, ref, f"hierarchy {label} card vs host")
        if not torch.equal(res.pod_bytes.cpu(), ref.pod_bytes):
            raise AssertionError(f"hierarchy {label}: pod_bytes differ")
        scale = ref.xs_pods.abs().max().item()
        gap = (res.xs_pods.cpu() - ref.xs_pods).abs().amax(dim=(-2, -1)) \
            / scale
        init_err, err = gap[1].item(), gap[2:].max().item()
        if not init_err <= INIT_XS_TOL:
            raise AssertionError(f"hierarchy {label} card vs host: x1 "
                                 f"|err| {init_err} x max |x|")
        if not err <= tol:
            raise AssertionError(f"hierarchy {label} card vs host: xs_pods"
                                 f"[2:] max |err| {err} x max |x| > {tol}")
        pod_rows(pods, N // pods, problem.dim)
        round_ms = (total_s - init_s) / T * 1e3
        flat_ms = (flat_s - flat_init) / T * 1e3
        out[label] = {
            "hierarchy": spec, "scenario": scen, "round_ms": round_ms,
            "flat_round_ms": flat_ms, "init_s": init_s, "launches": counts,
            "kernel_rows": [pods, N // pods, problem.dim],
            "host_run_s": host_s, "x1_vs_host_max_rel": init_err,
            "xs_pods_vs_host_max_rel": err, "xs_tol": tol,
            "pod_bytes_total": float(res.pod_bytes.sum()),
            "flat_pod_bytes_total": float(flat.pod_bytes.sum()),
            "round_time_total": float(res.round_time.sum()),
            "flat_round_time_total": float(flat.round_time.sum()),
            "dist_sq_1": float(res.dist_sq[1]),
            "dist_sq_T": float(res.dist_sq[-1]),
            "loss_0": float(res.losses[0]), "loss_T": float(res.losses[-1])}
        log(f"hierarchy {label} ({spec} on {scen}): {round_ms:.3f} ms/round "
            f"against {flat_ms:.3f} flat; {name} at ({pods}, {N // pods}, "
            f"{problem.dim}) once a round, launches {counts}; simulated "
            f"time {out[label]['round_time_total']:.1f} against "
            f"{out[label]['flat_round_time_total']:.1f} flat, pod bytes "
            f"{out[label]['pod_bytes_total']:.0f} against "
            f"{out[label]['flat_pod_bytes_total']:.0f}; traces equal the "
            f"host run's ({host_s:.1f} s); max |err| x max |x|: x1 "
            f"{init_err:.3e}, x2..xT {err:.3e} (tol {tol})")
        if kind == "diag":
            out["batch_diag"] = hierarchy_batch(torch, rt, problem, spec,
                                                opts, launches, tol, report)
        del problem, host, res, ref, flat
        torch.cuda.empty_cache()
    report["hierarchy"] = out


def pod_rows(*shape):
    """A hierarchy run's kernel rows must be among the shapes the kernels
    phase holds K1/K2 to their plain versions at."""
    if shape not in POD_ROW_SHAPES:
        raise AssertionError(f"kernel rows {shape} are not among "
                             f"POD_ROW_SHAPES {POD_ROW_SHAPES}")


def hierarchy_batch(torch, rt, problem, spec, opts, launches, tol, report):
    """engine="batch" over SEEDS keys of one hierarchical run: one kernel
    launch a round at (SEEDS·P, N/P, d); each row's traces equal the
    scan run of its key on the card, its xs_pods within ``tol`` x max
    |x| (the seed-batched kernel sums the rows in another order, and
    the int8 exchange may round a value one step apart)."""
    from repro_torch import prng
    T = opts["num_rounds"]
    keys = prng.split(prng.PRNGKey(1), SEEDS)
    init_s = init_seconds(torch, lambda: rt.run(
        problem, keys, engine="batch", hierarchy=spec,
        **{**opts, "num_rounds": 0}))
    rt.run(problem, keys, engine="batch", hierarchy=spec, **opts)
    res, total_s, counts = main_path_run(torch, rt, problem, keys, launches,
                                         engine="batch", hierarchy=spec,
                                         **opts)
    check_finite(torch, res)
    if counts != {**ZERO, "ranl_update": T}:
        raise AssertionError(f"hierarchy batch launches {counts}")
    worst = 0.0
    for b in range(SEEDS):
        one = rt.run(problem, keys[b], hierarchy=spec, **opts)
        same_traces(torch, res, one, f"hierarchy batch seed {b} vs scan", b)
        if not torch.equal(res.pod_bytes[b], one.pod_bytes):
            raise AssertionError(f"hierarchy batch seed {b}: pod_bytes")
        scale = one.xs_pods.abs().max().item()
        err = (res.xs_pods[b] - one.xs_pods).abs().max().item() / scale
        if not err <= tol:
            raise AssertionError(f"hierarchy batch seed {b} vs scan: "
                                 f"xs_pods max |err| {err} x max |x|")
        worst = max(worst, err)
    round_ms = (total_s - init_s) / T * 1e3
    pods = res.xs_pods.shape[-2]
    pod_rows(SEEDS * pods, problem.num_workers // pods, problem.dim)
    row = {"seeds": SEEDS, "round_ms": round_ms,
           "round_ms_per_seed": round_ms / SEEDS, "init_s": init_s,
           "launches": counts, "xs_pods_vs_scan_max_rel": worst,
           "kernel_rows": [SEEDS * pods, problem.num_workers // pods,
                           problem.dim],
           "flat_batch_diag_round_ms": report.get("batch_diag",
                                                  {}).get("round_ms")}
    log(f"hierarchy batch_diag: {SEEDS} seeds, {round_ms:.3f} ms/round = "
        f"{round_ms / SEEDS:.3f} per seed (flat batch_diag "
        f"{row['flat_batch_diag_round_ms']}); ranl_update at "
        f"{tuple(row['kernel_rows'])} once a round, launches {counts}; "
        f"rows equal their scan runs, xs_pods max |err| {worst:.3e}")
    return row


# --------------------------------------------------------------------------
# the 1-D sharded engine on torch.distributed
# --------------------------------------------------------------------------

def sharded_store(name):
    """A fresh FileStore path under build/sharded/ beside this script."""
    d = os.path.join(HERE, "build", "sharded")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    if os.path.exists(path):
        os.remove(path)
    return path


@contextlib.contextmanager
def loopback():
    """GLOO_SOCKET_IFNAME / NCCL_SOCKET_IFNAME = lo for the sharded phase
    only (the chip host has no network beyond loopback), put back after."""
    names = ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({k: "lo" for k in names})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def contract_counts(rt, res, dim, label, engine="sharded", extents=None,
                    **kw):
    """Hold a sharded run's collective log to the engine's contract
    (``extents``: the 2-D mesh's n_data and n_model); returns the counts:
    param-sized all-reduces matched per dimension (and the units they
    cover), small and capped in-loop and outside-loop ones."""
    from repro_torch.analysis import check_log, engine_contract
    opts = rt.RanlOptions(**kw)
    rep = check_log(engine_contract(engine, opts, dim=dim,
                                    **(extents or {})), res.collectives)
    if not rep["ok"]:
        raise AssertionError(f"{label}: collective log breaks the "
                             f"contract: {rep['violations'][:3]}")
    counts = {k: sum(v) if isinstance(v, list) else v
              for k, v in rep["counts"].items()}
    big = [c for c in res.collectives if c.round is not None
           and c.op == "sum" and c.dtype != "int32"]
    counts["param_wire"] = sorted({(c.dim, c.dtype, c.nbytes) for c in big})
    return counts


def sharded_vs_scan(torch, sh, scan, label, tol, x1_tol=0.0):
    """A sharded run against the scan run of the same problem and key:
    integer traces, comm_bytes, round_time and pod_bytes equal; x¹ bit-
    equal (the same init code; within ``x1_tol`` x max |x| where given);
    x² … x^T within ``tol`` x max |x| (of xs_pods under hierarchy).
    Returns (the x² … x^T gap, x¹'s)."""
    same_traces(torch, sh, scan, label)
    if not torch.equal(sh.pod_bytes.cpu(), scan.pod_bytes.cpu()):
        raise AssertionError(f"{label}: pod_bytes differ")
    a, b = ((sh.xs_pods, scan.xs_pods) if scan.xs_pods is not None
            else (sh.xs, scan.xs))
    a, b = a.cpu(), b.cpu()
    err1 = ((a[1] - b[1]).abs().max() / b.abs().max()).item()
    if not (torch.equal(a[1], b[1]) if x1_tol == 0.0 else err1 <= x1_tol):
        raise AssertionError(f"{label}: x1 differs from the scan run's "
                             f"({err1} x max |x|, tol {x1_tol})")
    err = ((a[2:] - b[2:]).abs().max() / b.abs().max()).item()
    if not err <= tol:
        raise AssertionError(f"{label}: x2..xT max |err| {err} x max |x| "
                             f"> {tol}")
    return err, err1


# leg (a): NCCL at world size 1 — (label, problem kind, options, xs
# tolerance against the scan run: the CPU tests' 2e-5 for uncompressed
# rounds; 5e-2, one int8 step, for int8, whose sharded run quantizes the
# rank's partial sum where the scan run quantizes each worker's row)
SHARDED_RUNS = (("dense", "dense", {}, 2e-5),
                ("dense_int8", "dense", {"compression": "int8"}, 5e-2),
                ("diag", "diag", {}, 2e-5),
                ("diag_overlap", "diag", {"overlap": True}, 2e-5))
# leg (b): two ranks on the one card over gloo — (label, mesh shape, mesh
# dims, hierarchy, xs tolerance against the scan run: 2e-5, and 5e-2 under
# the int8 exchange, one quantization step, as the hierarchy phase holds
# it: the scan run's pod rounds sum through K2, in another order, and the
# exchange quantizes what they give)
SHARDED_RANK_RUNS = (("diag", (2,), ("data",), None, 2e-5),
                     ("diag_hier_int8", (2, 1), ("pod", "data"),
                      "pods=2,period=3,gamma=0.5,compression=int8", 5e-2))


def sharded_world_of_one(torch, rt, report, launches):
    """Leg (a): NCCL at world size 1 in this process (a FileStore under
    build/sharded/, the group destroyed after).  Each run of
    ``SHARDED_RUNS`` on engine="sharded" against the scan run of the same
    problem and key; overlap bit-equal to the sequential run; then
    engine="batch" over SEEDS keys with a ("data",) mesh against the
    unsharded batch.  The sharded engine launches no kernel."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import prng
    T, key = 30, prng.PRNGKey(1)
    pol = rt.PolicyConfig(keep_prob=0.5, tau_star=1)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        sharded_store("nccl"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        for kind in ("dense", "diag"):
            problem = (dense_problem if kind == "dense" else diag_problem)(
                torch, rt)
            base = dict(num_rounds=T, num_regions=64, curvature=kind,
                        policy=pol)
            init_s = init_seconds(torch, lambda: rt.run(
                problem, key, **{**base, "num_rounds": 0}))
            # untimed: NCCL's first call, and each timed run's kernels
            rt.run(problem, key, engine="sharded", mesh=mesh,
                   **{**base, "num_rounds": 1})
            for label, pk, kw, tol in SHARDED_RUNS:
                if pk == kind:
                    rt.run(problem, key, **{**base, **kw, "num_rounds": 1,
                                            "overlap": False})
            seq = None
            for label, pk, kw, tol in SHARDED_RUNS:
                if pk != kind:
                    continue
                opts = {**base, **kw}
                scan_kw = {k: v for k, v in opts.items() if k != "overlap"}
                scan, scan_s = sync_time(torch, lambda: rt.run(
                    problem, key, **scan_kw))
                sh, sh_s, counts = counted(torch, launches, lambda: rt.run(
                    problem, key, engine="sharded", mesh=mesh, **opts))
                check_finite(torch, sh)
                if counts != ZERO:
                    raise AssertionError(f"sharded {label}: the engine "
                                         f"launched kernels {counts}")
                err, _ = sharded_vs_scan(torch, sh, scan,
                                         f"sharded {label} vs scan", tol)
                if kw.get("overlap"):
                    for f in ("xs",) + INT_TRACES:
                        if not torch.equal(getattr(sh, f), getattr(seq, f)):
                            raise AssertionError(f"sharded {label}: {f} "
                                                 f"differs from sequential")
                elif not kw:
                    seq = sh
                cc = contract_counts(rt, sh, problem.dim, f"sharded {label}",
                                     **opts)
                out[label] = {
                    "round_ms": (sh_s - init_s) / T * 1e3,
                    "scan_round_ms": (scan_s - init_s) / T * 1e3,
                    "init_s": init_s, "xs_vs_scan_max_rel": err,
                    "xs_tol": tol, "launches": counts, "collectives": cc}
                log(f"sharded (a) NCCL x1 {label}: {out[label]['round_ms']:.3f}"
                    f" ms/round against {out[label]['scan_round_ms']:.3f} on "
                    f"the scan engine ({report.get('nvidia_smi')}); traces "
                    f"equal, x1 bit-equal, x2..xT {err:.3e} x max |x| (tol "
                    f"{tol}); collectives {cc}")
            if kind == "diag":
                out["batch"] = sharded_batch(torch, rt, problem, mesh, base,
                                             launches)
            del problem
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def sharded_batch(torch, rt, problem, mesh, base, launches):
    """engine="batch" over SEEDS keys with a ("data",) mesh against the
    same batch without one: integer traces equal, xs within
    BATCH_XS_RTOL x max |x|, one all-gather after the loop."""
    from repro_torch import prng
    T = base["num_rounds"]
    keys = prng.split(prng.PRNGKey(1), SEEDS)
    init_s = init_seconds(torch, lambda: rt.run(
        problem, keys, engine="batch", **{**base, "num_rounds": 0}))
    rt.run(problem, keys, engine="batch", **{**base, "num_rounds": 1})
    plain, plain_s = sync_time(torch, lambda: rt.run(
        problem, keys, engine="batch", **base))
    res, secs, counts = main_path_run(torch, rt, problem, keys, launches,
                                      engine="batch", mesh=mesh, **base)
    for f in INT_TRACES + ("tau_star", "tau_covered"):
        if not torch.equal(getattr(res, f), getattr(plain, f)):
            raise AssertionError(f"sharded batch: {f} differs")
    err = ((res.xs - plain.xs).abs().max() / plain.xs.abs().max()).item()
    if not err <= BATCH_XS_RTOL:
        raise AssertionError(f"sharded batch: xs max |err| {err} x max |x|")
    if [(c.op, c.round) for c in res.collectives] != [("all_gather", None)]:
        raise AssertionError(f"sharded batch collectives {res.collectives}")
    row = {"seeds": SEEDS, "round_ms": (secs - init_s) / T * 1e3,
           "unsharded_round_ms": (plain_s - init_s) / T * 1e3,
           "xs_vs_unsharded_max_rel": err, "launches": counts}
    log(f"sharded (a) batch: {SEEDS} seeds on a ('data',) mesh of 1, "
        f"{row['round_ms']:.3f} ms/round against "
        f"{row['unsharded_round_ms']:.3f} unsharded; traces equal, xs "
        f"{err:.3e} x max |x|; one all-gather; launches {counts}")
    return row


def _sharded_rank(rank, store, out_dir):
    """Leg (b)'s rank ``rank`` of 2, on the one card over gloo: each run
    of ``SHARDED_RANK_RUNS`` on engine="sharded"; rank 0 then runs the
    same on the scan engine.  Results, on the host, go to
    ``out_dir/rank<r>.pt``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch as rt
    from repro_torch import prng
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        problem = diag_problem(torch, rt)
        key, T = prng.PRNGKey(1), 30
        out = {}
        for label, shape, dims, spec, _ in SHARDED_RANK_RUNS:
            mesh = init_device_mesh("cuda", shape, mesh_dim_names=dims)
            opts = dict(num_rounds=T, num_regions=64, curvature="diag",
                        policy=rt.PolicyConfig(keep_prob=0.5, tau_star=1),
                        hierarchy=spec)
            init_s = init_seconds(torch, lambda: rt.run(
                problem, key, **{**opts, "num_rounds": 0}))
            if rank == 0:                   # untimed: the scan's kernels
                rt.run(problem, key, **{**opts, "num_rounds": 3})
            dist.barrier()
            res, secs = sync_time(torch, lambda: rt.run(
                problem, key, engine="sharded", mesh=mesh, **opts))
            row = {"result": on_host(res), "seconds": secs, "init_s": init_s}
            if rank == 0:
                scan, row["scan_seconds"] = sync_time(
                    torch, lambda: rt.run(problem, key, **opts))
                row["scan"] = on_host(scan)
            dist.barrier()
            out[label] = row
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sharded_two_ranks(torch, rt, report):
    """Leg (b): two ranks on the one card (NCCL refuses two ranks on one
    GPU, so gloo carries CUDA tensors), started with
    ``torch.multiprocessing`` spawn and joined within 600 s.  Each run
    held to the scan run within its tolerance (``SHARDED_RANK_RUNS``),
    both ranks' results equal, both logs within the contract."""
    import torch.multiprocessing as mp
    out_dir = os.path.dirname(sharded_store("gloo"))
    for r in (0, 1):
        if os.path.exists(os.path.join(out_dir, f"rank{r}.pt")):
            os.remove(os.path.join(out_dir, f"rank{r}.pt"))
    ctx = mp.start_processes(_sharded_rank, args=(
        os.path.join(out_dir, "gloo"), out_dir), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.time() + 600
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise AssertionError("the two sharded ranks did not finish in "
                                 "600 s")
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    out = {}
    for label, shape, dims, spec, tol in SHARDED_RANK_RUNS:
        a, b = ranks[0][label], ranks[1][label]
        for f in ("xs", "xs_pods") + INT_TRACES:
            x, y = getattr(a["result"], f), getattr(b["result"], f)
            if x is not None and not torch.equal(x, y):
                raise AssertionError(f"sharded (b) {label}: ranks differ "
                                     f"in {f}")
        err, _ = sharded_vs_scan(torch, a["result"], a["scan"],
                                 f"sharded (b) {label} vs scan", tol)
        T = a["result"].coverage.shape[0]
        kw = dict(num_rounds=T, num_regions=64, hierarchy=spec)
        cc = [contract_counts(rt, r[label]["result"],
                              a["result"].xs.shape[-1],
                              f"sharded (b) {label} rank {i}", **kw)
              for i, r in enumerate(ranks)]
        out[label] = {
            "mesh": dict(zip(dims, shape)),
            "round_ms": [(r[label]["seconds"] - r[label]["init_s"]) / T * 1e3
                         for r in ranks],
            "scan_round_ms": (a["scan_seconds"] - a["init_s"]) / T * 1e3,
            "xs_vs_scan_max_rel": err, "xs_tol": tol,
            "collectives": cc[0]}
        log(f"sharded (b) gloo x2 on one card {label} {out[label]['mesh']}: "
            f"{out[label]['round_ms'][0]:.3f} / "
            f"{out[label]['round_ms'][1]:.3f} ms/round (ranks 0 / 1) "
            f"against {out[label]['scan_round_ms']:.3f} on the scan engine "
            f"({report.get('nvidia_smi')}); ranks equal, traces equal the "
            f"scan run's, x2..xT {err:.3e} x max |x| (tol {tol}); "
            f"collectives {cc[0]}")
    return out


def phase_sharded(torch, rt, report, launches):
    """The 1-D sharded engine: leg (a), NCCL at world size 1 in this
    process; leg (b), two ranks on the card over gloo."""
    with loopback():
        a = sharded_world_of_one(torch, rt, report, launches)
        b = sharded_two_ranks(torch, rt, report)
    report["sharded"] = {**{f"nccl_x1_{k}": v for k, v in a.items()},
                         **{f"gloo_x2_{k}": v for k, v in b.items()}}


# --------------------------------------------------------------------------
# the 2-D engine ("data" x "model") on torch.distributed
# --------------------------------------------------------------------------

# x¹ of a dense 2-D run against the scan run with projection="ns", x
# max |x|: derived as INIT_XS_TOL is — the panel products associate the
# Newton–Schulz cube as (X·X)·X where project_psd_ns computes X·(X·X),
# and the f32 rounding apart of the two projections (a few ulps of
# [H]_μ) reaches x¹ through the solve amplified by up to κ·2⁻²³·8 ≈ 1e-3
# at κ = 1e3; the rounds after it contract the gap.
SHARDED2D_X1_TOL = INIT_XS_TOL
# leg (a), NCCL at world size 1 on a ("data", "model") = (1, 1) mesh:
# (label, problem kind, options, xs tolerance against the scan run, K2
# launches of the run)
SHARDED2D_RUNS = (("dense", "dense", {}, 2e-5, 0),
                  ("dense_int8", "dense", {"compression": "int8"}, 5e-2, 0),
                  ("diag", "diag", {}, 2e-5, 30),
                  ("diag_overlap", "diag", {"overlap": True}, 2e-5, 30))
# leg (b), two ranks on the one card over gloo: (label, problem kind,
# (n_data, n_model), xs tolerance, K2 launches a rank).  The dense run is
# cut to d = 2048: each Newton–Schulz step all-reduces 6 panels through
# gloo's host hop, ≈ 38 GB a run at d = 8192 against ≈ 2.2 GB at 2048.
SHARDED2D_RANK_RUNS = (("diag_1x2", "diag", (1, 2), 2e-5, 30),
                       ("diag_2x1", "diag", (2, 1), 2e-5, 0),
                       ("dense_1x2_d2048", "dense2048", (1, 2), 2e-5, 0))


def dense2048_problem(torch, rt, device="cuda"):
    from repro_torch import prng
    return rt.make_quadratic(prng.PRNGKey(0), num_workers=32, dim=2048,
                             kappa=1e3, coupling=0.0, num_regions=64,
                             device=device)


def memory_row(torch, rt, rec, opts, dim, n_model, label):
    """Hold a recorded dense 2-D run to one (dim/n_model, dim) panel plus
    MEMORY_SLACK; -> the row (largest tensor, its op, the ceiling, the
    card's peak allocation since the last reset)."""
    from repro_torch.analysis import memory_ceiling
    ceiling = memory_ceiling("sharded2d", rt.RanlOptions(**opts), dim=dim,
                             n_model=n_model)
    if not rec.max_bytes <= ceiling:
        raise AssertionError(f"{label}: a {rec.max_bytes}-byte tensor "
                             f"({rec.max_op}) over the {ceiling}-byte "
                             f"panel ceiling")
    return {"largest_tensor_bytes": rec.max_bytes,
            "largest_tensor_op": list(map(str, rec.max_op)),
            "panel_ceiling_bytes": ceiling,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def dense2d_init_split(torch, problem, mesh, key):
    """Seconds of the dense 2-D init's parts on ``mesh``, called one by
    one as ``sharded2d._dense_init`` calls them: the mean Hessian's row
    panel, the Newton–Schulz projection over panels, the blocked factor,
    the first step."""
    from repro_torch import prng
    from repro_torch.core import sharded2d
    from repro_torch.core.collectives import Collectives
    from repro_torch.core.hessian import project_psd_ns_panels
    coll = Collectives(mesh)
    N, d = problem.num_workers, problem.dim
    p = d // coll.size("model")
    r0 = coll.rank("model") * p
    k_init = prng.split(key)[0]
    hkeys = prng.split(prng.fold_in(k_init, 0), N)
    x0 = torch.zeros(d, device="cuda")

    def hessian():
        h = torch.zeros((p, d), device="cuda")
        for i in range(N):
            h = h + problem.worker_hessian_rows(i, x0, hkeys[i], r0, p)
        return coll.all_reduce(h, "data").wait() / N
    h, t_h = sync_time(torch, hessian)
    h_mu, t_ns = sync_time(torch, lambda: project_psd_ns_panels(
        h, float(problem.mu), coll=coll, dim="model", num_iters=60))
    chol, t_f = sync_time(torch, lambda: sharded2d._factor_panels(
        h_mu, coll=coll, dim="model"))
    g = torch.ones(p, device="cuda")
    _, t_s = sync_time(torch, lambda: sharded2d._solve_panels(
        chol, g, coll=coll, dim="model", row_start=r0))
    return {"hessian_panel_s": t_h, "ns_panels_s": t_ns,
            "blocked_factor_s": t_f, "first_step_s": t_s}


def sharded2d_world_of_one(torch, rt, report, launches):
    """Leg (a): NCCL at world size 1 in this process, a ("data", "model")
    = (1, 1) mesh.  Each run of ``SHARDED2D_RUNS`` on engine="sharded2d"
    against the scan run of the same problem and key (projection="ns"
    for dense); overlap bit-equal to sequential; K2 launched once a round
    on the diag runs and never on the dense ones; the dense runs'
    largest tensor within one panel; every log within the contract."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import prng
    from repro_torch.analysis import LargestTensors
    T, key = 30, prng.PRNGKey(1)
    pol = rt.PolicyConfig(keep_prob=0.5, tau_star=1)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        sharded_store("nccl2d"), 1), rank=0, world_size=1)
    out = {}
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        small = rt.make_quadratic(prng.PRNGKey(0), num_workers=4, dim=64,
                                  num_regions=4, device="cuda")
        rt.run(small, key, engine="sharded2d", mesh=mesh, num_rounds=2,
               num_regions=4)               # untimed: NCCL's first calls
        for kind in ("dense", "diag"):
            problem = (dense_problem if kind == "dense" else diag_problem)(
                torch, rt)
            base = dict(num_rounds=T, num_regions=64, curvature=kind,
                        policy=pol)
            proj = {"projection": "ns"} if kind == "dense" else {}
            scan_init = init_seconds(torch, lambda: rt.run(
                problem, key, **{**base, **proj, "num_rounds": 0}))
            if kind == "dense":
                # one round, untimed: the memory recorder, and the first
                # 2-D run at this size pays one-time costs (seconds on an H100)
                torch.cuda.reset_peak_memory_stats()
                with LargestTensors() as rec:
                    rt.run(problem, key, engine="sharded2d", mesh=mesh,
                           **{**base, "num_rounds": 1})
                mem = memory_row(torch, rt, rec, base, problem.dim, 1,
                                 "sharded2d dense")
                split = dense2d_init_split(torch, problem, mesh, key)
                # one round, timed: the init and a round
                _, one_s = sync_time(torch, lambda: rt.run(
                    problem, key, engine="sharded2d", mesh=mesh,
                    **{**base, "num_rounds": 1}))
            seq = None
            for label, pk, kw, tol, k2 in SHARDED2D_RUNS:
                if pk != kind:
                    continue
                opts = {**base, **kw}
                scan_kw = {k: v for k, v in {**opts, **proj}.items()
                           if k != "overlap"}
                scan, scan_s = sync_time(torch, lambda: rt.run(
                    problem, key, **scan_kw))
                if label == "dense_int8":
                    torch.cuda.reset_peak_memory_stats()
                    with LargestTensors() as rec:
                        sh, sh_s, counts = counted(torch, launches, lambda: (
                            rt.run(problem, key, engine="sharded2d",
                                   mesh=mesh, **opts)))
                    row_mem = memory_row(torch, rt, rec, opts, problem.dim,
                                         1, f"sharded2d {label}")
                else:
                    sh, sh_s, counts = counted(torch, launches, lambda: (
                        rt.run(problem, key, engine="sharded2d", mesh=mesh,
                               **opts)))
                    row_mem = mem if label == "dense" else None
                check_finite(torch, sh)
                if counts != {**ZERO, "ranl_update": k2}:
                    raise AssertionError(f"sharded2d {label}: launches "
                                         f"{counts}, expected {k2} of K2")
                err, err1 = sharded_vs_scan(
                    torch, sh, scan, f"sharded2d {label} vs scan", tol,
                    SHARDED2D_X1_TOL if kind == "dense" else 0.0)
                if kw.get("overlap"):
                    for f in ("xs",) + INT_TRACES:
                        if not torch.equal(getattr(sh, f), getattr(seq, f)):
                            raise AssertionError(f"sharded2d {label}: {f} "
                                                 f"differs from sequential")
                elif not kw:
                    seq = sh
                cc = contract_counts(rt, sh, problem.dim,
                                     f"sharded2d {label}", "sharded2d",
                                     {"n_data": 1, "n_model": 1}, **opts)
                if kind == "dense":
                    rounds_ms = (sh_s - one_s) / (T - 1) * 1e3
                    init_s = one_s - rounds_ms / 1e3
                else:
                    init_s = scan_init        # the same replicated init
                    rounds_ms = (sh_s - init_s) / T * 1e3
                out[label] = {
                    "round_ms": rounds_ms,
                    "scan_round_ms": (scan_s - scan_init) / T * 1e3,
                    "init_s": init_s, "scan_init_s": scan_init,
                    "xs_vs_scan_max_rel": err, "x1_vs_scan_max_rel": err1,
                    "xs_tol": tol, "launches": counts, "collectives": cc,
                    "memory": row_mem,
                    "timed_with_recorder": label == "dense_int8"}
                if label == "dense":
                    out[label]["init_split"] = split
                log(f"sharded2d (a) NCCL x1 {label}: "
                    f"{out[label]['round_ms']:.3f} ms/round against "
                    f"{out[label]['scan_round_ms']:.3f} on the scan engine; "
                    f"init {init_s:.3f} s against {scan_init:.3f} "
                    f"({report.get('nvidia_smi')}); traces equal, x1 "
                    f"{err1:.3e}, x2..xT {err:.3e} x max |x| (tol {tol}); "
                    f"launches {counts}; collectives {cc}; memory {row_mem}")
            if kind == "dense":
                log(f"sharded2d (a) dense init split: {split}")
            del problem
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


def _sharded2d_rank(rank, store, out_dir):
    """Leg (b)'s rank ``rank`` of 2, on the one card over gloo: each run
    of ``SHARDED2D_RANK_RUNS`` on engine="sharded2d", its launches
    counted (set to 0 just before, read just after) and, dense, its
    largest tensor recorded; rank 0 then runs the same on the scan
    engine.  Results, on the host, go to ``out_dir/rank2d<r>.pt``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import repro_torch as rt
    from repro_torch import prng
    from repro_torch.analysis import LargestTensors
    from repro_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        key, T = prng.PRNGKey(1), 30
        problems = {}
        out = {}
        for label, kind, shape, _, _ in SHARDED2D_RANK_RUNS:
            if kind not in problems:
                problems.clear()
                torch.cuda.empty_cache()
                problems[kind] = (diag_problem if kind == "diag"
                                  else dense2048_problem)(torch, rt)
            problem = problems[kind]
            curv = "diag" if kind == "diag" else "dense"
            mesh = init_device_mesh("cuda", shape,
                                    mesh_dim_names=("data", "model"))
            opts = dict(num_rounds=T, num_regions=64, curvature=curv,
                        policy=rt.PolicyConfig(keep_prob=0.5, tau_star=1))
            proj = {"projection": "ns"} if curv == "dense" else {}
            init_s = init_seconds(torch, lambda: rt.run(
                problem, key, **{**opts, **proj, "num_rounds": 0}))
            if rank == 0:                   # untimed: the scan's kernels
                rt.run(problem, key, **{**opts, **proj, "num_rounds": 3})
            dist.barrier()
            _, one_s = sync_time(torch, lambda: rt.run(
                problem, key, engine="sharded2d", mesh=mesh,
                **{**opts, "num_rounds": 1}))
            dist.barrier()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            with (LargestTensors() if curv == "dense"
                  else contextlib.nullcontext()) as rec:
                res, secs = sync_time(torch, lambda: rt.run(
                    problem, key, engine="sharded2d", mesh=mesh, **opts))
            row = {"result": on_host(res), "seconds": secs,
                   "one_round_s": one_s, "init_s": init_s,
                   "launches": dict(LAUNCHES),
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "largest": None if rec is None else (rec.max_bytes,
                                                        rec.max_op)}
            if rank == 0:
                scan, row["scan_seconds"] = sync_time(
                    torch, lambda: rt.run(problem, key, **opts, **proj))
                row["scan"] = on_host(scan)
            dist.barrier()
            out[label] = row
        torch.save(out, os.path.join(out_dir, f"rank2d{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sharded2d_two_ranks(torch, rt, report, launches):
    """Leg (b): two ranks on the one card over gloo (``torch.
    multiprocessing`` spawn, joined within 600 s).  Each run held to the
    scan run (``SHARDED2D_RANK_RUNS``), both ranks' results equal, both
    logs within the contract, K2's launches on each rank as listed (they
    are added to the main-path counts), the dense run's largest tensor
    within one panel."""
    import torch.multiprocessing as mp
    from repro_torch.analysis import memory_ceiling
    out_dir = os.path.dirname(sharded_store("gloo2d"))
    for r in (0, 1):
        if os.path.exists(os.path.join(out_dir, f"rank2d{r}.pt")):
            os.remove(os.path.join(out_dir, f"rank2d{r}.pt"))
    ctx = mp.start_processes(_sharded2d_rank, args=(
        os.path.join(out_dir, "gloo2d"), out_dir), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.time() + 600
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise AssertionError("the two sharded2d ranks did not finish "
                                 "in 600 s")
    ranks = [torch.load(os.path.join(out_dir, f"rank2d{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    out = {}
    for label, kind, (n_data, n_model), tol, k2 in SHARDED2D_RANK_RUNS:
        a, b = ranks[0][label], ranks[1][label]
        for f in ("xs",) + INT_TRACES:
            if not torch.equal(getattr(a["result"], f),
                               getattr(b["result"], f)):
                raise AssertionError(f"sharded2d (b) {label}: ranks "
                                     f"differ in {f}")
        dense = kind != "diag"
        err, err1 = sharded_vs_scan(
            torch, a["result"], a["scan"], f"sharded2d (b) {label} vs scan",
            tol, SHARDED2D_X1_TOL if dense else 0.0)
        d = a["result"].xs.shape[-1]
        T = a["result"].coverage.shape[0]
        kw = dict(num_rounds=T, num_regions=64,
                  curvature="dense" if dense else "diag")
        cc = [contract_counts(rt, r[label]["result"], d,
                              f"sharded2d (b) {label} rank {i}", "sharded2d",
                              {"n_data": n_data, "n_model": n_model}, **kw)
              for i, r in enumerate(ranks)]
        for i, r in enumerate(ranks):
            got = r[label]["launches"]
            if got != {**ZERO, "ranl_update": k2}:
                raise AssertionError(f"sharded2d (b) {label} rank {i}: "
                                     f"launches {got}, expected {k2} of K2")
            for name, v in got.items():
                launches[name] += v
        largest = [r[label]["largest"] for r in ranks]
        if dense:
            ceiling = memory_ceiling("sharded2d", rt.RanlOptions(**kw),
                                     dim=d, n_model=n_model)
            for i, (nbytes, op) in enumerate(largest):
                if not nbytes <= ceiling:
                    raise AssertionError(f"sharded2d (b) {label} rank {i}: "
                                         f"a {nbytes}-byte tensor ({op}) "
                                         f"over the {ceiling}-byte ceiling")
        # dense: rounds from the 30- and the 1-round run (their init is
        # the 2-D one); diag: the replicated init is the scan's
        round_ms = [((r[label]["seconds"] - r[label]["one_round_s"])
                     / (T - 1) if dense else
                     (r[label]["seconds"] - r[label]["init_s"]) / T) * 1e3
                    for r in ranks]
        out[label] = {
            "mesh": {"data": n_data, "model": n_model}, "dim": d,
            "round_ms": round_ms,
            "init_s": [r[label]["one_round_s"] - ms / 1e3
                       for r, ms in zip(ranks, round_ms)],
            "scan_round_ms": (a["scan_seconds"] - a["init_s"]) / T * 1e3,
            "seconds": [r[label]["seconds"] for r in ranks],
            "scan_init_s": a["init_s"], "xs_vs_scan_max_rel": err,
            "x1_vs_scan_max_rel": err1, "xs_tol": tol,
            "launches": [r[label]["launches"] for r in ranks],
            "largest_tensor": [None if x is None else [x[0], list(map(str, x[1]))]
                               for x in largest],
            "max_memory_allocated": [r[label]["max_memory_allocated"]
                                     for r in ranks],
            "collectives": cc[0]}
        log(f"sharded2d (b) gloo x2 on one card {label} "
            f"{out[label]['mesh']}: {out[label]['round_ms'][0]:.3f} / "
            f"{out[label]['round_ms'][1]:.3f} ms/round (ranks 0 / 1), init "
            f"{out[label]['init_s'][0]:.3f} s, against "
            f"{out[label]['scan_round_ms']:.3f} ms/round and init "
            f"{a['init_s']:.3f} s on the scan engine "
            f"({report.get('nvidia_smi')}); ranks equal, traces equal the "
            f"scan run's, x1 {err1:.3e}, x2..xT {err:.3e} x max |x| (tol "
            f"{tol}); launches {out[label]['launches']}; largest tensor "
            f"{out[label]['largest_tensor']}; collectives {cc[0]}")
    return out


def phase_sharded2d(torch, rt, report, launches):
    """The 2-D engine: leg (a), NCCL at world size 1 in this process;
    leg (b), two ranks on the card over gloo."""
    with loopback():
        a = sharded2d_world_of_one(torch, rt, report, launches)
        b = sharded2d_two_ranks(torch, rt, report, launches)
    report["sharded2d"] = {**{f"nccl_x1_{k}": v for k, v in a.items()},
                           **{f"gloo_x2_{k}": v for k, v in b.items()}}


@contextlib.contextmanager
def plain_chol():
    """The low-rank init's updates through the plain loop on the card
    (the dispatch's function swapped, and put back after)."""
    from repro_torch.kernels import ops, ref
    saved = ops.chol_update
    ops.chol_update = ref.chol_update_ref
    try:
        yield
    finally:
        ops.chol_update = saved


def chol_bound(n, r):
    """The update's least time: the lower triangle read and written once,
    V and alpha read; about 6 f32 operations an element and vector."""
    tri = n * (n + 1) // 2
    return bound_row(4 * (2 * tri + r * n + r), 6 * r * tri,
                     PEAK_FLOPS["float32"])


def lowrank_init_split(torch, rt, problem, launches, loop=False):
    """The init of hessian_rank=4 on ``problem`` (a warm run, then a
    counted one), its seconds split between the N − 1 eigh, the N − 1
    updates (the kernel, or the plain loop when ``loop``) and the rest."""
    from repro_torch import prng
    from repro_torch.core import hessian
    from repro_torch.kernels import ops
    split = {"eigh_s": 0.0, "chol_update_s": 0.0,
             "chol_update_device_s": 0.0}

    def timed(fn, key):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            torch.cuda.synchronize()
            split[key] += time.time() - t0
            if key == "chol_update_s":      # the same calls on the card
                split["chol_update_device_s"] += a.elapsed_time(b) * 1e-3
            return out
        return call
    opts = dict(num_regions=64, hessian_rank=LOWRANK["rank"], num_rounds=0)
    with plain_chol() if loop else contextlib.nullcontext():
        if not loop:                    # the loop has nothing to compile
            rt.run(problem, prng.PRNGKey(1), **opts)
        saved = hessian.sym_eigh, ops.chol_update
        hessian.sym_eigh = timed(hessian.sym_eigh, "eigh_s")
        ops.chol_update = timed(ops.chol_update, "chol_update_s")
        try:
            init, init_s, counts = counted(torch, launches, lambda: rt.run(
                problem, prng.PRNGKey(1), **opts))
        finally:
            hessian.sym_eigh, ops.chol_update = saved
    return init, {"init_s": init_s, **split,
                  "rest_s": init_s - split["eigh_s"] - split["chol_update_s"],
                  "launches": counts}


def loop_init(torch, rt):
    """``--loop-init``: the init of hessian_rank=4 on the dense main-path
    problem (N = 32, d = 8192) through the plain loop on the card, timed
    once and split as phase_lowrank splits the kernel's, one JSON line."""
    problem = dense_problem(torch, rt)
    init, row = lowrank_init_split(torch, rt, problem, dict(ZERO), loop=True)
    check_finite(torch, init)
    if row["launches"] != ZERO:
        raise AssertionError(f"loop init launched {row['launches']}")
    log(json.dumps({"loop_init_d8192": row}))


def phase_lowrank(torch, rt, report, launches):
    """The low-rank init (``hessian_rank``) and its kernel, chol_update.

    1. The kernel against the plain loop on the card: one worker's rank-4
       fold at the main path's d = 8192 (L the Cholesky factor of a worker
       Hessian of the dense problem), and the whole factor at d = 512;
       within ``CHOL_RTOL`` x max |L|.  Times: the kernel (a CUDA graph of
       calls), the loop (one call), a refactorization from scratch.
    2. hessian_rank=4 on the scan engine at d = 512 (``LOWRANK``), card
       against host: integer traces equal, xs within 1e-4 x max |x|; a
       counted run, chol_update once per worker (N − 1 launches).
    3. The init of hessian_rank=4 on the dense main-path problem (N = 32,
       d = 8192), counted: N − 1 launches, the seconds split between the
       N − 1 eigh, the N − 1 updates and the rest."""
    from repro_torch import prng
    from repro_torch.core import compression
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import chol_update as CU
    from repro_torch.kernels import ref
    r = LOWRANK["rank"]
    problem = dense_problem(torch, rt)
    d = problem.dim
    gen = torch.Generator(device="cuda").manual_seed(11)
    L = torch.linalg.cholesky(problem.A[0]).mT.contiguous().mT
    V = torch.randn(r, d, device="cuda", generator=gen) / d ** 0.5
    alpha = torch.rand(r, device="cuda", generator=gen) * 10.0
    before = LAUNCHES["chol_update"]
    got = CU.chol_update(L, V, alpha)
    per_call = LAUNCHES["chol_update"] - before
    want, plain_s = sync_time(torch, lambda: ref.chol_update_ref(L, V,
                                                                 alpha))
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not err <= CHOL_RTOL * scale:
        raise AssertionError(f"chol_update d={d}: max |err| {err} > "
                             f"{CHOL_RTOL} x {scale}")
    row = {"max_abs_err": err, "max_rel_err": err / scale,
           "bit_equal_d8192": bool(torch.equal(got, want)),
           "shape": [d, r], "ms": device_ms(torch, CU.chol_update,
                                            [(L, V, alpha)]),
           "plain_ms": plain_s * 1e3, "library_ms": None,
           "launches_per_call": per_call, **chol_bound(d, r)}
    A = L @ L.mT + (V.mT * alpha) @ V
    torch.linalg.cholesky_ex(A)
    row["refactor_ms"] = statistics.median(
        event_ms(torch, lambda: torch.linalg.cholesky_ex(A)) for _ in range(3))
    row["chain_us_per_column"] = row["ms"] * 1e3 / d
    # the chain alone: the least time the kernel's n dependent columns take
    row["chain_ms"] = device_ms(torch, lambda: CU.chain(d, "cuda"), [()])
    row["ms_over_chain"] = row["ms"] / row["chain_ms"]
    row["ms_over_bound"] = row["ms"] / row["bound_ms"]
    # one call as the init's split times it: the host clock between two
    # synchronisations, so the wrapper's clone of L (a 268 MB copy), its
    # scratch allocations and fills and the launches count beside the
    # kernel
    row["host_call_ms"] = statistics.median(
        sync_time(torch, lambda: CU.chol_update(L, V, alpha))[1] * 1e3
        for _ in range(5))
    row["clone_ms"] = statistics.median(
        event_ms(torch, lambda: L.clone()) for _ in range(5))
    row["event_call_ms"] = statistics.median(
        event_ms(torch, lambda: CU.chol_update(L, V, alpha))
        for _ in range(5))
    del got, want, A
    log(f"chol_update at d={d}, rank {r}: {row['ms']:.4f} ms on the card "
        f"({row['chain_us_per_column']:.3f} us a column), plain loop "
        f"{row['plain_ms']:.1f} ms, cholesky of the updated matrix "
        f"{row['refactor_ms']:.3f} ms; bound {row['bound_ms']:.5f} ms by "
        f"{row['bound_by']} ({row['ms_over_bound']:.1f}x), the chain alone "
        f"{row['chain_ms']:.4f} ms ({row['ms_over_chain']:.2f}x); one call "
        f"by the host clock {row['host_call_ms']:.3f} ms, by CUDA events "
        f"{row['event_call_ms']:.3f} ms, of which the clone of L "
        f"{row['clone_ms']:.3f} ms; max |err| {err:.3e} x max |L| "
        f"{scale:.3e} (bit-equal: {row['bit_equal_d8192']})")

    # 3. the main path's init at d = 8192, its time split
    n = problem.num_workers
    init, init_row = lowrank_init_split(torch, rt, problem, launches)
    if init_row["launches"] != {**ZERO, "chol_update": n - 1}:
        raise AssertionError(f"lowrank init d={d} launches "
                             f"{init_row['launches']}")
    check_finite(torch, init)
    init_row["loop_fold_s"] = plain_s
    init_row["chol_update_s_per_call"] = init_row["chol_update_s"] / (n - 1)
    log(f"lowrank_init N={n} d={d} rank {r}: init {init_row['init_s']:.2f} "
        f"s = {init_row['eigh_s']:.2f} s in {n - 1} eigh + "
        f"{init_row['chol_update_s']:.3f} s in {n - 1} chol_update calls "
        f"({init_row['chol_update_s_per_call'] * 1e3:.3f} ms a call by the "
        f"host clock, {init_row['chol_update_device_s'] / (n - 1) * 1e3:.3f}"
        f" ms between CUDA events around it, against "
        f"{row['host_call_ms']:.3f} ms for one call alone and "
        f"{row['ms']:.4f} ms for the kernel) + "
        f"{init_row['rest_s']:.2f} s else (one fold through the plain loop "
        f"takes {plain_s:.2f} s; `chip_smoke.py --loop-init` times the "
        f"whole init through the loop)")
    del problem, L, V, init
    torch.cuda.empty_cache()

    # 2. and the d = 512 factor: kernel against loop, card against host
    n, d, r = LOWRANK["num_workers"], LOWRANK["dim"], LOWRANK["rank"]
    small = rt.make_quadratic(prng.PRNGKey(5), num_workers=n, dim=d,
                              kappa=100.0, coupling=0.0, num_regions=16,
                              grad_noise=0.1, device="cuda")
    x0 = torch.zeros(d, device="cuda")
    hkeys = prng.split(prng.fold_in(prng.split(prng.PRNGKey(6))[0], 0), n)
    fac = compression.lowrank_hmu_factor(small, x0, hkeys, small.mu, rank=r)
    with plain_chol():
        fac_plain, loop_s = sync_time(torch, lambda: compression
                                      .lowrank_hmu_factor(small, x0, hkeys,
                                                          small.mu, rank=r))
    fscale = fac_plain.abs().max().item()
    ferr = (fac - fac_plain).abs().max().item()
    if not ferr <= CHOL_RTOL * fscale:
        raise AssertionError(f"lowrank factor d={d}: kernel vs loop max "
                             f"|err| {ferr} > {CHOL_RTOL} x {fscale}")
    row["max_abs_err"] = max(row["max_abs_err"], ferr)
    kw = dict(num_regions=16, hessian_rank=r)
    init_s = sync_time(torch, lambda: rt.run(
        small, prng.PRNGKey(6), num_rounds=0, **kw))[1]
    card, _, counts = counted(torch, launches, lambda: rt.run(
        small, prng.PRNGKey(6), num_rounds=10, **kw))
    if counts != {**ZERO, "chol_update": n - 1, "region_aggregate": 10}:
        raise AssertionError(f"lowrank d={d} launches {counts}")
    check_finite(torch, card)
    t0 = time.time()
    host = rt.run(on_host(small), prng.PRNGKey(6), device="cpu",
                  num_rounds=10, **kw)
    host_s = time.time() - t0
    same_traces(torch, card, host, "lowrank_init card vs host")
    scale = host.xs.abs().max().item()
    err = (card.xs.cpu() - host.xs).abs().max().item()
    if not err <= 1e-4 * scale:
        raise AssertionError(f"lowrank_init card vs host: xs max |err| "
                             f"{err} > 1e-4 x {scale}")
    report["chol_update"] = row
    report["lowrank_init"] = {
        "num_workers": n, "dim": d, "rank": r, "init_s": init_s,
        "loop_init_s": loop_s, "factor_vs_loop_max_rel": ferr / fscale,
        "host_run_s": host_s, "xs_vs_host_max_rel": err / scale,
        "launches": counts, "init_d8192": init_row}
    log(f"lowrank_init N={n} d={d} rank {r}: init {init_s:.3f} s on the "
        f"card (the factor through the plain loop {loop_s:.2f} s; kernel "
        f"vs loop max |err| {ferr / fscale:.3e} x max |L|); host run "
        f"{host_s:.2f} s; card vs host xs max |err| {err / scale:.3e} x "
        f"max |x|; launches {counts}")


def grad_inputs(torch, kernel, shape, dtype, gen):
    """One input set of a backward kernel: K3's (q, k, v, o, do, lse) with
    o and lse the forward kernel's output and log-sum-exp (a tree whose
    forward keeps no lse gives none), or K4's (r, k, v, w, u, state, dy,
    ds) with a random state and random gradients of y and the final
    state."""
    from repro_torch.kernels.flash_attention import flash_attention
    if kernel == "flash_attention":
        q, k, v = attn_inputs(torch, *shape, dtype, gen)
        do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
        if "return_lse" not in inspect.signature(flash_attention).parameters:
            return q, k, v, flash_attention(q, k, v), do, None
        o, lse = flash_attention(q, k, v, return_lse=True)
        return q, k, v, o, do, lse
    b, s, h, hd = shape
    dy = torch.randn(b, s, h, hd, device="cuda", generator=gen)
    ds = torch.randn(b, h, hd, hd, device="cuda", generator=gen)
    return (*wkv_inputs(torch, *shape, dtype, gen, True), dy, ds)


def attn_bwd_bound(b, s, h, kv, hd, window, dtype):
    """q, o, do read and dq written (H heads), k, v read and dk, dv
    written (KV heads), once; the products Q Kᵀ, dO Vᵀ, dV, dK, dQ over
    the causal pairs."""
    es = 2 if dtype == "bfloat16" else 4
    nbytes = es * hd * b * s * (4 * h + 4 * kv)
    flops = 10 * hd * attn_pairs(s, window) * b * h
    return nbytes, flops, PEAK_FLOPS[dtype]


def wkv_bwd_bound(b, s, h, hd, dtype):
    """r, k, v (dtype), w, dy (f32) read and dr, dk, dv (dtype), dw (f32)
    written, once, with u, du, the state, ds and dstate; a step and head
    rebuilds S (2 hd² flops) and takes dS, dr, dk, dv and dw (2 hd²
    each)."""
    es = 2 if dtype == "bfloat16" else 4
    n = b * s * h * hd
    nbytes = (6 * es + 3 * 4) * n + 2 * es * h * hd + 3 * 4 * b * h * hd * hd
    flops = 12 * hd * hd * b * s * h
    return nbytes, flops, PEAK_FLOPS["float32"]


def attn_bwd(q, k, v, o, do, lse):
    """K3's backward kernel as ``ops``' backward calls it: with the
    forward's log-sum-exp (where the tree's forward keeps one)."""
    from repro_torch.kernels import flash_attention as fa
    if lse is None:
        return fa.flash_attention_bwd(q, k, v, o, do)
    return fa.flash_attention_bwd(q, k, v, o, do, lse=lse)


def attn_bwd_plain(q, k, v, o, do, lse):
    """The plain backward, which rebuilds L itself."""
    from repro_torch.kernels import ref
    return ref.flash_attention_bwd_ref(q, k, v, o, do)


def bwd_calls(kernel):
    """(the backward kernel, its plain version) on ``grad_inputs``' sets."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_wkv as wkv
    if kernel == "flash_attention":
        return attn_bwd, attn_bwd_plain
    return wkv.rwkv_wkv_bwd, ref.rwkv_wkv_bwd_ref


def stream_ms(torch, fn, arg_sets):
    """Time on the card of one call that a CUDA graph cannot capture
    (autograd runs a backward on the stream of its forward): back-to-back
    calls cycling through ``arg_sets`` between two CUDA events, the
    median over ``TIMED_CALLS`` such runs, per call."""
    calls = max(len(arg_sets), 4)
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()

    def run():
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
    return statistics.median(event_ms(torch, run) / calls
                             for _ in range(TIMED_CALLS))


def library_attention_bwd_ms(torch, sets):
    """The backward of ``scaled_dot_product_attention`` through autograd
    on the same inputs: ``torch.autograd.grad`` over a retained graph,
    timed by ``stream_ms``."""
    import torch.nn.functional as F
    prepared = []
    for q, k, v, _, do, *_ in sets:
        qq, kk, vv = (t.detach().transpose(1, 2).requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True,
                                             enable_gqa=True)
        prepared.append((out, qq, kk, vv, do.transpose(1, 2)))

    def bwd(out, qq, kk, vv, g):
        return torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True)
    return stream_ms(torch, bwd, prepared)


def bwd_against_plain(torch, kernel, shape, dtype, gen, tol):
    """The backward kernel against its plain version on one input set:
    each gradient within tol x (max |grad| + |grad|), one launch a call,
    two calls bit-equal; K3's kernel also without the forward's L (its
    pre-pass rebuilds it), held to the same tolerance.  Returns the worst
    |err| / max |grad| and the worst |err|."""
    from repro_torch.kernels import LAUNCHES
    name = f"{kernel}_bwd"
    fn, plain = bwd_calls(kernel)
    args = grad_inputs(torch, kernel, shape, dtype, gen)
    before = LAUNCHES[name]
    got = fn(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    if LAUNCHES[name] != before + 2:
        raise AssertionError(f"{name} {shape}: {LAUNCHES[name] - before} "
                             f"launches in two calls")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} {shape} {dtype}: two calls differ")
    want = plain(*args)
    runs = [got]
    if kernel == "flash_attention" and args[-1] is not None:
        runs.append(fn(*args[:-1], None))
    worst = worst_abs = 0.0
    for run in runs:
        for i, (g, w) in enumerate(zip(run, want)):
            scale = max(w.float().abs().max().item(), 1e-30)
            e = (g.float() - w.float()).abs().max().item()
            if g.dtype != w.dtype or not torch.allclose(
                    g.float(), w.float(), rtol=tol, atol=tol * scale):
                raise AssertionError(f"{name} {shape} {dtype} gradient {i}"
                                     f": max |err| {e} x max |grad| {scale}")
            worst, worst_abs = max(worst, e / scale), max(worst_abs, e)
    return worst, worst_abs


def phase_train_grad(torch, report):
    """The backward kernels of K3 and K4 against their plain versions at
    the prefill and train shapes, in f32 and bf16, bit-reproducible, with
    K3's route (``tc`` or ``simt``) for each; their times at the train
    shape in f32 (the rows' numbers) and at the prefill shape in bf16;
    then gradients through ops.flash_attention / ops.rwkv_wkv on the card
    against autograd through the plain forwards.  K3's backward takes the
    forward's log-sum-exp, as ``ops``' backward hands it over, and is timed
    as SDPA's backward is, by ``stream_ms`` (CUDA events around
    back-to-back calls; autograd runs SDPA's backward on the stream of its
    forward, which a CUDA graph cannot capture); its CUDA-graph replay
    time stands beside it as ``graph_ms``.  A gradient has its input's
    type, so K4's bf16 gradients are f32 sums rounded to bf16, where two
    may land one step apart (``BF16_STEP``)."""
    from repro_torch.kernels import LAUNCHES, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv_wkv as wkv
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    for kernel, shapes in GRAD_SHAPES.items():
        name = f"{kernel}_bwd"
        row = out[name] = {"checks": {}}
        for label, shape in shapes.items():
            for dtype in (f32, bf16):
                tol = 2e-4 if dtype == f32 else (
                    2e-2 if kernel == "flash_attention" else BF16_STEP)
                err, err_abs = bwd_against_plain(torch, kernel, shape, dtype,
                                                 gen, tol)
                dt = str(dtype).split(".")[-1]
                body = (fa.route(dtype, shape[-1])
                        if kernel == "flash_attention" else "cuda")
                row["checks"][f"{label} {dt}"] = {
                    "shape": list(shape), "max_rel_err": err,
                    "max_abs_err": err_abs, "tol": tol, "body": body}
                log(f"{name} at {shape} {dt} ({body} body): equals its "
                    f"plain version within {err:.3e} x max |grad| (tol "
                    f"{tol}); two calls bit-equal; one launch a call")
                torch.cuda.empty_cache()
        row["max_abs_err"] = max(c["max_abs_err"]
                                 for c in row["checks"].values())
        row["max_rel_err"] = max(c["max_rel_err"]
                                 for c in row["checks"].values())
        fn, plain = bwd_calls(kernel)
        attn = kernel == "flash_attention"
        for label, dtype in (("", f32), ("_prefill", bf16)):
            shape = shapes["train" if label == "" else "prefill"]
            dt = str(dtype).split(".")[-1]
            nb, fl, peak = (attn_bwd_bound(*shape, 0, dt) if attn
                            else wkv_bwd_bound(*shape, dt))
            sets = [grad_inputs(torch, kernel, shape, dtype, gen)
                    for _ in range(max(2, -(-2 * L2_BYTES // nb)))]
            b_row = bound_row(nb, fl, peak)
            row.update({f"ms{label}": (stream_ms if attn else device_ms)(
                            torch, fn, sets),
                        f"plain_ms{label}": device_ms(torch, plain,
                                                      sets[:2]),
                        f"shape{label}": list(shape), f"dtype{label}": dt,
                        **{f"{k}{label}": v for k, v in b_row.items()}})
            if attn:
                row[f"graph_ms{label}"] = device_ms(torch, fn, sets)
                row[f"body{label}"] = fa.route(dtype, shape[-1])
            row[f"library_ms{label}"] = (
                library_attention_bwd_ms(torch, sets) if attn else None)
            if not attn:
                row[f"forward_ms{label}"] = device_ms(
                    torch, wkv.rwkv_wkv, [a[:6] for a in sets])
                row[f"geometry{label}"] = wkv.wkv_bwd_geometry(
                    shape[-1], dtype)._asdict()
            log(f"{name} at {shape} {dt}"
                + (f" ({row[f'body{label}']} body)" if attn else "")
                + f": on the card {row[f'ms{label}']:.5f} ms"
                + (f" (CUDA-graph replays {row[f'graph_ms{label}']:.5f} ms)"
                   if attn else "")
                + f", plain {row[f'plain_ms{label}']:.5f} ms, library "
                f"{row[f'library_ms{label}']} ms over {len(sets)} input "
                f"sets; bound {b_row['bound_ms']:.5f} ms by "
                f"{b_row['bound_by']} ({nb} B, {fl} flop)"
                + ("" if attn else
                   f"; K4's forward on the same inputs "
                   f"{row[f'forward_ms{label}']:.5f} ms; geometry "
                   f"{row[f'geometry{label}']}"))
            del sets
            torch.cuda.empty_cache()
        if not attn:
            row["ptxas"] = {k: v for k, v in report.get("build", {}).get(
                "bwd_ptxas", {}).get(name, {}).items() if "wkv_bwd_kernel" in k}
            log(f"{name} registers and spills (-Xptxas -v): {row['ptxas']}")
        report[name] = row

    # the dispatch on the card: the forward kernel and the backward
    # kernel, one launch each, against autograd through the plain forwards
    # (K3 in f32 takes the simt body, in bf16 the tc body)
    cases = (("flash_attention", ops.flash_attention, ref.flash_attention_ref,
              lambda: attn_inputs(torch, *GRAD_SHAPES["flash_attention"][
                  "train"], f32, gen), 2e-4),
             ("flash_attention", ops.flash_attention, ref.flash_attention_ref,
              lambda: attn_inputs(torch, *GRAD_SHAPES["flash_attention"][
                  "train"], bf16, gen), 2e-2),
             ("rwkv_wkv", ops.rwkv_wkv, ref.rwkv_wkv_ref,
              lambda: wkv_inputs(torch, *GRAD_SHAPES["rwkv_wkv"]["train"],
                                 f32, gen, True), 2e-4))
    for name, fn, twin, make, tol in cases:
        args = [a.detach().requires_grad_(True) for a in make()]

        def grads(f):
            for a in args:
                a.grad = None
            o = f(*args)
            o = o if isinstance(o, tuple) else (o,)
            sum(0.5 * (t.float() ** 2).sum() for t in o).backward()
            return [a.grad.clone() for a in args]
        before = dict(LAUNCHES)
        got, secs = sync_time(torch, lambda: grads(fn))
        moved = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k]}
        if moved != {name: 1, f"{name}_bwd": 1}:
            raise AssertionError(f"train_grad ops.{name}: launches {moved}")
        want, twin_s = sync_time(torch, lambda: grads(twin))
        worst = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            scale = w.float().abs().max().item()
            e = (g.float() - w.float()).abs().max().item()
            if not torch.allclose(g.float(), w.float(), rtol=tol,
                                  atol=tol * scale):
                raise AssertionError(f"train_grad ops.{name} input {i}: "
                                     f"max |err| {e} x max |grad| {scale}")
            worst = max(worst, e / scale)
        dt = str(args[0].dtype).split(".")[-1]
        out[f"ops_{name}" + ("" if dt == "float32" else f"_{dt}")] = {
            "shape": list(args[0].shape), "dtype": dt, "max_rel_err": worst,
            "tol": tol, "seconds": secs, "autograd_seconds": twin_s}
        log(f"train_grad ops.{name} at {tuple(args[0].shape)} {dt}: "
            f"gradients of {len(args)} inputs (forward and backward "
            f"kernels) equal autograd through the plain forward within "
            f"{worst:.3e} x max |grad|; forward + backward {secs:.3f} s "
            f"(through the plain forward {twin_s:.3f} s)")
        del args, got, want
        torch.cuda.empty_cache()
    report["train_grad"] = {k: v for k, v in out.items()
                            if k.startswith("ops_")}


def sass_counts(build, name="flash_attention"):
    """Counts of the tensor-core (HGMMA) and TMA-load (UTMALDG) instructions
    in one built library (K3's forward or backward), from ``cuobjdump
    -sass`` beside ``nvcc``; None where the toolkit has no ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return None
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "UTMALDG")}


def ptxas_usage(text):
    """{entry function: {"registers", "spill_stores", "spill_loads"}} from
    the ``-Xptxas -v`` lines of one build log."""
    usage, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def wkv_instances(usage):
    """K4's instances by (kernel, type, hd, state rows and columns per
    lane) from ``ptxas_usage``: ``wkv_kernel`` (chunks of steps) and
    ``wkv_decode`` (one step)."""
    out = {}
    for name, u in usage.items():
        m = re.search(r"wkv_(kernel|decode)I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)"
                      r"ELi(\d+)E", name)
        if m:
            dt = "bfloat16" if m.group(2) != "f" else "float32"
            out[f"{m.group(1)} {dt} hd {m.group(3)} rows {m.group(4)} cols "
                f"{m.group(5)}"] = u
    return out


def phase_build(report):
    """nvcc on each CUDA source, all started together."""
    from repro_torch.kernels import build
    t0 = time.time()
    logs = build.build_all()
    secs = time.time() - t0
    report["build"] = {"seconds": secs, "rwkv_wkv_ptxas": wkv_instances(
        ptxas_usage(logs.get("rwkv_wkv", ""))), "bwd_ptxas": {
            name: ptxas_usage(logs.get(name, ""))
            for name in ("flash_attention_bwd", "rwkv_wkv_bwd")}}
    log(f"build: nvcc on {len(logs)} sources in {secs:.2f} s "
        f"(nvcc {build.nvcc()})")
    for name, text in logs.items():
        for line in text.splitlines():
            if ("Compiling entry" in line or "Used" in line or "spill" in line
                    or "arning" in line):
                log(f"  {name}: {line.strip()}")
    for name in ("flash_attention", "flash_attention_bwd"):
        counts = sass_counts(build, name)
        report["build"][f"{name}_sass"] = counts
        log(f"{name} library, cuobjdump -sass: " + (
            "cuobjdump not found" if counts is None else
            f"{counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG "
            f"instructions"))
        if counts is not None and not (counts["HGMMA"] and
                                       counts["UTMALDG"]):
            raise AssertionError(f"{name}: no HGMMA or UTMALDG in its SASS")


# --------------------------------------------------------------------------
# K3 / K4 against their plain twins
# --------------------------------------------------------------------------

def attn_inputs(torch, b, s, h, kv, hd, dtype, gen):
    return tuple(torch.randn(b, s, n, hd, device="cuda", generator=gen)
                 .to(dtype) for n in (h, kv, kv))


def wkv_inputs(torch, b, s, h, hd, dtype, gen, state=False):
    """The serve path's inputs: r, k, v, u in ``dtype``, the Finch decay
    w = exp(-exp(-6 + 0.5 z)) in f32, and a zero or random state."""
    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    r, k, v = (rnd(b, s, h, hd).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(-6.0 + 0.5 * rnd(b, s, h, hd)))
    u = (0.5 * rnd(h, hd)).to(dtype)
    s0 = (0.1 * rnd(b, h, hd, hd)) if state else torch.zeros(
        b, h, hd, hd, device="cuda")
    return r, k, v, w, u, s0


def attn_pairs(s, window):
    """(q, k) pairs the causal (and windowed) mask keeps for one head."""
    if not window:
        return s * (s + 1) // 2
    return sum(min(q + 1, window) for q in range(s))


def attn_bound(b, s, h, kv, hd, window, dtype):
    es = 2 if dtype == "bfloat16" else 4
    nbytes = es * hd * b * s * (2 * h + 2 * kv)          # q, o, k, v once
    flops = 4 * hd * attn_pairs(s, window) * b * h       # QKᵀ and PV
    return nbytes, flops, PEAK_FLOPS[dtype]


def wkv_bound(b, s, h, hd, dtype):
    es = 2 if dtype == "bfloat16" else 4
    n = b * s * h * hd
    nbytes = 3 * es * n + 4 * n + 4 * n + es * h * hd + 2 * 4 * b * h * hd * hd
    flops = 5 * hd * hd * b * s * h        # y += r·S, S = w·S + k·v
    return nbytes, flops, PEAK_FLOPS["float32"]


def bound_row(nbytes, flops, peak):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops, "bound_ms_bytes": by_bytes,
            "bound_ms_ops": by_ops}


def library_attention_ms(torch, sets):
    """One PyTorch call that computes K3's function, timed like the
    kernel: ``scaled_dot_product_attention`` on (B, H, S, hd) views."""
    import torch.nn.functional as F

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
    out = sdpa(*sets[0])
    return device_ms(torch, sdpa, sets), out


def wkv_geometry(torch, b, s, h, hd):
    """K4's launch geometry at (b, s, h, hd) on this card, with its warps
    per SM."""
    from repro_torch.kernels.rwkv_wkv import launch_geometry
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geo = launch_geometry(b, h, hd, sms)._asdict()
    geo["warps_per_sm"] = geo["blocks"] * geo["warps"] / sms
    return geo


def wkv_decode_equals_one_run(torch, rwkv_wkv, gen):
    """The serve path's K4 calls, a prefill of 1024 steps and then 31
    decode steps of one each from the state before, give bit for bit what
    one K4 run over the 1055 steps gives (the same tile and the same sums
    per step).  Returns the number of steps compared."""
    b, p, g, h, hd = 4, 1024, 31, 40, 64
    args = wkv_inputs(torch, b, p + g, h, hd, torch.bfloat16, gen, True)
    y_all, s_all = rwkv_wkv(*args)
    r, k, v, w, u, state = args
    y, state = rwkv_wkv(r[:, :p], k[:, :p], v[:, :p], w[:, :p], u, state)
    ys = [y]
    for t in range(p, p + g):
        y, state = rwkv_wkv(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                            w[:, t:t + 1], u, state)
        ys.append(y)
    torch.cuda.synchronize()
    if not (torch.equal(torch.cat(ys, dim=1), y_all)
            and torch.equal(state, s_all)):
        raise AssertionError("rwkv_wkv: prefill + decode steps differ from "
                             "one run over the same steps")
    log(f"rwkv_wkv: a {p}-step prefill and {g} decode steps equal one run "
        f"over {p + g} steps bit for bit (y and the final state)")
    return p + g


def phase_attn_wkv(torch, report):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import route as attention_route
    from repro_torch.kernels.rwkv_wkv import rwkv_wkv
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32

    worst = {}
    routes = {}
    for (b, s, h, kv, hd, win, dt) in (
            (4, 1024, 24, 8, 128, 0, bf16),      # phi4-mini prefill
            (4, 1000, 24, 8, 128, 0, bf16),      # ragged S
            (3, 77, 24, 8, 128, 0, bf16),        # ragged S below one tile
            (4, 1024, 24, 8, 128, 100, bf16),    # window
            (2, 1000, 16, 4, 64, 0, bf16),       # bf16, hd 64
            (2, 1000, 16, 4, 64, 0, f32),        # f32, hd 64
            (2, 1024, 24, 1, 128, 0, bf16)):     # MQA
        q, k, v = attn_inputs(torch, b, s, h, kv, hd, dt, gen)
        body = attention_route(dt, hd)
        got = flash_attention(q, k, v, causal=True, window=win)
        want = ref.flash_attention_ref(q, k, v, causal=True, window=win)
        torch.cuda.synchronize()
        tol = 2e-4 if dt == f32 else 2e-2
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype != dt or not torch.allclose(got.float(), want.float(),
                                                 rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {(b, s, h, kv, hd)} "
                                 f"window {win} {dt}: max |err| {err}")
        worst[body] = max(worst.get(body, 0.0), err)
        routes[f"{(b, s, h, kv, hd)} window {win} {dt}"] = body
        log(f"flash_attention {(b, s, h, kv, hd)} window {win} {dt}, "
            f"{body} body: matches its plain twin, max |err| {err:.3e} "
            f"(tol {tol})")
        del q, k, v, got, want
    shape = (4, 1024, 24, 8, 128)
    nb, fl, peak = attn_bound(*shape, 0, "bfloat16")
    sets = [attn_inputs(torch, *shape, bf16, gen)
            for _ in range(max(2, -(-2 * L2_BYTES // nb)))]
    lib_ms, lib_out = library_attention_ms(torch, sets)
    lib_err = (lib_out.float() - flash_attention(*sets[0]).float()
               ).abs().max().item()
    row = {"max_abs_err": max(worst.values()), "max_abs_err_by_body": worst,
           "shape": list(shape), "dtype": "bfloat16",
           "body": attention_route(bf16, shape[-1]), "routes": routes,
           "ms": device_ms(torch, lambda q, k, v: flash_attention(q, k, v),
                           sets),
           "plain_ms": device_ms(
               torch, lambda q, k, v: ref.flash_attention_ref(q, k, v), sets),
           "library_ms": lib_ms, "library_max_abs_diff": lib_err,
           **bound_row(nb, fl, peak)}
    row["tflops"] = fl / row["ms"] * 1e-9
    row["library_tflops"] = fl / lib_ms * 1e-9
    report["flash_attention"] = row
    log(f"flash_attention at {shape} bf16, {row['body']} body: on the card "
        f"{row['ms']:.5f} ms ({row['tflops']:.1f} TFLOP/s of causal work, "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound), plain "
        f"{row['plain_ms']:.5f} ms, scaled_dot_product_attention "
        f"{lib_ms:.5f} ms ({row['library_tflops']:.1f} TFLOP/s; max |diff| "
        f"{lib_err:.3e}); bound {row['bound_ms']:.5f} ms by "
        f"{row['bound_by']} ({nb} B, {fl} flop)")
    del sets, lib_out

    worst = 0.0
    for (b, s, h, hd, state, strided) in (
            (4, 1024, 40, 64, False, False),   # rwkv prefill
            (4, 1, 40, 64, True, False),       # decode
            (1, 37, 3, 64, True, False),       # ragged, below one chunk
            (2, 300, 40, 64, True, False),     # ragged over 19 chunks
            (1, 300, 1, 128, True, False),     # B * H = 1 at hd 128
            (2, 300, 40, 64, True, True)):     # r a strided view
        args = wkv_inputs(torch, b, s, h, hd, bf16, gen, state)
        if strided:      # r as the first half of a wider projection
            wide = torch.randn(b, s, h, 2 * hd, device="cuda",
                               generator=gen).to(bf16)
            args = (wide[..., :hd],) + args[1:]
        y, sf = rwkv_wkv(*args)
        y_ref, sf_ref = ref.rwkv_wkv_ref(*args)
        torch.cuda.synchronize()
        err = max((y - y_ref).abs().max().item(),
                  (sf - sf_ref).abs().max().item())
        if not (torch.allclose(y, y_ref, rtol=2e-4, atol=2e-4)
                and torch.allclose(sf, sf_ref, rtol=2e-4, atol=2e-4)):
            raise AssertionError(f"rwkv_wkv {(b, s, h, hd)}: max |err| {err}")
        worst = max(worst, err)
        log(f"rwkv_wkv {(b, s, h, hd)} bf16 r/k/v/u"
            f"{' (r strided)' if strided else ''}, state "
            f"{'random' if state else 'zero'}: matches its plain twin, max "
            f"|err| {err:.3e} (|y| up to {y_ref.abs().max().item():.1f}), "
            f"geometry {wkv_geometry(torch, *args[0].shape)}")
    steps_equal = wkv_decode_equals_one_run(torch, rwkv_wkv, gen)
    geo = wkv_geometry(torch, 4, 1024, 40, 64)
    instance = f"bfloat16 hd 64 rows {geo['rows']} cols {geo['cols']}"
    ptxas = report.get("build", {}).get("rwkv_wkv_ptxas", {})
    row = {"max_abs_err": worst, "dtype": "bfloat16", "library_ms": None,
           "decode_steps_equal_one_run": steps_equal,
           "geometry": geo, "ptxas": ptxas.get(f"kernel {instance}"),
           "ptxas_decode": ptxas.get(f"decode {instance}"),
           "ptxas_instance": instance,
           "max_registers": max((u.get("registers", 0)
                                 for u in ptxas.values()), default=None),
           "spill_bytes": sum(u.get("spill_stores", 0)
                              + u.get("spill_loads", 0)
                              for u in ptxas.values()) if ptxas else None}
    log(f"rwkv_wkv at (4, 1024, 40, 64): geometry {geo}; ptxas {instance}: "
        f"{row['ptxas']} (decode {row['ptxas_decode']}); all instances: max "
        f"{row['max_registers']} "
        f"registers, {row['spill_bytes']} spill bytes")
    for label, shape in (("", (4, 1024, 40, 64)), ("_decode", (4, 1, 40, 64))):
        nb, fl, peak = wkv_bound(*shape, "bfloat16")
        sets = [wkv_inputs(torch, *shape, bf16, gen, True)
                for _ in range(max(2, -(-2 * L2_BYTES // nb)))]
        b_row = bound_row(nb, fl, peak)
        row.update({f"ms{label}": device_ms(torch, rwkv_wkv, sets),
                    f"plain_ms{label}": device_ms(torch, ref.rwkv_wkv_ref,
                                                  sets[:2]),
                    f"shape{label}": list(shape),
                    **{f"{k}{label}": v for k, v in b_row.items()}})
        log(f"rwkv_wkv at {shape}: on the card {row[f'ms{label}']:.5f} ms, "
            f"plain {row[f'plain_ms{label}']:.5f} ms over {len(sets)} input "
            f"sets; bound {b_row['bound_ms']:.5f} ms by {b_row['bound_by']} "
            f"({nb} B, {fl} flop)")
        del sets
    report["rwkv_wkv"] = row
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the serve path at full width
# --------------------------------------------------------------------------

def tree_finite(torch, tree):
    if isinstance(tree, dict):
        return all(tree_finite(torch, v) for v in tree.values())
    return bool(torch.isfinite(tree.float()).all())


def param_count(params):
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, list):
            return sum(walk(v) for v in node)
        return node.numel()
    return walk(params)


def decode_step_profile(torch, step):
    """One decode step, counted and timed apart from the host: the PyTorch
    operators it dispatches (each a kernel launch, less the views and
    the hand-written kernels' ctypes calls), and its time on the card
    alone, as the median replay of a CUDA graph of it (None if it
    cannot be captured)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            return func(*args, **(kwargs or {}))
    with Count():
        step()
    out = {"decode_ops": Count.ops, "decode_device_ms": None}
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()
        torch.cuda.synchronize()
        out["decode_device_ms"] = statistics.median(
            event_ms(torch, graph.replay) for _ in range(10))
        del graph
    except RuntimeError:        # a step that cannot be captured
        traceback.print_exc()
        log("decode step: the CUDA graph could not be captured; its time "
            "on the card is not measured")
    return out


def phase_serve(torch, report, launches, arch, expect):
    """Serve one published config at full width and depth in its dtype:
    a warm-up prefill + decode step (finite logits and cache), then one
    counted ``generate`` of 32 tokens after a 1024-token prompt."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    cfg = get_config(arch)
    B, P, G = 4, 1024, 32
    g = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = sync_time(torch, lambda: init_model(
        cfg, g, getattr(torch, cfg.dtype)))
    n = param_count(params)
    prompt = make_batch(cfg, g, B, P, kind="prefill", pattern="bigram")
    with torch.inference_mode():
        logits, cache = serve.prefill_step(params, prompt, cfg)
        if not (tree_finite(torch, logits) and tree_finite(torch, cache)):
            raise AssertionError(f"{arch}: non-finite prefill output")
        if not cfg.attn_free:
            cache = serve.pad_cache(cache, P + G)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        tok, cache = serve.serve_step(params, cache, tok, P, cfg)
        if not tree_finite(torch, cache):
            raise AssertionError(f"{arch}: non-finite decode cache")
        step = decode_step_profile(torch, lambda: serve.serve_step(
            params, cache, tok, P + 1, cfg))
        del logits, cache
        (toks, times), total_s, counts = counted(
            torch, launches, lambda: serve.generate(params, prompt, cfg, G))
    if counts != {**ZERO, **expect}:
        raise AssertionError(f"{arch}: launches {counts}, expected {expect}")
    if tuple(toks.shape) != (B, G) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        raise AssertionError(f"{arch}: generated tokens out of range")
    row = {"params": n, "dtype": cfg.dtype, "init_s": init_s,
           "prefill_s": times["prefill_s"],
           "decode_ms_per_token": times["decode_s"] / (G - 1) * 1e3,
           "generate_s": total_s, "batch": B, "prompt": P, "gen": G,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "tokens_0": toks[0, :8].tolist(), **step}
    if step["decode_device_ms"] is not None:
        row["decode_idle_share"] = 1 - (step["decode_device_ms"]
                                        / row["decode_ms_per_token"])
    report[f"serve_{arch}"] = row
    log(f"serve {arch}: {n / 1e9:.3f} B params in {cfg.dtype}, init "
        f"{init_s:.2f} s; prefill {B}x{P} {row['prefill_s']:.4f} s; decode "
        f"{row['decode_ms_per_token']:.3f} ms/token (warm, {G - 1} steps); "
        f"peak {row['peak_gb']:.2f} GB; launches {counts}; first tokens "
        f"{row['tokens_0']}")
    log(f"serve {arch} decode step: {step['decode_ops']} aten ops; on the "
        f"card alone (CUDA-graph replay) {step['decode_device_ms']} ms, "
        f"idle share of the eager step {row.get('decode_idle_share')}")
    del params, prompt
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_twins():
    """K3 and K4, forward and backward, and the masked aggregate through
    their plain versions on the card (the wrappers' module functions
    swapped, and put back after)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import masked_aggregate as ma
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_wkv as wkv
    saved = (fa.flash_attention, fa.flash_attention_bwd, wkv.rwkv_wkv,
             wkv.rwkv_wkv_bwd, ma.masked_aggregate)
    (fa.flash_attention, fa.flash_attention_bwd, wkv.rwkv_wkv,
     wkv.rwkv_wkv_bwd, ma.masked_aggregate) = (
        ref.flash_attention_ref, ref.flash_attention_bwd_ref,
        ref.rwkv_wkv_ref, ref.rwkv_wkv_bwd_ref, ref.masked_aggregate_ref)
    try:
        yield
    finally:
        (fa.flash_attention, fa.flash_attention_bwd, wkv.rwkv_wkv,
         wkv.rwkv_wkv_bwd, ma.masked_aggregate) = saved


def serve_gaps(torch, cfg, seed, tol=None):
    """Teacher-forced prefill (192 tokens) then decode to 256 against the
    full forward of the same tokens, f32, batch 2, weights from ``seed``:
    the largest |difference| of the prefill's last logits and of the
    decode steps' logits, and the largest |logit|.  With ``tol`` =
    (prefill, decode), raise where ``allclose`` at that rtol = atol
    fails."""
    from repro_torch.data import make_batch
    from repro_torch.launch.serve import pad_cache
    from repro_torch.models import forward, init_model
    T, Tp = 256, 192
    g = torch.Generator(device="cuda").manual_seed(seed)
    params = init_model(cfg, g, torch.float32)
    toks = make_batch(cfg, g, 2, T, kind="train")["tokens"]
    with torch.inference_mode():
        full, _, _ = forward(params, {"tokens": toks}, cfg, mode="train")
        pre, cache, _ = forward(params, {"tokens": toks[:, :Tp]}, cfg,
                                mode="prefill")
        if not cfg.attn_free:
            cache = pad_cache(cache, T)
        err_p = (pre[:, -1] - full[:, Tp - 1]).abs().max().item()
        if tol and not torch.allclose(pre[:, -1], full[:, Tp - 1],
                                      rtol=tol[0], atol=tol[0]):
            raise AssertionError(f"{cfg.name}: prefill vs full forward max "
                                 f"|err| {err_p}")
        err_d = 0.0
        for t in range(Tp, T):
            logits, cache, _ = forward(
                params, {"tokens": toks[:, t:t + 1], "pos": t}, cfg,
                mode="decode", cache=cache)
            err_d = max(err_d, (logits[:, 0] - full[:, t]).abs().max()
                        .item())
            if tol and not torch.allclose(logits[:, 0], full[:, t],
                                          rtol=tol[1], atol=tol[1]):
                raise AssertionError(f"{cfg.name}: decode at {t} vs full "
                                     f"forward max |err| {err_d}")
        scale = full.abs().max().item()
    del params, full, cache
    torch.cuda.empty_cache()
    return {"prefill_max_abs": err_p, "decode_max_abs": err_d,
            "logits_max_abs": scale}


def phase_serve_consistent(torch, report):
    """The serve path against the full forward in f32 at full width, for
    both configs, seed 2.  Cut to ``CONSISTENT_LAYERS`` layers, within
    2e-3 (prefill) and 3e-3 (decode), as tests/test_models.py holds the
    reference.  At full depth the prefill and the full forward run the
    same projections over 384 and 512 rows, and a decode step over 2,
    which cuBLAS sums in other orders; 32 layers of random weights grow
    those last-bit differences past that bound by an amount that depends
    on the seed, with the kernels' plain twins as with the kernels.  So at
    full depth the kernels' gaps are held against the plain twins' gaps
    on the same weights: at most ``FULL_DEPTH_RATIO`` times them (and
    never held below the 2-layer bounds)."""
    from repro_torch.configs import get_config
    for arch in ("rwkv6-3b", "phi4-mini-3.8b"):
        cfg = get_config(arch)
        cut = serve_gaps(torch, dataclasses.replace(
            cfg, num_layers=CONSISTENT_LAYERS), 2, tol=CONSISTENT_TOL)
        kernel = serve_gaps(torch, cfg, 2)
        with plain_twins():
            plain = serve_gaps(torch, cfg, 2)
        report[f"consistent_{arch}"] = {
            f"{CONSISTENT_LAYERS}_layers": cut, "full_depth": kernel,
            "full_depth_plain_twins": plain}
        log(f"serve_consistent {arch} (f32, full width, {CONSISTENT_LAYERS} "
            f"layers): prefill vs full forward max |err| "
            f"{cut['prefill_max_abs']:.3e}, decode 192..255 max |err| "
            f"{cut['decode_max_abs']:.3e} (|logits| up to "
            f"{cut['logits_max_abs']:.2f})")
        log(f"serve_consistent {arch} (f32, full depth): prefill / decode "
            f"max |err| {kernel['prefill_max_abs']:.3e} / "
            f"{kernel['decode_max_abs']:.3e} with the kernels, "
            f"{plain['prefill_max_abs']:.3e} / {plain['decode_max_abs']:.3e} "
            f"with their plain twins (|logits| up to "
            f"{kernel['logits_max_abs']:.2f})")
        for key, floor in zip(("prefill_max_abs", "decode_max_abs"),
                              CONSISTENT_TOL):
            limit = max(floor, FULL_DEPTH_RATIO * plain[key])
            if kernel[key] > limit:
                raise AssertionError(
                    f"{arch} at full depth: {key} {kernel[key]} with the "
                    f"kernels, past {limit} ({FULL_DEPTH_RATIO} x the plain "
                    f"twins' {plain[key]})")


def consistent_readings(torch, seeds):
    """serve_consistent's full-depth gaps at each seed, with the kernels
    and with their plain twins, one JSON line each; checks nothing."""
    from repro_torch.configs import get_config
    for arch in ("rwkv6-3b", "phi4-mini-3.8b"):
        for seed in seeds:
            kernel = serve_gaps(torch, get_config(arch), seed)
            with plain_twins():
                plain = serve_gaps(torch, get_config(arch), seed)
            log(json.dumps({"arch": arch, "seed": seed, "kernels": kernel,
                            "plain_twins": plain}))


def to_cpu(node):
    if isinstance(node, dict):
        return {k: to_cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_cpu(v) for v in node]
    return node.cpu()


# models_card_vs_host: (arch, tokens).  hymba runs past its 2048-token
# window, so that the window bites in K3; llava's 576 projected patches
# take the first positions, then 128 text tokens.  llama4-scout is left
# out: its 202048 x 5120 vocabulary and 16 experts of d_ff 8192 make the
# host's side too slow.
CARD_VS_HOST = (("rwkv6-3b", 128), ("phi4-mini-3.8b", 128),
                ("hymba-1.5b", 2560), ("phi3.5-moe-42b-a6.6b", 128),
                ("llava-next-mistral-7b", 576 + 128), ("musicgen-medium", 128))


def phase_card_vs_host(torch, report):
    """The same parameters through ``forward`` on the card (kernels) and
    on the CPU (plain twins): full width, 2 layers, batch 1, f32, within
    1e-3 (f32 sums in another order over 1600–14336-wide products, 128
    recurrence or scan steps and, for hymba, 2560)."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model
    for arch, seq in CARD_VS_HOST:
        cfg = dataclasses.replace(get_config(arch), num_layers=2)
        g = torch.Generator(device="cuda").manual_seed(3)
        params = init_model(cfg, g, torch.float32)
        shape = (1, seq) + ((cfg.num_codebooks,) if cfg.modality == "audio"
                            else ())
        batch = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                         device="cuda", generator=g,
                                         dtype=torch.int32)}
        if cfg.modality == "vision":
            batch["patch_embeds"] = torch.randn(
                (1, cfg.vision_tokens, cfg.vision_embed_dim), device="cuda",
                generator=g)
        with torch.inference_mode():
            card, _, aux = forward(params, batch, cfg)
            host, _, host_aux = forward(to_cpu(params), to_cpu(batch), cfg)
        err = (card.cpu() - host).abs().max().item()
        if not torch.allclose(card.cpu(), host, rtol=1e-3, atol=1e-3):
            raise AssertionError(f"{arch}: card vs host max |err| {err}")
        aux_err = abs(aux.item() - host_aux.item())
        if aux_err > 1e-3 * max(1.0, abs(host_aux.item())):
            raise AssertionError(f"{arch}: aux loss card {aux.item()} vs "
                                 f"host {host_aux.item()}")
        report[f"card_vs_host_{arch}"] = {
            "tokens": seq, "logits_max_abs_err": err,
            "logits_max_abs": host.abs().max().item(),
            "aux": host_aux.item(), "aux_abs_err": aux_err,
            "params": param_count(params)}
        log(f"models_card_vs_host {arch} (2 layers, f32, {seq} tokens, "
            f"{param_count(params) / 1e9:.3f} B params): logits max |err| "
            f"{err:.3e} (|logits| up to {host.abs().max().item():.2f}); aux "
            f"{host_aux.item():.6f}, |err| {aux_err:.3e}")
        del params, card, host
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# RANL training at full width (phases train_*)
# --------------------------------------------------------------------------

TRAIN = dict(workers=4, batch=8, seq=512, steps=5, layers=2)
# a RANL round with K3/K4 against the same round, from the same params
# and state, through their plain twins, x each leaf's max |value|
# (params, precond) and rtol (loss).  The kernels' f32 forwards are held
# to 2e-4 of the twins' (phase kernels_attn_wkv), and a round's Newton
# step divides the gradients' rounding by curvatures as small as its
# floor (on the CPU, one rwkv6 round of the port against the reference's
# from the same state differs by up to 9.2e-4 of a leaf's max).  rwkv6's
# time mix also divides each head's wkv output by its rms (ln_x), so a
# head whose output is small magnifies K4's rounding (up to 3.2e-4
# absolute at the train shape) into the gradient coordinates it reaches,
# and the precond squares them: measured on an H100 80GB HBM3 at 700 W,
# params 2.19e-3 and precond 3.72e-3 of a leaf's max (phi4-mini: 2.3e-6
# and 3.3e-6).  Each round is held from the same inputs: these runs raise
# their loss (phi4-mini 12.7 -> 52.2 in 5 rounds), and along such a
# trajectory two runs that differ in the last bits drift apart whatever
# computes them.
TRAIN_TOL = {"flash_attention": 1e-3, "rwkv_wkv": 1e-2}
# AdamW normalises each coordinate by its own |gradient|, so a coordinate
# whose gradient is rounding-sized takes a step of ±lr on either run:
# at most this share of a leaf's coordinates may leave K3's TRAIN_TOL
ADAM_SIGN_SHARE = 1e-3


def train_setup(torch, arch, seq, layers=None, batch=None, steps=None):
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.models import init_model, lm_loss
    cfg = dataclasses.replace(get_config(arch),
                              num_layers=layers or TRAIN["layers"])
    g = torch.Generator(device="cuda").manual_seed(5)
    params = init_model(cfg, g, torch.float32)
    batches = [make_batch(cfg, g, batch or TRAIN["batch"], seq,
                          pattern="bigram")
               for _ in range(1 + (steps or TRAIN["steps"]))]

    def loss_fn(p, b):
        return lm_loss(p, b, cfg, q_chunk=min(1024, seq),
                       kv_chunk=min(1024, seq))
    return cfg, params, batches, loss_fn


def to_card(node):
    if isinstance(node, dict):
        return {k: to_card(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_card(v) for v in node]
    return node.cuda()


def twins_round(torch, label, fn, want, want_metrics, tol):
    """``fn`` through the plain twins (no launch), held to the kernels'
    round ``want`` (a host tree of params and precond) and its metrics:
    coverage and uplink equal, loss within ``tol``.  Returns the worst
    |err| / leaf max of params and precond."""
    from repro_torch.kernels import LAUNCHES
    before = dict(LAUNCHES)
    with plain_twins():
        got, metrics = fn()
    if LAUNCHES != before:
        raise AssertionError(f"{label} through the twins launched "
                             f"{LAUNCHES} (before {before})")
    if metrics is not None:
        for k in ("coverage", "uplink_frac"):
            if float(metrics[k]) != want_metrics[k]:
                raise AssertionError(f"{label}: {k} {want_metrics[k]} vs "
                                     f"{float(metrics[k])} through the twins")
        loss = float(metrics["loss"])
        if not math.isfinite(want_metrics["loss"]) or abs(
                want_metrics["loss"] - loss) > tol * abs(loss):
            raise AssertionError(f"{label}: loss {want_metrics['loss']} vs "
                                 f"{loss} through the twins")
    return {name: leaves_close(torch, want[name], got[name],
                               f"{label} {name}", tol) for name in want}


def ranl_run(torch, params, batches, rcfg, loss_fn, tol):
    """init_state, then one train_step a batch, each timed to a sync; each
    round is also run from the same inputs through the plain twins and
    held to the kernels' (the kernels' outputs wait on the host
    meanwhile).  Returns (params, state, metrics, init seconds, step
    seconds, the worst twin gaps)."""
    from repro_torch import prng
    from repro_torch.optim import init_state, train_step
    key = prng.PRNGKey(0)
    state, init_s = sync_time(torch, lambda: init_state(
        params, loss_fn, batches[0], rcfg, key))
    gaps = [twins_round(
        torch, "init_state", lambda: ({"precond": init_state(
            params, loss_fn, batches[0], rcfg, key)["precond"]}, None),
        {"precond": to_cpu(state["precond"])}, None, tol)]
    p, metrics, step_s = params, [], []
    for t, b in enumerate(batches[1:]):
        (p1, s1, m), secs = sync_time(torch, lambda: train_step(
            p, state, b, key, loss_fn=loss_fn, cfg=rcfg))
        metrics.append({k: float(v) for k, v in m.items()})
        step_s.append(secs)
        host = to_cpu({"params": p1, "state": s1})
        del p1, s1
        torch.cuda.empty_cache()

        def twin():
            q, r, mt = train_step(p, state, b, key, loss_fn=loss_fn,
                                  cfg=rcfg)
            return {"params": q, "precond": r["precond"]}, mt
        gaps.append(twins_round(
            torch, f"round {t}", twin,
            {"params": host["params"], "precond": host["state"]["precond"]},
            metrics[-1], tol))
        del p, state
        torch.cuda.empty_cache()
        p, state = to_card(host["params"]), to_card(host["state"])
        del host
    worst = {k: max(g.get(k, 0.0) for g in gaps)
             for k in ("params", "precond")}
    return p, state, metrics, init_s, step_s, worst


def step_split(torch, params, state, batch, rcfg, loss_fn):
    """One round's parts, each timed to a sync: the per-worker forwards
    and backwards, the aggregate, the Newton step.  The aggregate runs
    twice, each time on a pass's fresh gradients: the first call's time
    and the second's, each with the ``cudaMalloc`` calls it made (the
    caching allocator's new segments)."""
    from repro_torch import prng
    from repro_torch.core.masks import sample_masks
    from repro_torch.optim.ranl_llm import (aggregate, newton_step,
                                            per_worker_grads, region_layout)
    masks = sample_masks(rcfg.policy, prng.PRNGKey(1), 0, rcfg.num_workers,
                         region_layout(params)[0], "cuda")

    def segments():
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def grads():
        return per_worker_grads(loss_fn, params, batch, rcfg.num_workers)[1]

    def timed_aggregate(G):
        before = segments()
        (g, _, _), s = sync_time(torch, lambda: aggregate(
            G, state["memory"], masks, params, rcfg))
        return g, s, segments() - before
    G, grads_s = sync_time(torch, grads)
    g, first_s, first_mallocs = timed_aggregate(G)
    del g
    g, agg_s, mallocs = timed_aggregate(grads())
    _, newton_s = sync_time(torch, lambda: newton_step(
        params, g, state["precond"], rcfg))
    return {"grads_s": grads_s, "aggregate_first_s": first_s,
            "aggregate_first_mallocs": first_mallocs, "aggregate_s": agg_s,
            "aggregate_mallocs": mallocs, "newton_s": newton_s}


def leaves_close(torch, got, want, label, tol, share=0.0):
    """Every leaf of ``got`` within ``tol`` x the leaf's max |value| of
    ``want`` (either on the host or the card; compared on the card a
    leaf at a time); with ``share``, that share of a leaf's elements may
    leave it.  Returns the worst |err| / max (logged where some left)."""
    from repro_torch.tree import leaf_paths, get, num_layers
    worst = 0.0
    for keys, layered in leaf_paths(want):
        for q in (range(num_layers(want)) if layered else (None,)):
            a, b = get(got, keys, q).cuda(), get(want, keys, q).cuda()
            scale = max(b.abs().max().item(), 1e-30)
            err = (a - b).abs()
            out = (err > tol * scale).float().mean().item()
            if out > share:
                raise AssertionError(
                    f"{label} {'/'.join(keys)}[{q}]: max |err| "
                    f"{err.max().item()} x max {scale}, {out} of it past "
                    f"{tol}")
            if out:
                log(f"{label} {'/'.join(keys)}[{q}]: {out:.3e} of the leaf "
                    f"past {tol} (allowed {share}), max |err| "
                    f"{err.max().item() / scale:.3e} x max")
            worst = max(worst, err.max().item() / scale)
            del a, b, err
    return worst


def kernel_at_train_shape(torch, kernel, cfg, seq):
    """The path's kernel at its train shape in f32 (one worker's forward
    of one layer) against its plain twin: max |err|, ms on the card, the
    twin's ms, the bound and (K3) scaled_dot_product_attention's ms."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_wkv as wkv
    gen = torch.Generator(device="cuda").manual_seed(6)
    b = TRAIN["batch"] // TRAIN["workers"]
    f32 = torch.float32
    if kernel == "flash_attention":
        shape = (b, seq, cfg.num_heads, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        nb, fl, peak = attn_bound(*shape, 0, "float32")
        n_sets = max(2, -(-2 * L2_BYTES // nb))
        sets = [attn_inputs(torch, *shape, f32, gen) for _ in range(n_sets)]
        fn, twin = fa.flash_attention, ref.flash_attention_ref
    else:
        shape = (b, seq, cfg.num_rwkv_heads, cfg.rwkv_head_dim)
        nb, fl, peak = wkv_bound(*shape, "float32")
        n_sets = max(2, -(-2 * L2_BYTES // nb))
        sets = [wkv_inputs(torch, *shape, f32, gen) for _ in range(n_sets)]
        fn, twin = wkv.rwkv_wkv, ref.rwkv_wkv_ref
    got, want = fn(*sets[0]), twin(*sets[0])
    got, want = (got, want) if kernel == "flash_attention" else (got[0],
                                                                 want[0])
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=2e-4, atol=2e-4):
        raise AssertionError(f"{kernel} at {shape} f32: max |err| {err}")
    row = {"shape": list(shape), "dtype": "float32", "max_abs_err": err,
           "ms": device_ms(torch, fn, sets),
           "plain_ms": device_ms(torch, twin, sets[:2]),
           **bound_row(nb, fl, peak)}
    if kernel == "flash_attention":
        from repro_torch.kernels.flash_attention import route
        row["body"] = route(f32, shape[-1])
        row["library_ms"], _ = library_attention_ms(torch, sets)
    del sets
    return row


def phase_train(torch, report, launches, arch, kernel, seq):
    """RANL at full width cut to 2 layers, f32: N = 4 workers, global
    batch 8, the CLI's RanlLLMConfig; init_state, then 5 train_steps.
    The kernel launches N x L x (1 + 5) times; each round run again from
    the same inputs through the plain twins launches none, and is held to
    it: masks (coverage, uplink) equal, loss, params and precond within
    TRAIN_TOL[kernel]."""
    from repro_torch.optim import RanlLLMConfig
    from repro_torch.tree import leaves
    cfg, params, batches, loss_fn = train_setup(torch, arch, seq)
    rcfg = RanlLLMConfig(num_workers=TRAIN["workers"], keep_prob=0.7,
                         mu=1e-4, lr=1.0)
    n = param_count(params)
    torch.cuda.reset_peak_memory_stats()
    (p, state, metrics, init_s, step_s, gaps), total_s, counts = counted(
        torch, launches, lambda: ranl_run(torch, params, batches, rcfg,
                                          loss_fn, TRAIN_TOL[kernel]))
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN["workers"] * TRAIN["layers"] * (1 + TRAIN["steps"])
    aggregates = len(leaves(params)) * TRAIN["steps"]
    if counts != {**ZERO, kernel: want, f"{kernel}_bwd": want,
                  "masked_aggregate": aggregates}:
        raise AssertionError(f"train {arch}: launches {counts}, expected "
                             f"{kernel} and {kernel}_bwd: {want}, "
                             f"masked_aggregate: {aggregates}")
    del params
    split = step_split(torch, p, state, batches[1], rcfg, loss_fn)
    del p, state
    torch.cuda.empty_cache()
    tokens = TRAIN["batch"] * seq
    warm = statistics.median(step_s[1:])
    k_row = kernel_at_train_shape(torch, kernel, cfg, seq)
    per_step = TRAIN["workers"] * TRAIN["layers"]
    row = {"arch": arch, "params": n, "layers": TRAIN["layers"],
           "workers": TRAIN["workers"], "batch": TRAIN["batch"], "seq": seq,
           "steps": TRAIN["steps"], "init_state_s": init_s,
           "step_s": step_s, "warm_step_s": warm, "split": split,
           "tokens_per_s": tokens / warm, "peak_gb": peak / 1e9,
           "launches": counts, "losses": [m["loss"] for m in metrics],
           "coverage": [m["coverage"] for m in metrics],
           "uplink_frac": [m["uplink_frac"] for m in metrics],
           "params_max_rel_err": gaps["params"],
           "precond_max_rel_err": gaps["precond"], "phase_s": total_s,
           "kernel": k_row,
           "kernel_share_of_step": per_step * k_row["ms"] / 1e3 / warm}
    bwd_ms = report.get(f"{kernel}_bwd", {}).get("ms")   # train_grad's
    if bwd_ms is not None:
        row["kernel_bwd_ms"] = bwd_ms
        row["kernel_bwd_share_of_step"] = per_step * bwd_ms / 1e3 / warm
    report[f"train_{'rwkv' if kernel == 'rwkv_wkv' else 'dense'}"] = row
    report.setdefault(kernel, {})[f"train_{arch}_f32"] = k_row
    log(f"train {arch} (2 layers, {n / 1e9:.3f} B params, f32, N = 4, "
        f"batch 8 x {seq}): init_state {init_s:.3f} s; steps "
        f"{[round(x, 4) for x in step_s]} s (warm median {warm:.4f} s: "
        f"grads {split['grads_s']:.4f}, aggregate {split['aggregate_s']:.4f}"
        f" with {split['aggregate_mallocs']} cudaMallocs (first call "
        f"{split['aggregate_first_s']:.4f} with "
        f"{split['aggregate_first_mallocs']}), Newton "
        f"{split['newton_s']:.4f}); {tokens / warm:.0f} tokens/s; "
        f"peak {peak / 1e9:.2f} GB; launches {counts}; losses "
        f"{row['losses']}; each round vs the same round through the twins: "
        f"params / precond within {gaps['params']:.3e} / "
        f"{gaps['precond']:.3e} x leaf max")
    log(f"train {arch}: {kernel} at {tuple(k_row['shape'])} f32 "
        f"{k_row['ms']:.5f} ms on the card (plain {k_row['plain_ms']:.5f}, "
        f"library {k_row.get('library_ms')}), bound {k_row['bound_ms']:.5f}"
        f" ms by {k_row['bound_by']}; {per_step} a step = "
        f"{row['kernel_share_of_step']:.2%} of the warm step; its backward "
        f"kernel {bwd_ms} ms (train_grad), {per_step} a step = "
        f"{row.get('kernel_bwd_share_of_step', 0):.2%}")
    del batches
    torch.cuda.empty_cache()


def adamw_run(torch, params, batches, loss_fn):
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_step
    from repro_torch.optim.first_order import value_and_grad
    acfg = AdamWConfig(lr=1e-3)
    state = adamw_init(params, acfg)
    p, losses, step_s = params, [], []
    for b in batches:
        def step():
            loss, grads = value_and_grad(loss_fn, p, b)
            return (*adamw_step(p, state, grads, acfg), float(loss))
        (p, state, loss), secs = sync_time(torch, step)
        losses.append(loss)
        step_s.append(secs)
    return p, losses, step_s


def phase_train_adamw(torch, report, launches):
    """The AdamW baseline at train_dense's size: 3 steps on the full batch
    (the CLI's lr 1e-3), against the same run through the twins: K3 L x 3
    times, none through the twins; losses within TRAIN_TOL, params within
    it but for ``ADAM_SIGN_SHARE`` of a leaf."""
    arch, seq = "phi4-mini-3.8b", TRAIN["seq"]
    cfg, params, batches, loss_fn = train_setup(torch, arch, seq)
    batches = batches[:3]
    torch.cuda.reset_peak_memory_stats()
    (p, losses, step_s), _, counts = counted(
        torch, launches, lambda: adamw_run(torch, params, batches, loss_fn))
    peak = torch.cuda.max_memory_allocated()
    want = TRAIN["layers"] * 3
    if counts != {**ZERO, "flash_attention": want,
                  "flash_attention_bwd": want}:
        raise AssertionError(f"train_adamw: launches {counts}")
    got = to_cpu(p)
    del p
    with plain_twins():
        (pp, plain_losses, _), _, pcounts = counted(
            torch, launches, lambda: adamw_run(torch, params, batches,
                                               loss_fn))
    if any(pcounts.values()):
        raise AssertionError(f"train_adamw twins: launches {pcounts}")
    want = to_cpu(pp)
    del pp
    for t, (a, b) in enumerate(zip(losses, plain_losses)):
        if not math.isfinite(a) or abs(a - b) > TRAIN_TOL[
                "flash_attention"] * abs(b):
            raise AssertionError(f"train_adamw step {t}: loss {a} vs {b}")
    tol = TRAIN_TOL["flash_attention"]
    err = leaves_close(torch, got, want, "train_adamw params", tol,
                       share=ADAM_SIGN_SHARE)
    warm = statistics.median(step_s[1:])
    report["train_adamw"] = {
        "arch": arch, "layers": TRAIN["layers"], "batch": TRAIN["batch"],
        "seq": seq, "steps": 3, "step_s": step_s, "warm_step_s": warm,
        "tokens_per_s": TRAIN["batch"] * seq / warm, "peak_gb": peak / 1e9,
        "launches": counts, "losses": losses, "twin_losses": plain_losses,
        "params_max_rel_err": err}
    log(f"train_adamw {arch} (2 layers, f32, batch 8 x {seq}): steps "
        f"{[round(x, 4) for x in step_s]} s; "
        f"{TRAIN['batch'] * seq / warm:.0f} tokens/s; peak {peak / 1e9:.2f} "
        f"GB; launches {counts}; losses {losses} (twins {plain_losses}); "
        f"params vs the twins' run {err:.3e} x leaf max")
    del params, batches, got, want
    torch.cuda.empty_cache()


def phase_train_cli(torch, report):
    """``repro_torch.launch.train.run`` on the card with --smoke: RANL
    under pareto-stragglers with the resource controller and a 0.75
    quorum, then AdamW with a checkpoint, restored bit-equal to the
    trained params; both with --journal and --trace: each journal valid,
    one round a step, an ``execute`` span a step timed on the card (and
    the ``checkpoint`` span), the round's own spans inside each (RANL: a
    ``ranl.round`` a step; both: a ``forward`` and a ``backward`` a
    worker), rendered by the report CLI, and the Chrome trace holding the
    same spans."""
    import io
    from repro_torch.checkpoint import restore
    from repro_torch.launch import train as cli
    from repro_torch.obs import read_journal, validate_journal
    from repro_torch.tree import leaves
    ckpt = os.path.join(HERE, "build", "ckpt")
    obs_dir = os.path.join(HERE, "build", "obs")
    os.makedirs(obs_dir, exist_ok=True)
    saved = {}
    save = cli.save

    def keep(tree, directory, **kw):
        saved["params"] = tree
        return save(tree, directory, **kw)
    out = {}
    for label, argv, spans_want in (
            ("ranl_hetero", ["--smoke", "--steps", "4", "--scenario",
                             "pareto-stragglers", "--controller",
                             "resource:keep=0.7", "--quorum", "0.75"],
             ["execute"] * 4),
            ("adamw_checkpoint", ["--smoke", "--steps", "4", "--optimizer",
                                  "adamw", "--checkpoint-dir", ckpt],
             ["execute"] * 4 + ["checkpoint"])):
        jpath = os.path.join(obs_dir, f"train_{label}.jsonl")
        tpath = os.path.join(obs_dir, f"train_{label}.trace.json")
        buf = io.StringIO()
        cli.save = keep
        try:
            with contextlib.redirect_stdout(buf):
                (hist, secs) = sync_time(torch, lambda: cli.run(
                    argv + ["--journal", jpath, "--trace", tpath]))
        finally:
            cli.save = save
        lines = buf.getvalue().strip().splitlines()
        final = json.loads(lines[-1])
        if not all(math.isfinite(final[k]) for k in ("final_loss",
                                                   "first_loss")):
            raise AssertionError(f"train_cli {label}: {lines[-1]}")
        records = read_journal(jpath)
        problems = validate_journal(records)
        spans = [r for r in records if r["kind"] == "span"]
        rounds = [r for r in records if r["kind"] == "round"]
        names = [s["name"] for s in spans]
        inner_want = ({"ranl.round": 4} if label.startswith("ranl")
                      else {"forward": 4, "backward": 4})
        if problems or len(rounds) != 4 or [
                n for n in names if n in ("execute", "checkpoint")
        ] != spans_want or any(names.count(n) != k for n, k in
                               inner_want.items()) or not all(
                "device_s" in s for s in spans) or not all(
                s["device_s"] > 0.0 for s in spans
                if s["name"] == "execute"):
            raise AssertionError(f"train_cli {label}: journal {problems}, "
                                 f"{len(rounds)} rounds, spans {names}")
        trace = json.load(open(tpath))
        if [e["name"] for e in trace["traceEvents"]] != names:
            raise AssertionError(f"train_cli {label}: trace {trace}")
        rendered = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", jpath],
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
        if rendered.returncode != 0:
            raise AssertionError(f"train_cli {label}: the report CLI "
                                 f"failed: {rendered.stderr[-2000:]}")
        device_s = {s["name"]: 0.0 for s in spans}
        for s in spans:
            device_s[s["name"]] += s["device_s"]
        out[label] = {"seconds": secs, "final": final,
                      "steps": len(hist), "lines": lines[-5:],
                      "journal_records": len(records),
                      "span_device_s": device_s}
        log(f"train_cli {label}: {secs:.2f} s; journal valid ({len(records)} "
            f"records), spans on the card {device_s}, rendered; "
            + " | ".join(lines[-3:]))
    like = saved["params"]
    back = restore(like, ckpt)
    if not all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(like))):
        raise AssertionError("train_cli: the restored checkpoint differs "
                             "from the trained params")
    out["checkpoint_restored_bit_equal"] = True
    log(f"train_cli: checkpoint in {ckpt} restored bit-equal "
        f"({len(leaves(like))} tensors)")
    report["train_cli"] = out


# --------------------------------------------------------------------------
# sharded RANL training on torch.distributed (phase train_sharded)
# --------------------------------------------------------------------------

# leg (a), NCCL at world size 1: train_dense's setup, init_state then
# this many train_steps
TRAIN_SHARDED_STEPS = 3
# leg (b), two gloo ranks on the card: phi4-mini cut to 1 layer, N = 4,
# batch 4 x 256, 2 steps, on each mesh (label, shape, dimension names)
TRAIN_SHARDED_CUT = dict(layers=1, batch=4, seq=256, steps=2)
TRAIN_SHARDED_MESHES = (("data2", (2,), ("data",)),
                        ("1x2", (1, 2), ("data", "model")))
# each rank's persistent RANL state at ("data", "model") = (1, 2), at most
# this share of the unsharded state's bytes
HALF_STATE = 0.55


def host_rss_gb():
    """This process's resident host memory, GB (0 where /proc lacks it)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return 0.0


def state_bytes(params, state):
    """Bytes of the persistent RANL state: params, precond and memory,
    every leaf (an int8 leaf's codes and scales)."""
    from repro_torch.tree import leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree)
                   for t in (t.values() if isinstance(t, dict) else [t]))
    return nbytes(params) + nbytes(state["precond"]) + nbytes(
        state["memory"])


def train_mesh(shape, dims):
    """("data",) from init_device_mesh, as the train CLI builds it for
    --data-shards alone; any other shape from make_engine_mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_engine_mesh
    if dims == ("data",):
        return init_device_mesh("cuda", shape, mesh_dim_names=dims)
    pods = shape[0] if len(shape) == 3 else 1
    return make_engine_mesh(shape[-2], shape[-1], pods=pods,
                            device_type="cuda")


def held_to_unsharded(torch, label, got, got_metrics, want, want_metrics,
                      tol):
    """A sharded step's output ``got`` ({"params", "precond"}, full
    leaves, on the host) and metrics against the unsharded step's
    ``want`` and ``want_metrics``: coverage and uplink equal, loss within
    ``tol`` (relative), params and precond within ``tol`` x each leaf's
    max.  Returns the worst gaps."""
    for k in ("coverage", "uplink_frac"):
        if float(want_metrics[k]) != got_metrics[k]:
            raise AssertionError(f"{label}: {k} {got_metrics[k]} vs the "
                                 f"unsharded step's {float(want_metrics[k])}")
    loss = float(want_metrics["loss"])
    if not abs(got_metrics["loss"] - loss) <= tol * abs(loss):
        raise AssertionError(f"{label}: loss {got_metrics['loss']} vs the "
                             f"unsharded step's {loss}")
    return {name: leaves_close(torch, got[name], want[name],
                               f"{label} {name}", tol)
            for name in ("params", "precond")} | {
        "loss": abs(got_metrics["loss"] - loss) / abs(loss)}


def train_sharded_world_of_one(torch, report, launches):
    """Leg (a): NCCL at world size 1 in this process, ("data", "model") =
    (1, 1): train_dense's setup (phi4-mini, 2 layers, f32, N = 4, batch
    8 x 512), init_state then TRAIN_SHARDED_STEPS train_steps on the
    mesh.  Each held to the unsharded step (and init_state) from the same
    inputs on the card; K3 launches N x L x (1 + steps) times in the
    sharded run; its log passes the train-step contract."""
    import torch.distributed as dist
    from repro_torch import prng
    from repro_torch.analysis import check_log, train_contract
    from repro_torch.core.collectives import Collectives
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.launch.shard import ranl_state_pspecs
    from repro_torch.optim import (RanlLLMConfig, init_state, shard_params,
                                   train_step)
    from repro_torch.optim.ranl_llm import mesh_sizes
    tol = TRAIN_TOL["flash_attention"]
    cfg, params, batches, loss_fn = train_setup(
        torch, "phi4-mini-3.8b", TRAIN["seq"], steps=TRAIN_SHARDED_STEPS)
    rcfg = RanlLLMConfig(num_workers=TRAIN["workers"], keep_prob=0.7,
                         mu=1e-4, lr=1.0)
    key = prng.PRNGKey(0)
    counts = dict(ZERO)

    def main_path(fn):
        torch.cuda.reset_peak_memory_stats()
        out, secs, c = counted(torch, launches, fn)
        for k, v in c.items():
            counts[k] += v
        return out, secs, torch.cuda.max_memory_allocated()

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        sharded_store("nccl_train"), 1), rank=0, world_size=1)
    try:
        mesh = make_engine_mesh(1, 1, device_type="cuda")
        pspecs = {"state": ranl_state_pspecs(params, 1)}
        coll = Collectives(mesh)
        on = dict(mesh=mesh, pspecs=pspecs, coll=coll)
        p = shard_params(params, mesh, pspecs)
        del params
        state, init_s, peak = main_path(lambda: init_state(
            p, loss_fn, batches[0], rcfg, key, **on))
        plain = init_state(p, loss_fn, batches[0], rcfg, key)
        init_gap = leaves_close(torch, state["precond"], plain["precond"],
                                "train_sharded (a) init precond", tol)
        del plain
        torch.cuda.empty_cache()
        peaks, step_s, plain_s, plain_peaks, gaps = [peak], [], [], [], []
        metrics = []
        for t, b in enumerate(batches[1:]):
            (p1, s1, m), secs, peak = main_path(lambda: train_step(
                p, state, b, key, loss_fn=loss_fn, cfg=rcfg, **on))
            metrics.append({k: float(v) for k, v in m.items()})
            step_s.append(secs)
            peaks.append(peak)
            host = to_cpu({"params": p1, "state": s1})
            del p1, s1
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            (q, r, mt), us = sync_time(torch, lambda: train_step(
                p, state, b, key, loss_fn=loss_fn, cfg=rcfg))
            plain_peaks.append(torch.cuda.max_memory_allocated())
            plain_s.append(us)
            gaps.append(held_to_unsharded(
                torch, f"train_sharded (a) step {t}",
                {"params": host["params"],
                 "precond": host["state"]["precond"]}, metrics[-1],
                {"params": q, "precond": r["precond"]}, mt, tol))
            del q, r, p, state
            torch.cuda.empty_cache()
            p, state = to_card(host["params"]), to_card(host["state"])
            del host
        rep = check_log(train_contract(TRAIN_SHARDED_STEPS,
                                       **mesh_sizes(p, mesh, pspecs)),
                        coll.log)
        if not rep["ok"]:
            raise AssertionError(f"train_sharded (a): the log breaks the "
                                 f"train contract: {rep['violations'][:3]}")
        want = TRAIN["workers"] * TRAIN["layers"] * (1 + TRAIN_SHARDED_STEPS)
        if counts != {**ZERO, "flash_attention": want,
                      "flash_attention_bwd": want}:
            raise AssertionError(f"train_sharded (a): launches {counts}, "
                                 f"expected flash_attention and its "
                                 f"backward: {want}")
        del p, state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    warm = statistics.median(step_s[1:])
    row = {"mesh": {"data": 1, "model": 1}, "init_state_s": init_s,
           "step_s": step_s, "warm_step_s": warm,
           "unsharded_step_s": plain_s,
           "train_dense_warm_step_s": report.get("train_dense", {}).get(
               "warm_step_s"),
           "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] / warm,
           "peak_gb": max(peaks) / 1e9,
           "unsharded_peak_gb": max(plain_peaks) / 1e9,
           "init_precond_max_rel_err": init_gap,
           "params_max_rel_err": max(g["params"] for g in gaps),
           "precond_max_rel_err": max(g["precond"] for g in gaps),
           "loss_max_rel_err": max(g["loss"] for g in gaps),
           "losses": [m["loss"] for m in metrics], "launches": counts,
           "collectives": {k: sum(v) if isinstance(v, list) else v
                           for k, v in rep["counts"].items()},
           "wire": sorted({(c.dim, c.op, c.dtype, c.nbytes)
                           for c in coll.log})}
    log(f"train_sharded (a) NCCL x1 (1, 1), phi4-mini 2 layers, N = 4, "
        f"batch 8 x {TRAIN['seq']}: init_state {init_s:.3f} s; steps "
        f"{[round(x, 4) for x in step_s]} s (warm {warm:.4f} s) against "
        f"{[round(x, 4) for x in plain_s]} s unsharded from the same "
        f"inputs and train_dense's warm {row['train_dense_warm_step_s']} "
        f"({report.get('nvidia_smi')}); peak {row['peak_gb']:.2f} GB "
        f"(unsharded {row['unsharded_peak_gb']:.2f}); launches {counts}; "
        f"params / precond / loss within {row['params_max_rel_err']:.3e} / "
        f"{row['precond_max_rel_err']:.3e} / {row['loss_max_rel_err']:.3e} "
        f"of the unsharded step's; collectives {row['collectives']}, wire "
        f"{row['wire']}")
    return row


def _train_sharded_rank(rank, store, out_dir):
    """Leg (b)'s rank ``rank`` of 2, on the one card over gloo: on each
    mesh of TRAIN_SHARDED_MESHES, init_state and the steps of
    TRAIN_SHARDED_CUT, params and precond gathered to full leaves after
    each (on the host, rank 0); then, its shards freed, rank 0 runs the
    same init_state and steps unsharded and holds each sharded step to
    them.  Then the train CLI with --smoke --data-shards 2.  Results go
    to ``out_dir/train_rank<r>.pt``."""
    import io
    import torch
    import torch.distributed as dist
    from repro_torch import prng
    from repro_torch.core.collectives import Collectives
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import train as cli
    from repro_torch.launch.shard import ranl_state_pspecs
    from repro_torch.optim import (RanlLLMConfig, gather_tree, init_state,
                                   shard_params, train_step)
    from repro_torch.optim.ranl_llm import mesh_sizes
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    cut = TRAIN_SHARDED_CUT
    tol = TRAIN_TOL["flash_attention"]
    try:
        cfg, params, batches, loss_fn = train_setup(
            torch, "phi4-mini-3.8b", cut["seq"], layers=cut["layers"],
            batch=cut["batch"], steps=cut["steps"])
        rcfg = RanlLLMConfig(num_workers=TRAIN["workers"], keep_prob=0.7,
                             mu=1e-4, lr=1.0)
        key = prng.PRNGKey(0)
        out = {}
        for label, shape, dims in TRAIN_SHARDED_MESHES:
            mesh = train_mesh(shape, dims)
            M = shape[-1] if "model" in dims else 1
            pspecs = {"state": ranl_state_pspecs(params, M)}
            coll, look = Collectives(mesh), Collectives(mesh)
            on = dict(mesh=mesh, pspecs=pspecs, coll=coll)

            def full(p, s):
                f = {"params": gather_tree(p, mesh, pspecs, look),
                     "precond": gather_tree(s["precond"], mesh, pspecs,
                                            look)}
                return to_cpu(f) if rank == 0 else None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            dist.barrier()
            p = shard_params(params, mesh, pspecs)
            state, init_s = sync_time(torch, lambda: init_state(
                p, loss_fn, batches[0], rcfg, key, **on))
            row = {"init_s": init_s, "persistent_bytes": state_bytes(
                p, state), "sizes": mesh_sizes(p, mesh, pspecs),
                "step_s": [], "metrics": []}
            launched, peak = dict(LAUNCHES), torch.cuda.max_memory_allocated()
            snaps = [full(p, state)]
            for b in batches[1:]:
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                dist.barrier()      # rank 0's host copy is not the step's
                (p, state, m), secs = sync_time(torch, lambda: train_step(
                    p, state, b, key, loss_fn=loss_fn, cfg=rcfg, **on))
                peak = max(peak, torch.cuda.max_memory_allocated())
                for k, v in LAUNCHES.items():
                    launched[k] = launched.get(k, 0) + v
                row["step_s"].append(secs)
                row["metrics"].append({k: float(v) for k, v in m.items()})
                snaps.append(full(p, state))
                log(f"train_sharded (b) rank {rank} {label} step "
                    f"{len(row['step_s']) - 1}: {secs:.3f} s; host "
                    f"{host_rss_gb():.1f} GB, card "
                    f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
            row.update(launches=launched, max_memory_allocated=peak,
                       log=[tuple(c.__dict__.values()) for c in coll.log])
            del p, state
            torch.cuda.empty_cache()
            dist.barrier()                  # the card is rank 0's now
            if rank == 0:
                torch.cuda.reset_peak_memory_stats()
                s = init_state(params, loss_fn, batches[0], rcfg, key)
                gaps = [{"precond": leaves_close(
                    torch, snaps[0]["precond"], s["precond"],
                    f"train_sharded (b) {label} init precond", tol)}]
                q, row["unsharded_step_s"] = params, []
                for t, b in enumerate(batches[1:]):
                    (q, s, mt), us = sync_time(torch, lambda: train_step(
                        q, s, b, key, loss_fn=loss_fn, cfg=rcfg))
                    row["unsharded_step_s"].append(us)
                    gaps.append(held_to_unsharded(
                        torch, f"train_sharded (b) {label} step {t}",
                        snaps[t + 1], row["metrics"][t],
                        {"params": q, "precond": s["precond"]}, mt, tol))
                row["unsharded_max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated()
                row["unsharded_bytes"] = state_bytes(q, s)
                row["gaps"] = {k: max(g.get(k, 0.0) for g in gaps)
                               for k in ("params", "precond", "loss")}
                del q, s
            del snaps
            torch.cuda.empty_cache()
            out[label] = row
            dist.barrier()
        del params, batches
        torch.cuda.empty_cache()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.run(["--smoke", "--data-shards", "2", "--steps", "2"])
        out["cli"] = buf.getvalue()
        torch.save(out, os.path.join(out_dir, f"train_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def train_sharded_two_ranks(torch, report, launches):
    """Leg (b): two ranks on the one card over gloo (spawn, joined within
    600 s).  Both ranks' metrics equal; each step held to the unsharded
    run's; each log within the train-step contract;
    each rank's persistent state and peak beside the unsharded run's, at
    most HALF_STATE of it at (1, 2); the CLI's final line within
    TRAIN_TOL of the one-rank CLI run's."""
    import io
    import torch.multiprocessing as mp
    from repro_torch.analysis import check_log, train_contract
    from repro_torch.core.collectives import Collective
    from repro_torch.launch import train as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run(["--smoke", "--steps", "2"])
    one = json.loads(buf.getvalue().strip().splitlines()[-1])
    gc.collect()            # nothing of this process's runs stays on the card
    torch.cuda.empty_cache()
    out_dir = os.path.dirname(sharded_store("gloo_train"))
    for r in (0, 1):
        if os.path.exists(os.path.join(out_dir, f"train_rank{r}.pt")):
            os.remove(os.path.join(out_dir, f"train_rank{r}.pt"))
    log(f"train_sharded (b): this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved on the card "
        f"before the ranks start")
    ctx = mp.start_processes(_train_sharded_rank, args=(
        os.path.join(out_dir, "gloo_train"), out_dir), nprocs=2,
        join=False, start_method="spawn")
    deadline = time.time() + 600
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise AssertionError("the two train_sharded ranks did not "
                                 "finish in 600 s")
    ranks = [torch.load(os.path.join(out_dir, f"train_rank{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    out = {}
    steps = TRAIN_SHARDED_CUT["steps"]
    for label, shape, dims in TRAIN_SHARDED_MESHES:
        a, b = ranks[0][label], ranks[1][label]
        if a["metrics"] != b["metrics"]:
            raise AssertionError(f"train_sharded (b) {label}: ranks differ "
                                 f"in {a['metrics']} / {b['metrics']}")
        cc = []
        for i, r in enumerate(ranks):
            rep = check_log(train_contract(steps, **r[label]["sizes"]),
                            [Collective(*e) for e in r[label]["log"]])
            if not rep["ok"]:
                raise AssertionError(f"train_sharded (b) {label} rank {i}: "
                                     f"{rep['violations'][:3]}")
            cc.append({k: sum(v) if isinstance(v, list) else v
                       for k, v in rep["counts"].items()})
            got = r[label]["launches"]
            n_local = TRAIN["workers"] // (shape[0] if dims[0] == "data"
                                           else 1)
            want = n_local * TRAIN_SHARDED_CUT["layers"] * (1 + steps)
            if {**ZERO, **got} != {**ZERO, "flash_attention": want,
                                   "flash_attention_bwd": want}:
                raise AssertionError(f"train_sharded (b) {label} rank {i}: "
                                     f"launches {got}, expected "
                                     f"flash_attention and its backward: "
                                     f"{want}")
            for name, v in got.items():
                launches[name] += v
        share = [r[label]["persistent_bytes"] / a["unsharded_bytes"]
                 for r in ranks]
        if "model" in dims and not max(share) <= HALF_STATE:
            raise AssertionError(f"train_sharded (b) {label}: persistent "
                                 f"state {share} of the unsharded state's")
        out[label] = {
            "mesh": dict(zip(dims, shape)),
            "step_s": [r[label]["step_s"] for r in ranks],
            "unsharded_step_s": a["unsharded_step_s"],
            "init_s": [r[label]["init_s"] for r in ranks],
            "persistent_bytes": [r[label]["persistent_bytes"]
                                 for r in ranks],
            "unsharded_bytes": a["unsharded_bytes"], "state_share": share,
            "max_memory_allocated": [r[label]["max_memory_allocated"]
                                     for r in ranks],
            "unsharded_max_memory_allocated":
                a["unsharded_max_memory_allocated"],
            "gaps": a["gaps"], "launches": [r[label]["launches"]
                                            for r in ranks],
            "collectives": cc[0]}
        o = out[label]
        log(f"train_sharded (b) gloo x2 on one card {o['mesh']}, phi4-mini "
            f"1 layer, N = 4, batch 4 x 256: steps {o['step_s']} s (ranks "
            f"0 / 1) against {[round(x, 4) for x in o['unsharded_step_s']]}"
            f" s unsharded ({report.get('nvidia_smi')}); persistent state "
            f"{o['persistent_bytes']} B a rank = {[round(x, 4) for x in share]}"
            f" of the unsharded {o['unsharded_bytes']} B; max_memory_"
            f"allocated {o['max_memory_allocated']} against "
            f"{o['unsharded_max_memory_allocated']} unsharded; gaps "
            f"{o['gaps']}; collectives {cc[0]}")
    lines = ranks[0]["cli"].strip().splitlines()
    got = json.loads(lines[-1])
    if ranks[1]["cli"].strip():
        raise AssertionError(f"train_sharded (b) CLI: rank 1 printed "
                             f"{ranks[1]['cli'][-500:]}")
    for k in ("final_loss", "first_loss"):
        if not abs(got[k] - one[k]) <= TRAIN_TOL["flash_attention"] * abs(
                one[k]):
            raise AssertionError(f"train_sharded (b) CLI: {k} {got[k]} on "
                                 f"two ranks vs {one[k]} on one")
    out["cli"] = {"two_ranks": got, "one_rank": one, "lines": lines[-4:]}
    log(f"train_sharded (b) CLI --smoke --data-shards 2 on two gloo ranks: "
        f"{got} against {one} on one rank")
    return out


def phase_train_sharded(torch, report, launches):
    """Sharded RANL training: leg (a), NCCL at world size 1 in this
    process; leg (b), two ranks on the card over gloo."""
    with loopback():
        a = train_sharded_world_of_one(torch, report, launches)
        b = train_sharded_two_ranks(torch, report, launches)
    report["train_sharded"] = {"nccl_x1": a,
                               **{f"gloo_x2_{k}": v for k, v in b.items()}}


def launches_by_path(report):
    """{path: its run's launch counts} for every counted main-path run the
    report holds (options runs as ``options.<label>``)."""
    paths = {}
    for phase, row in report.items():
        if not isinstance(row, dict):
            continue
        if isinstance(row.get("launches"), dict):
            paths[phase] = row["launches"]
        for label, sub in row.items():
            if isinstance(sub, dict) and isinstance(sub.get("launches"),
                                                    dict):
                paths[f"{phase}.{label}"] = sub["launches"]
    return paths


def kernels_line(report, launches):
    """One row per kernel: the contract's keys first, then the extra
    measurements each row carries (shapes, one-call times, decode, the
    launches of each main-path run); an extra never replaces a contract
    key."""
    paths = launches_by_path(report)
    rows = []
    for name in KERNELS:
        r = dict(report[name])
        row = {"name": name, "route": ROUTES[name], "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": r.pop("max_abs_err"), "ms": r.pop("ms"),
               "plain_ms": r.pop("plain_ms"), "bound_ms": r.pop("bound_ms"),
               "bound_by": r.pop("bound_by", "bytes"),
               "library_ms": r.pop("library_ms", None),
               "launches_by_path": {p: c[name] for p, c in paths.items()
                                    if c.get(name)}}
        row.update({k: v for k, v in r.items() if k not in row})
        rows.append(row)
    return json.dumps({"kernels": rows})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--consistent-seeds", metavar="S,S,...",
                    type=lambda v: [int(x) for x in v.split(",")],
                    help="only log serve_consistent's full-depth gaps at "
                         "these seeds, then exit")
    ap.add_argument("--loop-init", action="store_true",
                    help="only time the d = 8192 hessian_rank=4 init "
                         "through the plain loop, then exit")
    args = ap.parse_args(argv)
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
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else None

    if args.consistent_seeds:
        consistent_readings(torch, args.consistent_seeds)
        return 0
    if args.loop_init:
        loop_init(torch, rt)
        return 0
    report = {"nvidia_smi": card}
    launches = dict(ZERO)
    failed = []
    t_all = time.time()
    for label, fn in (
            ("build", lambda: phase_build(report)),
            ("kernels", lambda: phase_kernels(torch, report)),
            ("masked_aggregate", lambda: phase_masked_aggregate(torch,
                                                                report)),
            ("grouped_matmul", lambda: phase_grouped_matmul(torch, report,
                                                            launches)),
            ("kernels_attn_wkv", lambda: phase_attn_wkv(torch, report)),
            ("dense", lambda: phase_dense(torch, rt, report, launches)),
            ("diag", lambda: phase_diag(torch, rt, report, launches)),
            ("obs", lambda: phase_obs(torch, rt, report, launches)),
            ("engines", lambda: phase_engines(torch, rt, report)),
            ("batch_dense", lambda: phase_batch(torch, rt, report, launches,
                                                "dense")),
            ("batch_diag", lambda: phase_batch(torch, rt, report, launches,
                                               "diag")),
            ("options", lambda: phase_options(torch, rt, report, launches)),
            ("hierarchy", lambda: phase_hierarchy(torch, rt, report,
                                                  launches)),
            ("sharded", lambda: phase_sharded(torch, rt, report, launches)),
            ("sharded2d", lambda: phase_sharded2d(torch, rt, report,
                                                  launches)),
            ("lowrank_init", lambda: phase_lowrank(torch, rt, report,
                                                   launches)),
            ("train_grad", lambda: phase_train_grad(torch, report)),
            ("serve_rwkv", lambda: phase_serve(
                torch, report, launches, "rwkv6-3b",
                {"rwkv_wkv": 32 * (1 + 31)})),
            ("serve_dense", lambda: phase_serve(
                torch, report, launches, "phi4-mini-3.8b",
                {"flash_attention": 32})),
            ("serve_consistent", lambda: phase_serve_consistent(torch,
                                                                report)),
            ("models_card_vs_host", lambda: phase_card_vs_host(torch,
                                                               report)),
            ("train_dense", lambda: phase_train(
                torch, report, launches, "phi4-mini-3.8b", "flash_attention",
                TRAIN["seq"])),
            ("train_rwkv", lambda: phase_train(
                torch, report, launches, "rwkv6-3b", "rwkv_wkv",
                TRAIN["seq"])),
            ("train_adamw", lambda: phase_train_adamw(torch, report,
                                                      launches)),
            ("train_cli", lambda: phase_train_cli(torch, report)),
            ("train_sharded", lambda: phase_train_sharded(torch, report,
                                                          launches)),
            ("examples", phase_examples)):
        t0 = time.time()
        try:
            fn()
            log(f"phase {label}: ok ({time.time() - t0:.1f} s)")
        except Exception:   # report every phase, then fail the run
            failed.append(label)
            traceback.print_exc()
            log(f"phase {label}: FAILED ({time.time() - t0:.1f} s)")
            torch.cuda.empty_cache()
    log(f"total {time.time() - t_all:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    for name in launches:
        if launches[name] < 1:
            print(f"chip_smoke: {name} never launched on the main path",
                  file=sys.stderr)
            return 1
    log(json.dumps({k: v for k, v in report.items() if k not in KERNELS}))
    log(kernels_line(report, launches))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
