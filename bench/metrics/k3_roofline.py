"""k3_roofline: the attention kernels' least time over their device time,
in %: Σ over the profiled window's forward and backward launches of the
bound (the larger of bytes at the peak bandwidth and FLOPs at the peak
rate) ÷ Σ the profiler's device time of K3's kernels (forward, and the
backward's pre-pass, bodies and group sum).  Launches: the program's
``flash_attention`` and ``flash_attention_bwd`` counters; the shapes:
one worker's call.  Bounds as the port's ``chip_smoke.py`` has them:
forward q, o (H heads) and k, v (KV heads) once, 4·hd a kept pair;
backward q, o, dO, dQ and k, v, dK, dV once, 10·hd a pair (QKᵀ again,
dO Vᵀ, dV, dK, dQ)."""

import re

from harness import roofline

KERNELS = re.compile(r"(?<![A-Za-z_])(attn_kernel|attn_bwd_delta|attn_bwd_pre|"
                     r"grad_kernel|dkdv_kernel|dq_kernel|group_sum)")
COUNTERS = ("flash_attention", "flash_attention_bwd")


def pairs(s: int, window: int = 0) -> int:
    if not window:
        return s * (s + 1) // 2
    return sum(min(q + 1, window) for q in range(s))


def fwd_cost(b, s, h, kv, hd, es, window=0):
    """(bytes, FLOPs) of one forward call."""
    return es * hd * b * s * (2 * h + 2 * kv), 4 * hd * pairs(s, window) * b * h


def bwd_cost(b, s, h, kv, hd, es, window=0):
    """(bytes, FLOPs) of one backward call."""
    return (es * hd * b * s * (4 * h + 4 * kv),
            10 * hd * pairs(s, window) * b * h)


def read(run):
    return roofline.read(run, KERNELS, "attention", COUNTERS, fwd_cost,
                         bwd_cost)
