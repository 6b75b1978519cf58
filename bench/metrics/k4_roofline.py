"""k4_roofline: the recurrence kernels' least time over their device
time, in %: Σ over the profiled window's forward and backward launches
of the bound (the larger of bytes at the peak bandwidth and FLOPs at the
peak rate) ÷ Σ the profiler's device time of K4's kernels (forward,
backward and its bonus sum).  Launches: the program's ``rwkv_wkv`` and
``rwkv_wkv_bwd`` counters; the shapes: one worker's call.  Bounds as the
port's ``chip_smoke.py`` has them: forward r, k, v, w, y once with u and
the state in and out, 5·hd² a (token, head); backward r, k, v and their
gradients, w, dy, dw once with u, du, the state, its gradient and the
final state's, 12·hd² a (token, head) (S rebuilt, dS, dr, dk, dv, dw)."""

import re

from harness import roofline

KERNELS = re.compile(r"(?<![A-Za-z_])(wkv_kernel|wkv_decode|wkv_bwd_kernel|du_sum)")
COUNTERS = ("rwkv_wkv", "rwkv_wkv_bwd")


def fwd_cost(b, s, h, hd, es):
    """(bytes, FLOPs) of one forward call."""
    n = b * s * h * hd
    nbytes = 3 * es * n + 4 * n + 4 * n + es * h * hd + 2 * 4 * b * h * hd * hd
    return nbytes, 5 * hd * hd * b * s * h


def bwd_cost(b, s, h, hd, es):
    """(bytes, FLOPs) of one backward call."""
    n = b * s * h * hd
    nbytes = (6 * es + 3 * 4) * n + 2 * es * h * hd + 3 * 4 * b * h * hd * hd
    return nbytes, 12 * hd * hd * b * s * h


def read(run):
    return roofline.read(run, KERNELS, "wkv", COUNTERS, fwd_cost,
                         bwd_cost)
