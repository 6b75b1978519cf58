"""moe_gemm_roofline: the grouped-product kernels' least time over their
device time, in %: Σ over the profiled window's launches of the bound
(the larger of bytes at the peak bandwidth and FLOPs at the peak rate)
÷ Σ the profiler's device time of ``grouped_mm_fwd`` and
``grouped_mm_wgrad``.  Launches: the program's ``grouped_matmul``
(forward) and ``grouped_matmul_bwd`` (one a dx or a dw product)
counters.  Every such launch is a product of (rows × K) by (K × N) over
the groups, {K, N} = {d_model, expert width}: 2·rows·K·N FLOPs, rows·K
and rows·N elements read or written once and each group's K·N weights
(or their gradient) once.  The rows are those the held experts took: the
program's ``models.moe.ROUTED``, summed on the card over every call of
the run and read here once, after it, as rows a call (the router is held
in this cell, so the share does not drift over the run).  A program
without that count reports nothing.  The rows that other cards' experts
take, which the kernels write as zeros, are no part of the bound."""

import re
import sys

from harness import roofline

KERNELS = re.compile(r"(?<![A-Za-z_])(grouped_mm_fwd|grouped_mm_wgrad)")
COUNTERS = ("grouped_matmul", "grouped_matmul_bwd")


def cost(rows, d, ff, groups, es):
    """(bytes, FLOPs) of one launch, forward or backward."""
    return es * (rows * (d + ff) + groups * d * ff), 2 * rows * d * ff


def rows_a_call():
    """The program's routed rows held here, a call of its expert layer,
    over the run; None where it keeps no such count."""
    routed = getattr(sys.modules.get("repro_torch.models.moe"), "ROUTED",
                     None)
    if not routed or not routed.get("calls"):
        return None
    return sum(int(v) for v in routed["rows"].values()) / routed["calls"]


def read(run):
    rows = rows_a_call()
    if rows is None:
        return None

    def at_rows(_, d, ff, groups, es):
        return cost(rows, d, ff, groups, es)
    return roofline.read(run, KERNELS, "experts", COUNTERS, at_rows, at_rows)
