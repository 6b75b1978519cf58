"""moe_gemm_ms: device ms a round of the grouped-product kernels of the
expert layer (``grouped_mm_fwd``: the forward's gate, up and down
products and the backward's dx products; ``grouped_mm_wgrad``: the
backward's weight products), summed over the profiled window's device
pass, over its rounds; none where the trace has no such kernel."""

import re

from harness import roofline

KERNELS = re.compile(r"(?<![A-Za-z_])(grouped_mm_fwd|grouped_mm_wgrad)")


def read(run):
    t = run.trace
    if not t or not run.profiled_rounds:
        return None
    s = roofline.kernel_time(t["ops"], KERNELS)
    return 1e3 * s / run.profiled_rounds if s > 0 else None
