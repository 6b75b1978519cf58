"""What the kernels' roofline metrics share: a launch's least time at
the configuration's peaks, and the profiler's device time of the
kernels a metric names.  Each ``metrics/<kernel>_roofline.py`` keeps its
own cost functions, kernel names, launch counters and shape."""

from __future__ import annotations

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(cost, peak) -> float:
    """The larger of bytes at the peak bandwidth and FLOPs at the peak
    rate, for ``cost`` = (bytes, FLOPs)."""
    nbytes, flops = cost
    return max(nbytes / peak["hbm_bytes_per_s"], flops / peak["flops_per_s"])


def kernel_time(ops: dict, kernels) -> float:
    """Device seconds of the operations whose names ``kernels`` (a
    compiled pattern) finds, PyTorch's own kernels left out."""
    return sum(v for k, v in ops.items()
               if kernels.search(k) and "at::" not in k)


def read(run, kernels, shape: str, counters, fwd_cost, bwd_cost):
    """Σ over the device pass's launches (``counters``: the forward's
    and the backward's) of their bound ÷ Σ the kernels' device time, in
    %; None where the run traced none.  ``shape``: the key of one
    worker's call in the architecture's ``kernel_shapes``."""
    t = run.trace
    args = run.arch.kernel_shapes(
        run.cfg, run.traffic["batch"] // run.traffic["workers"],
        run.traffic["seq"]).get(shape)
    if not t or args is None:
        return None
    dev = kernel_time(t["ops"], kernels)
    n_f, n_b = (t["launches"].get(c, 0) for c in counters)
    if dev <= 0 or not (n_f or n_b):
        return None
    es, peak = DTYPE_BYTES[run.cfg["dtype"]], run.cfg["peak"]
    least = (n_f * bound_s(fwd_cost(*args, es), peak)
             + n_b * bound_s(bwd_cost(*args, es), peak))
    return 100.0 * least / dev
