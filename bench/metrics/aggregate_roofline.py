"""aggregate_roofline: the aggregate's least time on the card over its
time, in %.  The aggregate reads every worker's f32 gradient G and its
memory C, writes the new memory and the f32 aggregate g: (4 + 2·c)·N·P
+ 4·P bytes for N workers, P parameters and a memory of c bytes an
element ((8N + 4)·P in bfloat16), at the configuration's
``peak.hbm_bytes_per_s``; the time is ``aggregate_ms``'s span."""

import math

from harness.roofline import DTYPE_BYTES
from harness.spans import per_round


def aggregate_bytes(specs, workers: int, memory_dtype: str) -> int:
    P = sum(math.prod(shape) for _, shape, _ in specs)
    return (4 + 2 * DTYPE_BYTES[memory_dtype]) * workers * P + 4 * P


def read(run):
    ms = per_round(run, "aggregate")
    if ms is None or run.device != "cuda":
        return None
    nbytes = aggregate_bytes(run.specs, run.traffic["workers"],
                             run.traffic["ranl"]["memory_dtype"])
    return 100.0 * nbytes / run.cfg["peak"]["hbm_bytes_per_s"] / (ms * 1e-3)
