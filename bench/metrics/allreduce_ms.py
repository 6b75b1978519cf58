"""allreduce_ms: device ms a round of the collectives' kernels (NCCL's)
in rank 0's profiled window, over the profiled rounds, from the
profiler's trace.  The bytes each round puts on the wire are the
program's recorder's (``core/collectives.py``), which the run prints on
standard error."""

import re

COLLECTIVES = re.compile(r"nccl", re.IGNORECASE)


def read(run):
    t = run.trace
    if not t or not run.profiled_rounds:
        return None
    ms = 1e3 * sum(v for k, v in t["ops"].items() if COLLECTIVES.search(k))
    return ms / run.profiled_rounds if ms > 0 else None
