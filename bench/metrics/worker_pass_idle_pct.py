"""worker_pass_idle_pct: the share of the workers' passes in which the
device is idle, in %: the program's ``ranl.worker_pass`` spans' host
intervals (ns on the profiler's clock) laid over the busy intervals of a
profiler pass that records the device's activity alone, idle time inside
them ÷ their length (``harness/program_trace``).  High where the host
paces the workers' forwards and backwards.  None where the program opens
no such span or the pass saw no device."""

from harness.program_trace import reading


def read(run):
    return reading(run, "worker_pass_idle_pct")
