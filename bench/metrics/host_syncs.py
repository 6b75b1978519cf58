"""host_syncs: the times a round in which the program's host waits on
the device at a place the program counts (``obs.count("host_syncs")``:
``apply_attention``'s positions check, the mesh path's copy of the masks
to the host), rank 0's, from the program's tracer pass
(``harness/program_trace``); none where the program's tracer keeps no
counters."""

from harness.program_trace import reading


def read(run):
    counters = reading(run, "counters")
    return None if counters is None else counters.get("host_syncs", 0.0)
