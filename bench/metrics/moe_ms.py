"""moe_ms: device ms a round of the expert layers' forward, the sum of
the program's own ``moe.route``, ``moe.experts`` and ``moe.shared`` spans
(CUDA events; ``models.moe.apply_routed_moe``) over the program's tracer
pass (``harness/program_trace``); none where the program opens none of
them.  Not in ``BENCHMARK.json`` yet: ``run.py`` does not run that pass."""

from harness.program_trace import span_ms


def read(run):
    return span_ms(run, "moe.route", "moe.experts", "moe.shared")
