"""forward_ms: device ms a round of the workers' forward passes
(``models.lm_loss`` with K3 or K4), the sum of the program's own
``forward`` spans (CUDA events; ``optim.first_order.value_and_grad``)
over the program's tracer pass (``harness/program_trace``); none where
the program opens no such span."""

from harness.program_trace import span_ms


def read(run):
    return span_ms(run, "forward")
