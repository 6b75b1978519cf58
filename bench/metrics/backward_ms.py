"""backward_ms: device ms a round of the workers' backward passes (K3's
or K4's backward kernel and the GEMMs' gradients), the sum of the
program's own ``backward`` spans (CUDA events around
``torch.autograd.grad`` in ``optim.first_order.value_and_grad``) over
the program's tracer pass (``harness/program_trace``); none where the
program opens no such span."""

from harness.program_trace import span_ms


def read(run):
    return span_ms(run, "backward")
