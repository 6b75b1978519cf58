"""peak_mem_gb: ``torch.cuda.max_memory_allocated()`` over set-up and
window (reset at the start of the run), in 10⁹ bytes: RANL's state (the
workers' gradients and the gradient memory beside params and curvature)
decides what fits on a card."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
