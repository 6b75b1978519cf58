"""fwd_bwd_ms: ms a round of the workers' forwards and backwards
(``ranl_llm.per_worker_grads`` → ``models.lm_loss``, with K3 or K4 and
their backward kernels), between CUDA events around the program's
``per_worker_grads`` (wrapped by the traced run; none where the program
has no such name)."""

from harness.spans import per_round


def read(run):
    return per_round(run, "per_worker_grads")
