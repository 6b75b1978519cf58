"""step_mfu_pct: the model FLOPs of a round over its time and the card's
peak, in %.  Model FLOPs: 6 × the parameters used in matrix products ×
the round's tokens (a tied head once, the embedding lookup not at all),
plus the architecture's attention or recurrence FLOPs, nothing
recomputed (``reference/<arch>.py``).  The time is the ``train_step``
span's (CUDA events) over the traced run's span rounds; the peak is the
configuration's ``peak.flops_per_s`` (the training dtype's), times the
chips."""

from harness.spans import per_round


def round_flops(arch, cfg, traffic) -> float:
    B, S = traffic["batch"], traffic["seq"]
    return 6.0 * arch.matmul_params(cfg) * B * S + arch.extra_flops(cfg, B, S)


def read(run):
    ms = per_round(run, "train_step")
    if ms is None or run.device != "cuda":
        return None
    flops = round_flops(run.arch, run.cfg, run.traffic)
    return 100.0 * flops / (ms * 1e-3 * run.cfg["peak"]["flops_per_s"]
                            * run.chips)
