"""newton_ms: ms a round of the diagonal Newton step
(``ranl_llm.newton_step``: the floor, the trust ratio and the update),
between CUDA events around the program's ``newton_step`` (wrapped by the
traced run; none where the program has no such name)."""

from harness.spans import per_round


def read(run):
    return per_round(run, "newton_step")
