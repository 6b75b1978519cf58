"""aggregate_ms: ms a round of the server's aggregate
(``ranl_llm.aggregate`` → ``masked_aggregate``, the memory decoded and
encoded), between CUDA events around the program's ``aggregate``
(wrapped by the traced run; none where the program has no such name)."""

from harness.spans import per_round


def read(run):
    return per_round(run, "aggregate")
