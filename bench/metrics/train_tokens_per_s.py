"""train_tokens_per_s: every token of every round the window finished
(global batch × sequence a round), over the window's wall time, which
ends in ``torch.cuda.synchronize()`` (host clock)."""


def read(run):
    if not getattr(run, "window_s", None):
        return None
    return run.rounds * run.tokens_per_round / run.window_s
