"""Faults planted underneath the timed path, for the tests and the
readings that set the comparison's limits: each is a context manager
that breaks the program's module attribute the step looks up, and puts
it back on exit.  The benchmark's runs never use them.

* ``unchanged``: a round returns its params and state as it got them;
* ``half_batch``: the loss leaves out the second half of every row's
  positions and takes the mean over the rest;
* ``token_altered``: the loss reads each row's first label as the next
  token id;
* ``exchange_dropped``: the all-reduce between chips does nothing, so
  each rank keeps its own workers' share (a cell on several chips).
"""

from __future__ import annotations

from contextlib import contextmanager

from . import port


@contextmanager
def _patched(module, name, make):
    saved = getattr(module, name)
    setattr(module, name, make(saved))
    try:
        yield
    finally:
        setattr(module, name, saved)


def unchanged():
    rt = port._import()

    def make(step):
        def broken(params, state, *args, **kwargs):
            _, _, metrics = step(params, state, *args, **kwargs)
            return params, state, metrics
        return broken
    return _patched(rt.optim.ranl_llm, "train_step", make)


def half_batch():
    rt = port._import()

    def make(loss):
        def broken(params, batch, cfg, **kwargs):
            half = batch["tokens"].shape[1] // 2
            return loss(params, {k: v[:, :half] for k, v in batch.items()},
                        cfg, **kwargs)
        return broken
    return _patched(rt.models, "lm_loss", make)


def token_altered():
    rt = port._import()

    def make(loss):
        def broken(params, batch, cfg, **kwargs):
            labels = batch["labels"].clone()
            labels[:, 0] = (labels[:, 0] + 1) % cfg.vocab_size
            return loss(params, {**batch, "labels": labels}, cfg, **kwargs)
        return broken
    return _patched(rt.models, "lm_loss", make)


def exchange_dropped():
    port._import()
    from repro_torch.core import collectives as c

    def make(_):
        def broken(self, t, dim, op="sum", *, async_op=False, then=None):
            self._record(dim, op, t)
            return c.Pending(t, None, then)
        return broken
    return _patched(c.Collectives, "all_reduce", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "token_altered": token_altered, "exchange_dropped": exchange_dropped}
