"""The RANL train step as one closure.

Port of the train-step part of the reference's ``launch/steps.py``; its
abstract argument specs and shardings are XLA's and have no counterpart
here (the prefill and decode steps are ``launch/serve.py``'s).
"""

from __future__ import annotations

from ..models import lm_loss
from ..optim import train_step


def make_train_step(cfg, rcfg, *, q_chunk: int = 1024, kv_chunk: int = 1024):
    """-> ``step(params, state, batch, rng)``: one ``train_step`` of RANL
    config ``rcfg`` on the next-token loss of model ``cfg``."""
    def loss_fn(p, b):
        return lm_loss(p, b, cfg, q_chunk=q_chunk, kv_chunk=kv_chunk)

    def step(params, state, batch, rng):
        return train_step(params, state, batch, rng, loss_fn=loss_fn,
                          cfg=rcfg)
    return step
