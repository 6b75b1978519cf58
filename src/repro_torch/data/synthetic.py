"""Deterministic synthetic data: next-token batches for the models.

Port of the reference's ``data/synthetic.py`` on a ``torch.Generator``
(tokens are made on the generator's device).  The streams differ from
the reference's by construction — ``jax.random`` and PyTorch draw other
numbers — so tests hand both sides the same numpy tokens instead.
``worker``/``heterogeneity`` skew the token distribution per worker:
worker i draws from a vocab band centered at ``i/N * V`` mixed with the
uniform distribution at rate ``1 - heterogeneity``.
"""

from __future__ import annotations

import torch


def _randint(generator, high, shape):
    return torch.randint(0, high, shape, generator=generator,
                         dtype=torch.int32, device=generator.device)


def _uniform(generator, shape):
    return torch.rand(shape, generator=generator, device=generator.device)


def _token_ids(generator, cfg, shape, worker=None, num_workers: int = 1,
               heterogeneity: float = 0.0):
    V = cfg.vocab_size
    if worker is None or heterogeneity == 0.0:
        return _randint(generator, V, shape)
    band = max(1, V // max(num_workers, 1))
    lo = (worker * band) % V
    skewed = lo + _randint(generator, band, shape)
    uniform = _randint(generator, V, shape)
    pick = _uniform(generator, shape) < heterogeneity
    return torch.where(pick, skewed, uniform)


def _bigram_stream(generator, cfg, batch: int, seq: int, noise: float = 0.1,
                   **kw):
    """Learnable synthetic language: affine bigram chain with noise.

    x_{t+1} = (a·x_t + b) mod V with prob 1−noise, else uniform."""
    V = cfg.vocab_size
    a, b = 31, 17                                   # fixed affine map
    x = _randint(generator, V, (batch,)).long()
    uni = _randint(generator, V, (seq, batch)).long()
    flip = _uniform(generator, (seq, batch)) < noise
    xs = []
    for t in range(seq):
        x = torch.where(flip[t], uni[t], (a * x + b) % V)
        xs.append(x)
    toks = torch.stack(xs, dim=1).to(torch.int32)   # (B, S)
    if cfg.modality == "audio":
        toks = torch.stack([(toks + c) % V
                            for c in range(cfg.num_codebooks)], dim=-1)
    return toks


def token_stream(cfg, generator, batch: int, seq: int,
                 pattern: str = "uniform", **kw):
    """(B, S[, codebooks]) int32 tokens."""
    if pattern == "bigram":
        return _bigram_stream(generator, cfg, batch, seq, **kw)
    shape = ((batch, seq, cfg.num_codebooks) if cfg.modality == "audio"
             else (batch, seq))
    return _token_ids(generator, cfg, shape, **kw)


def make_batch(cfg, generator, batch: int, seq: int, kind: str = "train",
               pattern: str = "uniform", **kw):
    """Batch dict: tokens (and labels for ``kind="train"``; patch
    embeddings for vision configs)."""
    tokens = token_stream(cfg, generator, batch, seq + 1, pattern=pattern,
                          **kw)
    out = {"tokens": tokens[:, :seq]}
    if kind == "train":
        out["labels"] = tokens[:, 1:seq + 1]
    if cfg.modality == "vision":
        out["patch_embeds"] = torch.randn(
            (batch, cfg.vision_tokens, cfg.vision_embed_dim),
            generator=generator, device=generator.device).to(torch.bfloat16)
    return out
