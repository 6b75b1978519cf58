"""Decode-cache sizing per config: the part of the reference's
``models/io.py`` that serving needs."""

from __future__ import annotations


def decode_cache_len(cfg, seq_len: int) -> int:
    """KV-cache length for a decode step at context ``seq_len``.

    Contexts beyond the sliding window run the windowed variant, so cache
    state is O(window), not O(context).  RWKV has no KV cache at all
    (O(1) recurrent state).
    """
    if cfg.attn_free:
        return 0
    window = cfg.sliding_window
    if cfg.family == "hybrid":
        return min(seq_len, window)
    if seq_len > 32_768:  # long-context: windowed variant required
        return window
    return seq_len


def decode_window(cfg, seq_len: int) -> int:
    """Attention window used by serve_step at context ``seq_len``."""
    if cfg.attn_free:
        return 0
    if cfg.family == "hybrid":
        return cfg.sliding_window
    return cfg.sliding_window if seq_len > 32_768 else 0
