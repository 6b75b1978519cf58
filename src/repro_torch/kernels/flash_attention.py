"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.

Causal GQA self-attention with an optional sliding window: q (B, S, H,
hd), k and v (B, S, KV, hd), in f32 or bf16, hd in {32, 64, 128}; the
output is (B, S, H, hd) in q's type.  The library is built with ``nvcc``
at first use (``build.py``); this module imports on hosts without a card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .launches import LAUNCHES

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    fn = build.library("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_longlong] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, hd)")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, S, KV, hd) = "
                         f"{(B, S, KV, hd)} (self-attention, Sq == Skv); "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if S < 1 or B < 1:
        raise ValueError(f"empty input (B={B}, S={S})")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    return B, S, H, KV, hd


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel on the current stream without synchronising.
    Returns (B, S, H, hd) in q.dtype; matches ``ref.flash_attention_ref``."""
    B, S, H, KV, hd = _check(q, k, v)
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        code = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, H, KV, hd, _DTYPES[q.dtype], int(bool(causal)),
            int(window), 1.0 / math.sqrt(hd),
            *(t.stride(i) for t in (q, k, v) for i in (0, 1, 2)),
            build.stream_handle(q.device))
    build.check_launch(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
