"""Wrapper of the hand-written CUDA RWKV-6 wkv kernel
(``csrc/rwkv_wkv.cu``), which replaces the Pallas TPU kernel
``repro/kernels/rwkv_wkv.py::rwkv_wkv``.

r, k, v, w: (B, S, H, hd), read in their strides with the head dim
contiguous; r, k, v and u (H, hd) in f32 or bf16 (one type), w f32;
state (B, H, hd, hd) f32; hd in {16, 32, 64, 128}.  Returns y (B, S, H,
hd) f32 and the final state.  The library is built with ``nvcc`` at first
use (``build.py``); this module imports on hosts without a card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .launches import LAUNCHES

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    fn = build.library("rwkv_wkv").rwkv_wkv_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, w, u, state):
    if r.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {r.device}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, hd), got {tuple(r.shape)}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if S < 1 or B < 1 or H < 1:
        raise ValueError(f"empty input {tuple(r.shape)}")
    if r.dtype not in _DTYPES:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    for name, t, dtype, shape in (
            ("k", k, r.dtype, (B, S, H, hd)), ("v", v, r.dtype, (B, S, H, hd)),
            ("w", w, torch.float32, (B, S, H, hd)),
            ("u", u, r.dtype, (H, hd)),
            ("state", state, torch.float32, (B, H, hd, hd))):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    for name, t in (("u", u), ("state", state)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, S, H, hd


def rwkv_wkv(r, k, v, w, u, state):
    """Launch the kernel on the current stream without synchronising.
    Returns (y, final state); matches ``ref.rwkv_wkv_ref``."""
    B, S, H, hd = _check(r, k, v, w, u, state)
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state)
    with torch.cuda.device(r.device):
        code = _entry()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            B, S, H, hd, _DTYPES[r.dtype],
            *(t.stride(i) for t in (r, k, v, w) for i in (0, 1, 2)),
            build.stream_handle(r.device))
    build.check_launch(code, "rwkv_wkv")
    LAUNCHES["rwkv_wkv"] += 1
    return y, s_out
