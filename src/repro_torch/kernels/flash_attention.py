"""Wrappers of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), which replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``, and of its backward
(``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd``), which replaces
XLA's autodiff of the reference's ``repro/models/attention.py::
blocked_attention``.

Causal GQA self-attention with an optional sliding window: q (B, S, H,
hd), k and v (B, S, KV, hd), in f32 or bf16, hd in {32, 64, 128}; the
output is (B, S, H, hd) in q's type.  The source has two bodies, and the
body is a fixed function of (dtype, hd) (``route``), with no fallback from
one to the other:

- ``"tc"``: bf16 at hd 64 and 128.  ``wgmma`` on the tensor cores; Q and
  the K/V tiles arrive by TMA into a ring of shared-memory stages.  TMA
  needs 16-byte-aligned base addresses and strides
  (``check_tma_alignment``); the tensor maps are encoded in C from the
  arguments ``tensor_map_args`` computes.
- ``"simt"``: f32 at every hd, and bf16 at hd 32.  f32 FMAs on the CUDA
  cores, so f32 inputs get full-f32 products.

The backward is one body for both types and every hd, f32 FMAs on the
CUDA cores (three launches: L and D, then dK/dV, then dQ); it takes what
the forward takes and refuses what it refuses.

The libraries are built with ``nvcc`` at first use (``build.py``); this
module imports on hosts without a card.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .launches import LAUNCHES

HEAD_DIMS = (32, 64, 128)
TC_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core body's tiles (namespace tc of the source); its entry
# refuses maps whose boxes differ from these
BLOCK_Q = 128
BLOCK_K = 128
BOX_COLS = 64           # 128 bytes of bf16: the span of the 128-byte swizzle
TMA_ALIGN = 16          # bytes, for base addresses and strides


def route(dtype, hd: int) -> str:
    """The body that computes (dtype, hd): ``"tc"`` or ``"simt"``."""
    if dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    return "tc" if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS else "simt"


@functools.cache
def _entry(body: str):
    lib = build.library("flash_attention")
    if body == "tc":
        fn = lib.flash_attention_tc_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_void_p] * 4)
    else:
        fn = lib.flash_attention_simt_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_longlong] * 9
                       + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = build.library("flash_attention_bwd").flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                   + [ctypes.c_float] + [ctypes.c_longlong] * 15
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


def check_tma_alignment(q, k, v):
    """Raise unless each tensor's base address and the byte strides of its
    batch, sequence and head dims (those of size > 1) are multiples of 16,
    as TMA requires."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"{name}'s base address is not {TMA_ALIGN}-byte "
                             f"aligned, which TMA needs")
        for i in range(3):
            if t.shape[i] > 1 and (t.stride(i) * t.element_size()) % TMA_ALIGN:
                raise ValueError(f"{name}'s stride {t.stride(i)} in dim {i} "
                                 f"is not a multiple of {TMA_ALIGN} bytes, "
                                 f"which TMA needs")


def tensor_map_args(t, rows: int) -> tuple:
    """The 11 arguments of a 4-d TMA map over ``t`` (B, S, heads, hd),
    innermost first: dims (hd, heads, S, B), the byte strides of heads, S
    and B, and the box (64, 1, rows, 1) — one 64-column box of ``rows``
    sequence positions of one head.  A dim of size 1 is never stepped
    over, so its stride is given as if the tensor were packed there."""
    B, S, n, hd = t.shape
    es = t.element_size()
    strides, packed = [], hd * es
    for size, i in ((n, 2), (S, 1), (B, 0)):
        strides.append(t.stride(i) * es if size > 1 else packed)
        packed = strides[-1] * size
    return (hd, n, S, B, *strides, BOX_COLS, 1, rows, 1)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the kernel on the current stream without synchronising.
    Returns (B, S, H, hd) in q.dtype; matches ``ref.flash_attention_ref``."""
    B, S, H, KV, hd = _check(q, k, v)
    body = route(q.dtype, hd)
    if body == "tc":
        check_tma_alignment(q, k, v)
        maps = [(ctypes.c_longlong * 11)(*tensor_map_args(t, rows))
                for t, rows in ((q, BLOCK_Q), (k, BLOCK_K), (v, BLOCK_K))]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        stream = build.stream_handle(q.device)
        if body == "tc":
            code = _entry("tc")(*ptrs, B, S, H, KV, hd, int(bool(causal)),
                                int(window), 1.0 / math.sqrt(hd), *maps,
                                stream)
        else:
            code = _entry("simt")(
                *ptrs, B, S, H, KV, hd, _DTYPES[q.dtype], int(bool(causal)),
                int(window), 1.0 / math.sqrt(hd),
                *(t.stride(i) for t in (q, k, v) for i in (0, 1, 2)), stream)
    build.check_launch(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True,
                        window: int = 0):
    """Launch the backward kernels on the current stream without
    synchronising: the gradients of ``flash_attention`` at (q, k, v),
    given its output ``o`` and the output's gradient ``do`` (B, S, H, hd)
    in q's type, read in their strides (copied where the head dim is not
    contiguous).  Returns (dq (B, S, H, hd), dk, dv (B, S, KV, hd)) in q's
    type; matches ``ref.flash_attention_bwd_ref``."""
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"{name} must have q's shape {tuple(q.shape)},"
                             f" got {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    B, S, H, KV, hd = _check(q, k, v)
    route(q.dtype, hd)
    o, do = (t if t.stride(-1) == 1 else t.contiguous() for t in (o, do))
    dev = q.device
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    dk, dv = (torch.empty((B, S, KV, hd), dtype=q.dtype, device=dev)
              for _ in range(2))
    lse, delta = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
                  for _ in range(2))
    with torch.cuda.device(dev):
        code = _bwd_entry()(
            *(t.data_ptr() for t in (q, k, v, o, do, dq, dk, dv, lse,
                                     delta)),
            B, S, H, KV, hd, _DTYPES[q.dtype], int(bool(causal)),
            int(window), 1.0 / math.sqrt(hd),
            *(t.stride(i) for t in (q, k, v, o, do) for i in (0, 1, 2)),
            build.stream_handle(dev))
    build.check_launch(code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
