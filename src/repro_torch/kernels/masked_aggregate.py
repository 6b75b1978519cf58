"""Wrapper of the hand-written CUDA masked aggregate
(``csrc/masked_aggregate.cu``): one leaf of RANL's server aggregate
(``optim/ranl_llm.py::aggregate``) in one pass over the leaf.

It ports no Pallas kernel: the reference's ``masked_aggregate`` is plain
``jnp``.  It replaces the port's eager loop (``ref.masked_aggregate_ref``,
the plain version), whose memory decode, six elementwise kernels a worker
and encode made two (N, *leaf) f32 temporaries and thousands of launches
a round.  The kernel reads G and the stored memory once and writes g and
the new memory once, in the memory's own type: bf16, f16 or f32 (an int8
memory is decoded to f32 before it and encoded after it).

The mask stays on the card: each block reads the N bytes itself, so the
host never waits.  The library is built with ``nvcc`` at first use
(``build.py``); this module imports on hosts without a card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .launches import LAUNCHES

# the memory types the kernel takes, by the code its C entry reads
MEMORY_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


@functools.cache
def _entry():
    fn = build.library("masked_aggregate").masked_aggregate_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(G, mask, C):
    """Raise on what the kernel does not take; returns (N, P).  G (N,
    *leaf) f32 and C of the same shape in a type of ``MEMORY_CODES``, both
    contiguous; mask (N,) bool at any stride; all on G's device."""
    if G.dim() < 1 or G.shape[0] < 1:
        raise ValueError(f"G must be (N, *leaf) with N >= 1, got "
                         f"{tuple(G.shape)}")
    if G.dtype != torch.float32:
        raise TypeError(f"G must be float32, got {G.dtype}")
    if C.dtype not in MEMORY_CODES:
        raise TypeError(f"the memory must be one of "
                        f"{sorted(str(t) for t in MEMORY_CODES)}, got "
                        f"{C.dtype}")
    if tuple(C.shape) != tuple(G.shape):
        raise ValueError(f"C has shape {tuple(C.shape)}, G "
                         f"{tuple(G.shape)}")
    N = G.shape[0]
    if mask.dtype != torch.bool or tuple(mask.shape) != (N,):
        raise ValueError(f"mask must be ({N},) bool, one a worker, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    for name, t in (("C", C), ("mask", mask)):
        if t.device != G.device:
            raise ValueError(f"{name} is on {t.device}, G on {G.device}")
    if not (G.is_contiguous() and C.is_contiguous()):
        raise ValueError("G and C must be contiguous")
    return N, G[0].numel()


def masked_aggregate(G, mask, C):
    """(g, C_new) of one leaf: g shaped like the leaf, f32; C_new like C,
    in C's type.  One launch on the current stream, without
    synchronising; matches ``ref.masked_aggregate_ref`` run on the card
    bit for bit (an uncovered leaf's C / N as C times the f32 reciprocal
    of N, as PyTorch divides by a number there)."""
    if G.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {G.device}")
    N, P = check(G, mask, C)
    g = torch.empty(G.shape[1:], dtype=torch.float32, device=G.device)
    C_new = torch.empty(C.shape, dtype=C.dtype, device=C.device)
    if P == 0:
        return g, C_new
    with torch.cuda.device(G.device):
        code = _entry()(G.data_ptr(), C.data_ptr(), mask.data_ptr(),
                        mask.stride(0), g.data_ptr(), C_new.data_ptr(), N,
                        P, MEMORY_CODES[C.dtype], G.device.index,
                        build.stream_handle(G.device))
    build.check_launch(code, "masked_aggregate")
    LAUNCHES["masked_aggregate"] += 1
    return g, C_new
