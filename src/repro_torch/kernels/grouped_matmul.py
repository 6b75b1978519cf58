"""Wrapper of the hand-written CUDA grouped matrix product over the
experts held on one card (``csrc/grouped_matmul.cu``;
``models.moe.apply_routed_moe``):

    y[rows of g] = x[rows of g] · w[g]            for the G groups,

the rows of group g being [offsets[g], offsets[g+1]) of x, with the
offsets an int32 tensor on the card, so the host never learns a group's
size.  A row outside every group is written as 0; an empty group is
allowed.  Its backward has two products: dx = dy · w[g]ᵀ (the forward's
kernel reading w[g] as its transpose, ``grouped_matmul_dx``) and dw[g] =
x[rows of g]ᵀ · dy[rows of g] (``grouped_matmul_wgrad``).

It ports no Pallas kernel: the JAX package's MoE multiplies a capacity
buffer (E, C, d) and drops the tokens past capacity.  PyTorch's private
``torch._grouped_mm`` computes the same product; the port does not call
it.  Products are IEEE f32 fused multiply-adds, no TF32.

The library is built with ``nvcc`` at first use (``build.py``); this
module imports on hosts without a card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .launches import LAUNCHES

BLOCK_ROWS = 128       # a block's output rows, as the C source has them
MAX_GRID_Y = 65535


@functools.cache
def _entries():
    lib = build.library("grouped_matmul")
    fwd, wgrad = lib.grouped_mm_launch, lib.grouped_mm_wgrad_launch
    fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                    + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p])
    wgrad.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                      + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fwd.restype = wgrad.restype = ctypes.c_int
    return fwd, wgrad


def _check_offsets(offsets, groups: int, device):
    if (offsets.dtype != torch.int32 or tuple(offsets.shape) != (groups + 1,)
            or not offsets.is_contiguous()):
        raise ValueError(f"offsets must be ({groups + 1},) contiguous int32, "
                         f"got {tuple(offsets.shape)} {offsets.dtype}")
    if offsets.device != device:
        raise ValueError(f"offsets are on {offsets.device}, the operands on "
                         f"{device}")


def _check_f32(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the kernel takes CUDA tensors, {name} is on "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _rows(t):
    """t with its inner axis contiguous and its rows 16-byte aligned
    (a contiguous copy where they are not)."""
    if (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def check(x, w, offsets):
    """Raise on what the product does not take; returns (M, K, N, G).
    x (M, K) and w (G, K, N) f32, K and N multiples of 4; offsets (G + 1,)
    int32, contiguous; all on one CUDA device."""
    _check_f32(x=x, w=w)
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x must be (M, K) and w (G, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    M, K, N, G = x.shape[0], x.shape[1], w.shape[2], w.shape[0]
    if K % 4 or N % 4:
        raise ValueError(f"K and N must be multiples of 4, got {K} and {N}")
    if G < 1 or -(-M // BLOCK_ROWS) + G + 2 > MAX_GRID_Y:
        raise ValueError(f"{M} rows in {G} groups: more than the grid holds")
    _check_offsets(offsets, G, x.device)
    return M, K, N, G


def _product(x, w, offsets, trans: bool):
    """y (M, N) = x · w[g] by groups; ``trans``: w[g] is (N, K), read as
    its transpose."""
    M, _, _, G = check(x, w.transpose(1, 2) if trans else w, offsets)
    x, w = _rows(x), _rows(w)
    K, N = x.shape[1], (w.shape[1] if trans else w.shape[2])
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _entries()[0](x.data_ptr(), w.data_ptr(), y.data_ptr(),
                             offsets.data_ptr(), M, K, N, G, x.stride(0),
                             w.stride(0), w.stride(1), y.stride(0),
                             int(trans), build.stream_handle(x.device))
    build.check_launch(code, "grouped_matmul")
    return y


def grouped_matmul(x, w, offsets):
    """x (M, K), w (G, K, N) f32 CUDA; offsets (G+1,) int32 CUDA -> y
    (M, N) f32, as ``ref.grouped_matmul_ref``.  One launch on the current
    stream, without synchronising."""
    y = _product(x, w, offsets, trans=False)
    LAUNCHES["grouped_matmul"] += 1
    return y


def grouped_matmul_dx(dy, w, offsets):
    """dy (M, N), w (G, K, N) -> dx (M, K) = dy[rows of g] · w[g]ᵀ, w read
    in place.  One launch."""
    dx = _product(dy, w, offsets, trans=True)
    LAUNCHES["grouped_matmul_bwd"] += 1
    return dx


def grouped_matmul_wgrad(x, dy, offsets, groups: int):
    """x (M, K), dy (M, N) -> dw (groups, K, N) f32 = x[rows of g]ᵀ ·
    dy[rows of g], as ``ref.grouped_matmul_wgrad_ref``.  One launch."""
    _check_f32(x=x, dy=dy)
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"x must be (M, K) and dy (M, N), got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if dy.device != x.device:
        raise ValueError(f"dy is on {dy.device}, x on {x.device}")
    K, N = x.shape[1], dy.shape[1]
    if K % 4 or N % 4:
        raise ValueError(f"K and N must be multiples of 4, got {K} and {N}")
    if not 1 <= groups <= MAX_GRID_Y or -(-K // BLOCK_ROWS) > MAX_GRID_Y:
        raise ValueError(f"{groups} groups of ({K}, {N}): more than the grid "
                         f"holds")
    _check_offsets(offsets, groups, x.device)
    x, dy = _rows(x), _rows(dy)
    dw = torch.empty((groups, K, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _entries()[1](x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                             offsets.data_ptr(), K, N, groups, x.stride(0),
                             dy.stride(0), build.stream_handle(x.device))
    build.check_launch(code, "grouped_matmul_wgrad")
    LAUNCHES["grouped_matmul_bwd"] += 1
    return dw
