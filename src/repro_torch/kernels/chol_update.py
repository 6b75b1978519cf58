"""Wrapper of the hand-written CUDA low-rank Cholesky update
(``csrc/chol_update.cu``): the lower factor of L Lᵀ + Σⱼ αⱼ vⱼ vⱼᵀ, one
launch for up to ``MAX_RANK`` vectors.

It ports no Pallas kernel: it replaces the reference's rank-1 sweeps, one
compiled ``lax.scan`` each (``repro/core/compression.py::
chol_rank1_update``), which the port first ran as a Python loop of a few
small launches a column (``ref.chol_update_ref``, the plain twin).  The
low-rank init (``core/compression.py::lowrank_hmu_factor``) calls it once
per worker.

L is (n, n) f32 and column-major (``L.mT`` contiguous): column k of L is
then one contiguous row of memory, which the kernel's warps read and
write coalesced.  The result is a new column-major tensor; L's strictly
upper triangle is carried over as it is.  The library is built with
``nvcc`` at first use (``build.py``); this module imports on hosts
without a card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .launches import LAUNCHES

MAX_RANK = 8            # vectors one launch folds in (the source's instances)


@functools.cache
def _entry():
    lib = build.library("chol_update")
    fn = lib.chol_update_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    if lib.chol_update_max_rank() != MAX_RANK:
        raise RuntimeError("chol_update: the library's MAX_RANK differs "
                           "from the wrapper's")
    return fn


@functools.cache
def _chain_entry():
    fn = build.library("chol_update").chol_chain_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chain(n: int, device) -> torch.Tensor:
    """Launch ``chol_chain_kernel`` on the current stream: the dependent
    path of one column (a diagonal rotation feeding one application) n
    times over in one thread, the least time the update's chain of n
    columns can take.  A measurement, not part of the update: it counts
    no launch.  Returns the (1,) tensor it writes."""
    out = torch.empty(1, dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        code = _chain_entry()(n, out.data_ptr(),
                              build.stream_handle(out.device))
    build.check_launch(code, "chol_chain")
    return out


@functools.cache
def _div_check_entry():
    fn = build.library("chol_update").chol_div_check_launch
    fn.argtypes = [ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def div_check(n: int, seed: int, device) -> int:
    """How many of n operand pairs (made on the card from ``seed``, over
    the range the kernel's branch-free division takes) that division
    rounds apart from ``__fdiv_rn`` in any bit (synchronises)."""
    out = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        code = _div_check_entry()(n, seed, out.data_ptr(),
                                  build.stream_handle(out.device))
    build.check_launch(code, "chol_div_check")
    return int(out.item())


def _check(L, V, alpha):
    if L.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {L.device}")
    if L.dim() != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"L must be (n, n), got {tuple(L.shape)}")
    n = L.shape[0]
    if V.dim() != 2 or V.shape[1] != n or V.shape[0] < 1:
        raise ValueError(f"V must be (r, {n}) with r >= 1, got "
                         f"{tuple(V.shape)}")
    r = V.shape[0]
    for name, t, shape in (("L", L, (n, n)), ("V", V, (r, n)),
                           ("alpha", alpha, (r,))):
        if t.device != L.device:
            raise ValueError(f"{name} is on {t.device}, L on {L.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    if not L.mT.is_contiguous():
        raise ValueError("L must be column-major (L.mT contiguous)")
    if not (V.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("V and alpha must be contiguous")
    return n, r


def chol_update(L, V, alpha):
    """Lower factor of ``L Lᵀ + Σⱼ alpha[j] V[j] V[j]ᵀ`` (alpha clamped at
    0), column-major like L: one launch per ``MAX_RANK`` rows of V, on the
    current stream, without synchronising.  Matches
    ``ref.chol_update_ref``."""
    n, r = _check(L, V, alpha)
    out = L.clone()                         # column-major, as L
    with torch.cuda.device(L.device):
        stream = build.stream_handle(L.device)
        for j0 in range(0, r, MAX_RANK):
            rr = min(MAX_RANK, r - j0)
            cs = torch.empty(n * 2 * rr, dtype=torch.float32,
                             device=L.device)
            sync = torch.zeros(2, dtype=torch.int32, device=L.device)
            code = _entry()(out.data_ptr(), V[j0:j0 + rr].data_ptr(),
                            alpha[j0:j0 + rr].data_ptr(), n, rr,
                            cs.data_ptr(), sync.data_ptr(), stream)
            build.check_launch(code, "chol_update")
            LAUNCHES["chol_update"] += 1
    return out
