"""Wrappers of the hand-written CUDA RWKV-6 wkv kernel
(``csrc/rwkv_wkv.cu``), which replaces the Pallas TPU kernel
``repro/kernels/rwkv_wkv.py::rwkv_wkv``, and of its backward
(``csrc/rwkv_wkv_bwd.cu``, ``rwkv_wkv_bwd``), which replaces XLA's
autodiff of the reference's checkpointed scan
``repro/models/rwkv.py::_wkv_scan``.

r, k, v, w: (B, S, H, hd), read in their strides with the head dim
contiguous; r, k, v and u (H, hd) in f32 or bf16 (one type), w f32;
state (B, H, hd, hd) f32; hd in {16, 32, 64, 128}.  Returns y (B, S, H,
hd) f32 and the final state.  The library is built with ``nvcc`` at first
use (``build.py``); this module imports on hosts without a card.

The kernel copies r, k, v and w into shared memory with the copy engine
(TMA boxes of a tensor map over each input), and a decode step (S = 1)
reads them as 16-byte vectors: their base addresses and strides must be
16-byte aligned (``check_copy_alignment``).  Its launch
geometry (the tile of the state a lane holds, warps per block, blocks per
(b, h)) is ``launch_geometry``, a pure function of (B, H, hd) and the
card's SM count.  The base addresses of u
and the state must be 16-byte aligned too: they are read as vectors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build
from .launches import LAUNCHES

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COPY_ALIGN = 16         # bytes, for TMA's base addresses and strides
# (rows, cols) of the state a lane holds: the source's instances, fewest
# issued instructions per state entry first; each tile has half the warps
# of the next
TILES = ((8, 2), (4, 2))
WARPS_PER_BLOCK = (4, 2, 1)
WARPS_PER_SM = 8        # resident warps per SM the geometry aims for
BALANCE = 1.25          # busiest SM's warps against the average, at most
# the backward (``csrc/rwkv_wkv_bwd.cu``): a lane holds BWD_LANE_COLS
# columns of a state row; a (b, h)'s rows are spread over a thread-block
# cluster of at most BWD_MAX_CLUSTER blocks of about BWD_THREADS threads;
# a chunk's states fill at most BWD_STATE_BYTES of a block's shared memory
BWD_LANE_COLS = 8
BWD_THREADS = 128
BWD_MAX_CLUSTER = 8
BWD_STATE_BYTES = 32768
BWD_MAX_CHUNK = 64


class Geometry(NamedTuple):
    rows: int               # state rows per lane
    cols: int               # state columns per lane
    lanes: int              # lanes per column block: rows * lanes == hd
    col_blocks: int         # column blocks per warp: 32 // lanes
    warps: int              # warps per block
    blocks_per_head: int    # blocks per (b, h)
    blocks: int             # the grid: B * H * blocks_per_head

    def cells(self, block: int, warp: int, lane: int) -> list:
        """The (row, column) entries of one (b, h)'s state that ``lane``
        of ``warp`` in the ``block``-th block of that head holds (the
        source's ``R * q + e`` and ``col + j``)."""
        q, cb = divmod(lane, self.col_blocks)
        col = ((block * self.warps + warp) * self.col_blocks + cb) * self.cols
        return [(self.rows * q + e, col + j)
                for e in range(self.rows) for j in range(self.cols)]


def _fits(hd: int, rows: int, cols: int) -> bool:
    """The source's ``takes``: a column block's lanes fit in a warp, hold
    at least ``cols`` partial sums to scatter, and a warp's columns fit in
    hd."""
    lanes = hd // rows
    return lanes <= 32 and cols <= lanes and (32 // lanes) * cols <= hd


def launch_geometry(B: int, H: int, hd: int, num_sms: int) -> Geometry:
    """How the kernel spreads the (hd, hd) states of B * H heads over the
    card.  The first tile of ``TILES`` that fits hd and still gives
    ``WARPS_PER_SM`` warps per SM, else the one that gives the most warps.
    Then the most warps per block that keep the busiest SM within
    ``BALANCE`` of the average (or of one block); each (b, h)'s columns
    over as many blocks as that needs."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    fits = [t for t in TILES if _fits(hd, *t)]

    def per_head(tile):                         # warps per (b, h)
        return hd * hd // (tile[0] * tile[1] * 32)
    rows, cols = next(
        (t for t in fits if B * H * per_head(t) >= WARPS_PER_SM * num_sms),
        max(fits, key=per_head))
    lanes = hd // rows
    wph = per_head((rows, cols))
    average = B * H * wph / num_sms
    for warps in WARPS_PER_BLOCK:
        if wph % warps:
            continue
        busiest = -(-B * H * wph // warps // num_sms) * warps
        if busiest <= BALANCE * max(average, warps):
            break
    bph = wph // warps
    return Geometry(rows, cols, lanes, 32 // lanes, warps, bph, B * H * bph)


class BwdGeometry(NamedTuple):
    cols: int               # state columns a lane holds
    cluster: int            # blocks per (b, h): one thread-block cluster
    rows: int               # state rows per block: hd // cluster
    lanes: int              # lanes per state row: hd // cols
    threads: int            # threads per block: rows * lanes
    chunk: int              # steps between checkpoints, rebuilt at once
    smem: int               # dynamic shared memory per block, bytes

    def rows_of(self, block: int) -> range:
        """The state rows (and the dv columns) block ``block`` of a
        cluster owns."""
        return range(block * self.rows, (block + 1) * self.rows)

    def checkpoints(self, B: int, S: int, H: int) -> tuple:
        """The shape of the f32 checkpoint scratch the wrapper allocates."""
        hd = self.lanes * self.cols
        return (B, H, -(-S // self.chunk), hd, hd)


def wkv_bwd_geometry(hd: int, dtype) -> BwdGeometry:
    """The backward kernel's launch geometry for head dim ``hd`` and r's
    type: a lane holds ``BWD_LANE_COLS`` columns of a state row (fewer
    where a row would have under 4 lanes); each (b, h)'s rows go to a
    cluster of ``hd * lanes / BWD_THREADS`` blocks (at least 1, at most
    ``BWD_MAX_CLUSTER``); the chunk is the largest power of two up to
    ``BWD_MAX_CHUNK`` whose states of a block's rows fit
    ``BWD_STATE_BYTES``.  ``smem`` is the source's ``Geo::SMEM``: the
    chunk's states, three ring slots of a chunk's inputs (dy and v, a
    block's rows of w, r and k), and twice (by chunk parity) the warps'
    and the block's dv sums of a chunk and its rows' dr, dk and dw."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if dtype not in _DTYPES:
        raise TypeError(f"r must be float32 or bfloat16, got {dtype}")
    es = dtype.itemsize
    cols = min(BWD_LANE_COLS, hd // 4)
    lanes = hd // cols
    cluster = min(BWD_MAX_CLUSTER, max(1, hd * lanes // BWD_THREADS))
    rows = hd // cluster
    chunk = BWD_MAX_CHUNK
    while chunk > 1 and chunk * rows * hd * 4 > BWD_STATE_BYTES:
        chunk //= 2
    threads = rows * lanes
    warps = threads // 32
    slot = chunk * hd * (4 + es) + chunk * rows * (4 + 2 * es)
    by_parity = chunk * warps * hd * 4 + chunk * hd * 4 + chunk * rows * 16
    smem = chunk * rows * hd * 4 + 3 * slot + 2 * by_parity
    return BwdGeometry(cols, cluster, rows, lanes, threads, chunk, smem)


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry():
    fn = build.library("rwkv_wkv").rwkv_wkv_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
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
    for name, t in (("u", u), ("state", state)):    # read as vectors
        if t.data_ptr() % COPY_ALIGN:
            raise ValueError(f"{name}'s base address is not {COPY_ALIGN}-"
                             f"byte aligned")
    return B, S, H, hd


def check_copy_alignment(r, k, v, w):
    """Raise unless each tensor's base address and the byte strides of its
    batch, sequence and head dims (those of size > 1) are multiples of 16,
    as the kernel's TMA copies need."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.data_ptr() % COPY_ALIGN:
            raise ValueError(f"{name}'s base address is not {COPY_ALIGN}-byte "
                             f"aligned, which TMA needs")
        for i in range(3):
            if t.shape[i] > 1 and (t.stride(i) * t.element_size()) % COPY_ALIGN:
                raise ValueError(f"{name}'s stride {t.stride(i)} in dim {i} "
                                 f"is not a multiple of {COPY_ALIGN} bytes, "
                                 f"which TMA needs")


def rwkv_wkv(r, k, v, w, u, state):
    """Launch the kernel on the current stream without synchronising.
    Returns (y, final state); matches ``ref.rwkv_wkv_ref``."""
    B, S, H, hd = _check(r, k, v, w, u, state)
    check_copy_alignment(r, k, v, w)
    geo = launch_geometry(B, H, hd, _num_sms(r.device.index))
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    s_out = torch.empty_like(state)
    with torch.cuda.device(r.device):
        code = _entry()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            B, S, H, hd, _DTYPES[r.dtype], geo.rows, geo.cols, geo.warps,
            geo.blocks_per_head,
            *(t.stride(i) for t in (r, k, v, w) for i in (0, 1, 2)),
            build.stream_handle(r.device))
    build.check_launch(code, "rwkv_wkv")
    LAUNCHES["rwkv_wkv"] += 1
    return y, s_out


@functools.cache
def _bwd_entry():
    fn = build.library("rwkv_wkv_bwd").rwkv_wkv_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _packed(t):
    """``t`` contiguous at a 16-byte-aligned address (copied if not)."""
    t = t.contiguous()
    return t if t.data_ptr() % COPY_ALIGN == 0 else t.clone()


def bwd_scratch(geo: BwdGeometry, B: int, S: int, H: int, device):
    """The backward kernel's f32 scratch: the checkpoints, (B, H,
    ceil(S / chunk), hd, hd), and du's partial sums a (b, h), (B, H,
    hd)."""
    ckpt = torch.empty(geo.checkpoints(B, S, H), dtype=torch.float32,
                       device=device)
    hd = geo.lanes * geo.cols
    return ckpt, torch.empty((B, H, hd), dtype=torch.float32, device=device)


def rwkv_wkv_bwd(r, k, v, w, u, state, dy, ds):
    """Launch the backward kernel on the current stream without
    synchronising: the gradients of ``rwkv_wkv``'s inputs given dy (B, S,
    H, hd) and ds (B, H, hd, hd), the gradients of y and of the final
    state (f32; packed here when they are not).  Returns (dr, dk, dv, dw,
    du, dstate): dr, dk, dv and du in r's type, dw and dstate f32;
    matches ``ref.rwkv_wkv_bwd_ref``.  Takes what the forward takes."""
    for name, t, like in (("dy", dy, r), ("ds", ds, state)):
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{name} must have shape {tuple(like.shape)}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    B, S, H, hd = _check(r, k, v, w, u, state)
    check_copy_alignment(r, k, v, w)
    dy, ds = _packed(dy), _packed(ds)
    dev = r.device
    dr, dk, dv = (torch.empty((B, S, H, hd), dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    du = torch.empty((H, hd), dtype=r.dtype, device=dev)
    dstate = torch.empty_like(state)
    geo = wkv_bwd_geometry(hd, r.dtype)
    ckpt, du_part = bwd_scratch(geo, B, S, H, dev)
    with torch.cuda.device(dev):
        code = _bwd_entry()(
            *(t.data_ptr() for t in (r, k, v, w, u, state, dy, ds, dr, dk,
                                     dv, dw, du, dstate, ckpt, du_part)),
            B, S, H, hd, _DTYPES[r.dtype], geo.cols, geo.cluster, geo.chunk,
            geo.smem,
            *(t.stride(i) for t in (r, k, v, w) for i in (0, 1, 2)),
            build.stream_handle(dev))
    build.check_launch(code, "rwkv_wkv_bwd")
    LAUNCHES["rwkv_wkv_bwd"] += 1
    return dr, dk, dv, dw, du, dstate
