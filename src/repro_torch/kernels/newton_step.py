"""Wrapper of the hand-written CUDA Newton step (``csrc/newton_step.cu``):
RANL's diagonal Newton step over every leaf of a round in three
launches, a pass over h, then two over p, g and h.

It ports no Pallas kernel: the reference's step is plain ``jnp``.  It
replaces the port's eager step (``ref.newton_step_ref``, the plain
version), which moved about 72 bytes a parameter in ~11 launches a leaf;
the kernels move 32 (28 where a group's ‖p‖² is given) in 3 launches a
round, whatever the number of leaves.

The leaves come as groups (a per-layer leaf of every layer that holds
it, or one glue leaf), each group's floor and trust ratio taken over all
its leaves.  ``layout`` lays the leaves out in the table the kernels
read: each group is cut into chunks of a size that adapts to the group's
(at least ``MIN_STEPS`` steps of ``STEP`` elements, at most
``MAX_PARTS`` chunks a group but one for each leaf's ragged end), the
largest chunks first.  The table reaches the card in one copy from
pinned memory; the host never waits.  The library is built with
``nvcc`` at first use (``build.py``); this module imports on hosts
without a card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .launches import LAUNCHES

STEP = 2048          # elements a block a step (256 threads, 8 elements each)
MIN_STEPS = 4        # a chunk's least steps
MAX_PARTS = 4096     # chunks a group, but one for each leaf's ragged end
MAX_LEAVES = 8192    # leaves a call (the kernel holds their first chunks in
#                      shared memory)
DN_MIN = 1e-20       # the trust ratio's floor under ‖Δ‖


@functools.cache
def _entry():
    fn = build.library("newton_step").newton_step_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def chunk_elems(total: int) -> int:
    """Elements a chunk of a group of ``total`` elements."""
    return STEP * max(MIN_STEPS, -(-total // (STEP * MAX_PARTS)))


def layout(leaves, groups):
    """The kernels' table.  ``leaves``: [(p, g, h, out addresses, numel,
    group index)] in group order; ``groups``: [(count its mean divides
    by, address of a given Σh or 0, address of a given ‖p‖² or 0)].
    Returns (the table's int64 words, counters zeroed; the number of
    chunks C)."""
    sizes = [0] * len(groups)
    for *_, n, j in leaves:
        sizes[j] += n
    chunk = [chunk_elems(s) for s in sizes]
    # largest chunks first; a group's leaves stay together (stable sort)
    order = sorted(range(len(leaves)), key=lambda k: -chunk[leaves[k][5]])
    words, first, c = [], [None] * len(groups), 0
    parts = [0] * len(groups)
    for k in order:
        p, g, h, out, n, j = leaves[k]
        aligned = all(a % 16 == 0 for a in (p, g, h, out))
        chunks = max(1, -(-n // chunk[j]))
        if first[j] is None:
            first[j] = c
        words += [p, g, h, out, n, chunk[j], c, j | (int(aligned) << 32)]
        parts[j] += chunks
        c += chunks
    for j, (count, hsum, pn2) in enumerate(groups):
        words += [first[j], parts[j], count, hsum, pn2]
    words += [0] * (3 + 2 * len(groups))
    return np.array(words, dtype=np.int64), c


def check(ps, gs, hs, hsum, pn2):
    """Raise on what the kernels do not take; returns the device.  Each
    of ps, gs, hs is a list of groups, each a non-empty list of leaves:
    f32, contiguous, on one CUDA device, p, g and h of a leaf of one
    shape; a given Σh or ‖p‖² a 0-dim f32 tensor on that device."""
    if not (len(ps) == len(gs) == len(hs)) or not ps:
        raise ValueError("ps, gs and hs must be lists of the same groups")
    device = ps[0][0].device if ps[0] else None
    n_leaves = 0
    for j, grp in enumerate(zip(ps, gs, hs)):
        if not grp[0] or not (len(grp[0]) == len(grp[1]) == len(grp[2])):
            raise ValueError(f"group {j} must hold the same number (>= 1) "
                             f"of p, g and h leaves")
        for p, g, h in zip(*grp):
            if not (p.shape == g.shape == h.shape):
                raise ValueError(f"group {j}: p {tuple(p.shape)}, g "
                                 f"{tuple(g.shape)}, h {tuple(h.shape)}")
            for name, t in (("p", p), ("g", g), ("h", h)):
                if t.dtype != torch.float32:
                    raise TypeError(f"{name} must be float32, got {t.dtype}")
                if t.device != device:
                    raise ValueError(f"{name} is on {t.device}, not "
                                     f"{device}")
                if not t.is_contiguous():
                    raise ValueError(f"{name} must be contiguous")
            n_leaves += 1
    if n_leaves > MAX_LEAVES:
        raise ValueError(f"{n_leaves} leaves, the kernel takes at most "
                         f"{MAX_LEAVES}")
    for name, given in (("hsum", hsum), ("pn2", pn2)):
        if given is None:
            continue
        if len(given) != len(ps):
            raise ValueError(f"{name} must have one entry a group")
        for v in given:
            t = v[0] if name == "hsum" and v is not None else v
            if t is not None and (t.dim() != 0 or t.dtype != torch.float32
                                  or t.device != device):
                raise ValueError(f"a given {name} must be a 0-dim float32 "
                                 f"tensor on {device}")
    if device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {device}")
    return device


def newton_step(ps, gs, hs, *, lr, mu, mu_rel, trust, hsum=None, pn2=None,
                between=None):
    """The kernels' Newton step; arguments and result as
    ``ref.newton_step_ref``.  Three launches on the current stream, none
    waited for; the new leaves are new tensors."""
    device = check(ps, gs, hs, hsum, pn2)
    outs = [[torch.empty_like(p) for p in grp] for grp in ps]
    leaves, groups = [], []
    for j, (pg, gg, hg, og) in enumerate(zip(ps, gs, hs, outs)):
        for p, g, h, o in zip(pg, gg, hg, og):
            leaves.append((p.data_ptr(), g.data_ptr(), h.data_ptr(),
                           o.data_ptr(), p.numel(), j))
        given = hsum[j] if hsum is not None else None
        count = given[1] if given is not None else sum(h.numel() for h in hg)
        pn = pn2[j] if pn2 is not None else None
        groups.append((count, 0 if given is None else given[0].data_ptr(),
                       0 if pn is None else pn.data_ptr()))
    words, C = layout(leaves, groups)
    table = torch.from_numpy(words).pin_memory().to(device,
                                                    non_blocking=True)
    G = len(groups)
    work = torch.empty(4 * C + 4 * G, dtype=torch.float32, device=device)
    stats = work[4 * C:].view(G, 4)
    args = (table.data_ptr(), work.data_ptr(), len(leaves), G, C, lr, mu,
            mu_rel, trust, DN_MIN, device.index)
    with torch.cuda.device(device):
        stream = build.stream_handle(device)
        for pass_ in (0, 1):
            build.check_launch(_entry()(pass_, *args, stream), "newton_step")
            LAUNCHES["newton_step"] += 1
        if between is not None:
            between(stats)
        build.check_launch(_entry()(2, *args, stream), "newton_step")
        LAUNCHES["newton_step"] += 1
    return outs, stats
