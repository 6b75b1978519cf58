"""Hand-written Triton kernels for the RANL server aggregation on Hopper.

Replaces the Pallas TPU kernels ``repro/kernels/region_aggregate.py``:
``_region_aggregate`` (body ``_kernel``) and ``_ranl_update`` (body
``_fused_kernel``).  Per coordinate, over the N ≤ 32 workers:

    count = Σᵢ mᵢ
    ḡ     = Σᵢ gᵢmᵢ / max(count, 1)   if count > 0,  else Σᵢ Cᵢ / N
    C′    = where(m, g, C)
    x′    = x − lr·ḡ / max(h, μ)       (ranl_update only)

What bounds it on this card: memory bandwidth at large D, the latency of
one DRAM round trip at the main path's D.  The work is a handful of flops
per element of G, M and C, far below the ~20 flops per byte the H100
needs before arithmetic, not HBM, is the limit.  So the design moves each
byte once, and keeps as many of them in flight as the shape allows.  One
kernel body (the ``FUSED`` constexpr compiles the ranl_update variant)
has two ways through a ``BLOCK_D`` slice of coordinates, fixed by
``_launch_config``:

- all rows at once (N ≤ 32, D below 2¹⁸): one ``[BLOCK_N, BLOCK_D]`` tile
  of G, M and C (BLOCK_N the next power of two ≥ N, rows masked), so every
  row's loads are in flight together; C′ is stored as one tile and count,
  Σ g·m and Σ C are sums over the tile's rows.  BLOCK_D is narrow enough
  that the grid has about two programs for each of the 132 SMs;
- the row loop (large D, or N > 32): 1024-wide slices, each program
  walking the N rows in a register loop and writing row i of C′ as it
  goes; at large D the grid alone keeps HBM busy.

Then it finishes ḡ (and x′) for the slice.  The batch engine's B seeds
go in one launch: the grid is (D-blocks, B), axis 1 offsetting every
pointer by its seed's stride, and ``_launch_config`` counts programs over
both axes, so at B = 8 the tile is narrower and the programs as many.  G, M and C are read once and
C′ written once: (13N + 4)·D bytes for region_aggregate and (13N + 12)·D
for ranl_update.  The mask is read as one byte per entry (the bool tensor
viewed as uint8) instead of the Pallas wrapper's f32 cast.  The grid
needs no padding: masked loads and stores handle the ragged edges.

Triton is imported, and the kernels are compiled, on the first launch;
the module itself imports on hosts without Triton or a GPU.  Compiled
kernels go to Triton's cache (``TRITON_CACHE_DIR``, else its default).
"""

from __future__ import annotations

import functools

import torch

from .launches import LAUNCHES


def local_region_ids(dim: int, num_regions: int, offset: int, size: int,
                     device):
    """Region id per coordinate of the slice [offset, offset+size) of a
    ``dim``-coordinate vector partitioned into ``num_regions`` contiguous
    regions: a model shard of the 2-D engine expands its (N, Q) region
    masks into masks of its own coordinates with these, so K2 and the
    plain aggregation work on d-slices."""
    from ..core.regions import contiguous_regions
    ids = contiguous_regions(dim, num_regions, device)
    return ids[offset:offset + size]


def _aggregate_kernel(g_ptr, m_ptr, c_ptr, out_c_ptr, out_ptr, x_ptr, h_ptr,
                      N, D, mu, lr, FUSED: tl.constexpr,
                      BLOCK_N: tl.constexpr, BLOCK_D: tl.constexpr):
    """One BLOCK_D slice of coordinates of one seed: the N worker rows as
    one tile (``BLOCK_N`` > 0) or in a loop (``BLOCK_N`` = 0), C′
    written, then ḡ (``FUSED`` off) or x′ (``FUSED`` on) stored.  Axis 1
    of the grid is the seed: every pointer moves by its seed's stride."""
    seed = tl.program_id(1).to(tl.int64)
    g_ptr += seed * N * D
    m_ptr += seed * N * D
    c_ptr += seed * N * D
    out_c_ptr += seed * N * D
    out_ptr += seed * D
    x_ptr += seed * D
    h_ptr += seed * D
    offs = tl.program_id(0) * BLOCK_D + tl.arange(0, BLOCK_D)
    valid = offs < D
    if BLOCK_N > 0:
        rows = tl.arange(0, BLOCK_N)
        idx = rows[:, None] * D + offs[None, :]
        ok = (rows[:, None] < N) & valid[None, :]
        g = tl.load(g_ptr + idx, mask=ok, other=0.0)
        m = tl.load(m_ptr + idx, mask=ok, other=0) != 0
        c = tl.load(c_ptr + idx, mask=ok, other=0.0)
        tl.store(out_c_ptr + idx, tl.where(m, g, c), mask=ok)
        mf = m.to(tl.float32)
        count = tl.sum(mf, axis=0)
        fresh = tl.sum(g * mf, axis=0)
        stale = tl.sum(c, axis=0)
    else:
        g_row, m_row, c_row, o_row = (g_ptr + offs, m_ptr + offs,
                                      c_ptr + offs, out_c_ptr + offs)
        count = tl.zeros([BLOCK_D], dtype=tl.float32)
        fresh = tl.zeros([BLOCK_D], dtype=tl.float32)
        stale = tl.zeros([BLOCK_D], dtype=tl.float32)
        for _ in range(N):
            g = tl.load(g_row, mask=valid, other=0.0)
            m = tl.load(m_row, mask=valid, other=0) != 0
            c = tl.load(c_row, mask=valid, other=0.0)
            mf = m.to(tl.float32)
            count += mf
            fresh += g * mf
            stale += c
            tl.store(o_row, tl.where(m, g, c), mask=valid)
            g_row += D
            m_row += D
            c_row += D
            o_row += D
    gbar = tl.where(count > 0, fresh / tl.maximum(count, 1.0), stale / N)
    if FUSED:
        x = tl.load(x_ptr + offs, mask=valid, other=0.0)
        h = tl.load(h_ptr + offs, mask=valid, other=1.0)
        gbar = x - (lr * gbar) / tl.maximum(h, mu)
    tl.store(out_ptr + offs, gbar, mask=valid)


@functools.cache
def _kernel():
    """Import Triton and wrap the kernel body (once per process)."""
    import triton
    import triton.language

    globals()["tl"] = triton.language     # the body's ``tl`` name
    return triton.jit(_aggregate_kernel)


TILE_MAX_N = 32             # more rows take the row loop: the tile's
                            # registers are sized for 32, and no path has more
TILE_MAX_D = 1 << 18        # from here on the row loop fills the card
TILE_ELEMS = 4096           # largest tile: 32 f32 registers a thread at 4 warps
MIN_PROGRAMS = 256          # about two for each of 132 SMs


def _launch_config(N: int, D: int, B: int = 1):
    """(BLOCK_N, BLOCK_D, num_warps) for B seeds of (N, D).  Below
    ``TILE_MAX_D`` (and N ≤ 32): all rows as one tile, BLOCK_D the widest
    power of two from 16 up that still gives ``MIN_PROGRAMS`` programs
    over the D-blocks of all B seeds, within ``TILE_ELEMS`` elements a
    tile, one warp per 512 of them.  Else the row loop (BLOCK_N = 0) over
    1024-wide slices with 4 warps."""
    if D >= TILE_MAX_D or N > TILE_MAX_N:
        return 0, 1024, 4
    block_n = max(2, 1 << (N - 1).bit_length())
    block_d = 16
    while (block_d * 2 * block_n <= TILE_ELEMS
           and -(-D // (block_d * 2)) * B >= MIN_PROGRAMS):
        block_d *= 2
    return block_n, block_d, max(1, min(4, block_n * block_d // 512))


def _check(grads, masks, memory, vectors=()):
    """-> (B, N, D) for (N, D) inputs with (D,) vectors (B = 1) or
    (B, N, D) inputs with (B, D) vectors; raises on anything else."""
    if grads.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got "
                         f"{grads.device}")
    if grads.dim() not in (2, 3):
        raise ValueError(f"grads must be (N, D) or (B, N, D), got "
                         f"{tuple(grads.shape)}")
    lead = tuple(grads.shape[:-2])
    N, D = grads.shape[-2:]
    for name, t, dtype, shape in (
            [("grads", grads, torch.float32, lead + (N, D)),
             ("masks", masks, torch.bool, lead + (N, D)),
             ("memory", memory, torch.float32, lead + (N, D))]
            + [(n, v, torch.float32, lead + (D,)) for n, v in vectors]):
        if t.device != grads.device:
            raise ValueError(f"{name} is on {t.device}, grads on "
                             f"{grads.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B = lead[0] if lead else 1
    if B < 1 or N < 1 or D < 1:
        raise ValueError(f"empty input (B={B}, N={N}, D={D})")
    return B, N, D


def _launch(shape, grads, masks, memory, out_c, out, x, h, mu, lr, fused):
    B, N, D = shape
    block_n, block, warps = _launch_config(N, D, B)
    _kernel()[((D + block - 1) // block, B)](
        grads, masks.view(torch.uint8), memory, out_c, out, x, h, N, D,
        float(mu), float(lr), FUSED=fused, BLOCK_N=block_n, BLOCK_D=block,
        num_warps=warps)


def region_aggregate(grads, masks, memory):
    """grads, memory: (N, D) or (B, N, D) f32 CUDA; masks: bool, the same
    shape.  Returns (global_grad (D,) or (B, D), new_memory): one launch
    for all B seeds, on the current stream, without synchronising."""
    shape = _check(grads, masks, memory)
    out_g = torch.empty(grads.shape[:-2] + grads.shape[-1:],
                        dtype=torch.float32, device=grads.device)
    out_c = torch.empty_like(memory)
    _launch(shape, grads, masks, memory, out_c, out_g, out_g, out_g, 0.0,
            0.0, False)
    LAUNCHES["region_aggregate"] += 1
    return out_g, out_c


def ranl_update(params, hdiag, grads, masks, memory, *, mu: float,
                lr: float = 1.0):
    """Fused aggregation + diagonal projected-Newton step.
    params, hdiag: (D,) f32 CUDA with grads/masks/memory (N, D), or (B, D)
    with (B, N, D).  Returns (new_params, new_memory): one launch."""
    shape = _check(grads, masks, memory,
                   (("params", params), ("hdiag", hdiag)))
    out_x = torch.empty_like(params)
    out_c = torch.empty_like(memory)
    _launch(shape, grads, masks, memory, out_c, out_x, params, hdiag, mu, lr,
            True)
    LAUNCHES["ranl_update"] += 1
    return out_x, out_c
