"""Hand-written Triton kernels for the RANL server aggregation on Hopper.

Replaces the Pallas TPU kernels ``repro/kernels/region_aggregate.py``:
``_region_aggregate`` (body ``_kernel``) and ``_ranl_update`` (body
``_fused_kernel``).  Per coordinate, over the N ≤ 32 workers:

    count = Σᵢ mᵢ
    ḡ     = Σᵢ gᵢmᵢ / max(count, 1)   if count > 0,  else Σᵢ Cᵢ / N
    C′    = where(m, g, C)
    x′    = x − lr·ḡ / max(h, μ)       (ranl_update only)

What bounds it on this card: memory bandwidth.  The work is a handful of
flops per element of G, M and C, far below the ~20 flops per byte the
H100 needs before arithmetic, not HBM, is the limit.  So the design moves
each byte once: one program per ``BLOCK_D`` slice of coordinates walks
the N worker rows in a register loop (one kernel body; the ``FUSED``
constexpr compiles the ranl_update variant), accumulating count, Σ g·m and Σ C
while it writes row i of C′ in the same iteration; then it finishes ḡ
(and x′) for the slice.  G, M and C are read once and C′ written once:
(13N + 4)·D bytes for region_aggregate and (13N + 12)·D for ranl_update.
The mask is read as one byte per entry (the bool tensor viewed as uint8)
instead of the Pallas wrapper's f32 cast.  The grid needs no padding:
masked loads and stores handle the ragged edge of D.

Triton is imported, and the kernels are compiled, on the first launch;
the module itself imports on hosts without Triton or a GPU.  Compiled
kernels go to Triton's cache (``TRITON_CACHE_DIR``, else its default).
"""

from __future__ import annotations

import functools

import torch

from .launches import LAUNCHES


def _aggregate_kernel(g_ptr, m_ptr, c_ptr, out_c_ptr, out_ptr, x_ptr, h_ptr,
                      N, D, mu, lr, FUSED: tl.constexpr,
                      BLOCK_D: tl.constexpr):
    """One BLOCK_D slice of coordinates: walk the N worker rows, write C′
    row by row, then store ḡ (``FUSED`` off) or x′ (``FUSED`` on)."""
    offs = tl.program_id(0) * BLOCK_D + tl.arange(0, BLOCK_D)
    valid = offs < D
    g_row, m_row, c_row, o_row = (g_ptr + offs, m_ptr + offs, c_ptr + offs,
                                  out_c_ptr + offs)
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


def _launch_config(D: int):
    """(BLOCK_D, num_warps): wide blocks when D fills the card, narrow
    ones so a small D still spreads over several SMs."""
    return (1024, 4) if D >= (1 << 18) else (128, 1)


def _check(grads, masks, memory, vectors=()):
    if grads.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got "
                         f"{grads.device}")
    if grads.dim() != 2:
        raise ValueError(f"grads must be (N, D), got {tuple(grads.shape)}")
    N, D = grads.shape
    for name, t, dtype, shape in (
            [("grads", grads, torch.float32, (N, D)),
             ("masks", masks, torch.bool, (N, D)),
             ("memory", memory, torch.float32, (N, D))]
            + [(n, v, torch.float32, (D,)) for n, v in vectors]):
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
    if N < 1 or D < 1:
        raise ValueError(f"empty input (N={N}, D={D})")
    return N, D


def region_aggregate(grads, masks, memory):
    """grads, memory: (N, D) f32 CUDA; masks: (N, D) bool.
    Returns (global_grad (D,), new_memory (N, D)); launches on the
    current stream without synchronising."""
    N, D = _check(grads, masks, memory)
    out_g = torch.empty((D,), dtype=torch.float32, device=grads.device)
    out_c = torch.empty_like(memory)
    block, warps = _launch_config(D)
    _kernel()[((D + block - 1) // block,)](
        grads, masks.view(torch.uint8), memory, out_c, out_g, out_g, out_g,
        N, D, 0.0, 0.0, FUSED=False, BLOCK_D=block, num_warps=warps)
    LAUNCHES["region_aggregate"] += 1
    return out_g, out_c


def ranl_update(params, hdiag, grads, masks, memory, *, mu: float,
                lr: float = 1.0):
    """Fused aggregation + diagonal projected-Newton step.
    params, hdiag: (D,) f32 CUDA; grads/masks/memory: (N, D).
    Returns (new_params, new_memory)."""
    N, D = _check(grads, masks, memory,
                  (("params", params), ("hdiag", hdiag)))
    out_x = torch.empty_like(params)
    out_c = torch.empty_like(memory)
    block, warps = _launch_config(D)
    _kernel()[((D + block - 1) // block,)](
        grads, masks.view(torch.uint8), memory, out_c, out_x, params, hdiag,
        N, D, float(mu), float(lr), FUSED=True, BLOCK_D=block,
        num_warps=warps)
    LAUNCHES["ranl_update"] += 1
    return out_x, out_c
