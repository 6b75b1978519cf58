"""Plain PyTorch versions of the hand-written kernels.

They define what each kernel computes: the tests hold the kernels (and
the reference's Pallas kernels) against them, and the dispatch in
``ops.py`` runs them for tensors on the CPU.
"""

from __future__ import annotations

import torch


def region_aggregate_ref(grads, masks, memory):
    """Algorithm 1 lines 15–22 (see ``core.aggregation``).

    grads, memory: (N, D) f32; masks: (N, D) bool.
    Returns (global_grad (D,), new_memory (N, D))."""
    m = masks.to(grads.dtype)
    count = m.sum(dim=0)
    fresh = (grads * m).sum(dim=0) / torch.clamp_min(count, 1.0)
    stale = memory.sum(dim=0) / memory.shape[0]
    g = torch.where(count > 0, fresh, stale)
    new_memory = torch.where(masks, grads, memory)
    return g, new_memory


def ranl_update_ref(params, hdiag, grads, masks, memory, *, mu: float,
                    lr: float):
    """Fused aggregate + diagonal projected-Newton step.

    params, hdiag: (D,); grads/memory/masks: (N, D).
    Returns (new_params (D,), new_memory)."""
    g, new_memory = region_aggregate_ref(grads, masks, memory)
    h_mu = torch.clamp_min(hdiag, float(mu))
    new_params = params - float(lr) * g / h_mu
    return new_params, new_memory
