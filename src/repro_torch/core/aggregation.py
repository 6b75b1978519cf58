"""Server aggregation with gradient memory (Algorithm 1, lines 15–22).

Given per-worker pruned gradients G (N, d), coordinate masks Mx (N, d)
(region masks expanded to coordinates), and stored latest updates C (N, d):

  covered:    ∇F^{t,q} = mean over covering workers of fresh gradients
  uncovered:  ∇F^{t,q} = mean over ALL workers of stored C_i^{t,q}
  memory:     C_i^{t+1,q} = fresh if i covered q else C_i^{t,q}

``quorum_aggregate`` is the semi-synchronous variant: only on-time
workers (``hetero.cost.quorum_split``) aggregate fresh, and late workers
fold into later rounds with staleness-damped weight through a bounded
``(max_delay, d)`` late buffer that the round loop carries.  Every
function broadcasts over a leading seed axis (``(B, N, d)`` inputs).
"""

from __future__ import annotations

import torch

from ..kernels import ops, ref
from .masks import staleness_weights


def server_aggregate(grads, masks_x, memory, *, use_kernel: bool = False):
    """grads, memory: (..., N, d) f32; masks_x: (..., N, d) bool.
    Returns (global_grad (..., d), new_memory (..., N, d)).

    Plain torch by default (``kernels.ref.region_aggregate_ref``);
    ``use_kernel=True`` routes to the ``region_aggregate`` kernel dispatch
    (the hand-written kernel for a CUDA tensor, its plain twin for a CPU
    tensor)."""
    if use_kernel:
        return ops.region_aggregate(grads, masks_x, memory)
    return ref.region_aggregate_ref(grads, masks_x, memory)


def late_fold_updates(grads, masks_x, count_full, delays, *, gamma: float,
                      max_delay: int):
    """Per-slot damped contributions of this round's LATE work.

    ``count_full``: (..., d) coverage counts, on-time and late: late
    arrivals divide by the denominator the on-time partial mean used, so
    at gamma = 1 the two together give the synchronous mean.  Returns
    (..., max_delay, d): row j lands in round t + j + 1's aggregate."""
    m = masks_x.to(grads.dtype)
    denom = torch.clamp_min(count_full, 1.0)
    w = staleness_weights(delays, gamma, max_delay)            # (..., N)
    contrib = grads * m * w[..., None] / denom[..., None, :]   # (..., N, d)
    slots = torch.arange(1, int(max_delay) + 1, device=grads.device)
    sel = (delays[..., None, :] == slots[:, None]).to(grads.dtype)
    return sel @ contrib                                       # (..., S, d)


def _shift_in(late_buf, adds):
    """Drop the slot due now, append an empty one, add this round's
    scheduled arrivals."""
    return torch.cat([late_buf[..., 1:, :],
                      torch.zeros_like(late_buf[..., :1, :])],
                     dim=-2) + adds


def quorum_aggregate(grads, masks_x, memory, on_time, delays, late_buf, *,
                     gamma: float, max_delay: int):
    """Semi-synchronous aggregation with a bounded-delay late fold.

    ``on_time``: (..., N) bool; ``delays``: (..., N) int rounds late;
    ``late_buf``: (..., max_delay, d), row 0 due now.  Returns
    (global_grad, new_memory, new_late_buf).  Covered coordinates (at
    least one on-time coverer) take the on-time partial sum over the full
    coverage count; the others fall back on the memory mean; row 0 of the
    buffer adds in.  Arrivals more than ``max_delay`` late are dropped and
    do not refresh the memory.  With every participant on time this is
    ``server_aggregate`` bit for bit."""
    m = masks_x.to(grads.dtype)
    on = on_time.to(grads.dtype)[..., None]
    count_full = m.sum(dim=-2)
    count_on = (m * on).sum(dim=-2)
    fresh_mean = (grads * m * on).sum(dim=-2) \
        / torch.clamp_min(count_full, 1.0)
    stale_mean = memory.sum(dim=-2) / memory.shape[-2]
    global_grad = torch.where(count_on > 0, fresh_mean, stale_mean) \
        + late_buf[..., 0, :]
    adds = late_fold_updates(grads, masks_x, count_full, delays,
                             gamma=gamma, max_delay=max_delay)
    dropped = delays > int(max_delay)
    new_memory = torch.where(masks_x & ~dropped[..., None], grads, memory)
    return global_grad, new_memory, _shift_in(late_buf, adds)
