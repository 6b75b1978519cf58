"""Server aggregation with gradient memory (Algorithm 1, lines 15–22).

Given per-worker pruned gradients G (N, d), coordinate masks Mx (N, d)
(region masks expanded to coordinates), and stored latest updates C (N, d):

  covered:    ∇F^{t,q} = mean over covering workers of fresh gradients
  uncovered:  ∇F^{t,q} = mean over ALL workers of stored C_i^{t,q}
  memory:     C_i^{t+1,q} = fresh if i covered q else C_i^{t,q}

The quorum aggregation arrives with ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

from ..kernels import ops, ref


def server_aggregate(grads, masks_x, memory, *, use_kernel: bool = False):
    """grads, memory: (N, d) f32; masks_x: (N, d) bool.
    Returns (global_grad (d,), new_memory (N, d)).

    Plain torch by default (``kernels.ref.region_aggregate_ref``);
    ``use_kernel=True`` routes to the ``region_aggregate`` kernel dispatch
    (the hand-written kernel for a CUDA tensor, its plain twin for a CPU
    tensor)."""
    if use_kernel:
        return ops.region_aggregate(grads, masks_x, memory)
    return ref.region_aggregate_ref(grads, masks_x, memory)
