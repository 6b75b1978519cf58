"""Dispatch by device: a CUDA tensor launches the hand-written kernel (or
the wrapper raises), a CPU tensor takes the plain version.  Nothing falls
back from one to the other.

No kernel has a backward of its own, as no Pallas kernel had one.  Where
a gradient is wanted through flash_attention or rwkv_wkv, the kernel
runs forward and the backward is the plain twin's vector-Jacobian
product at the same inputs (``with_twin_grad``)."""

from __future__ import annotations

import torch

from . import chol_update as _chol
from . import flash_attention as _fa
from . import ref
from . import region_aggregate as _k
from . import rwkv_wkv as _wkv


class _TwinGrad(torch.autograd.Function):
    """Forward: ``fn(*inputs, **kwargs)``; backward: the VJP of
    ``twin(*inputs, **kwargs)``, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, fn, twin, kwargs, *inputs):
        ctx.twin, ctx.kwargs = twin, kwargs
        ctx.save_for_backward(*inputs)
        return fn(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.twin(*leaves, **ctx.kwargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            wrt = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True))
        return (None, None, None,
                *(next(got) if n else None for n in need))


def with_twin_grad(fn, twin, *inputs, **kwargs):
    """``fn(*inputs, **kwargs)``, differentiable as ``twin`` is: when
    grad mode is on and an input requires grad, the backward recomputes
    ``twin`` at the inputs and returns its vector-Jacobian product;
    otherwise ``fn`` runs with no autograd bookkeeping."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _TwinGrad.apply(fn, twin, kwargs, *inputs)
    return fn(*inputs, **kwargs)


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def region_aggregate(grads, masks, memory):
    if _on_cpu(grads):
        return ref.region_aggregate_ref(grads, masks, memory)
    return _k.region_aggregate(grads, masks, memory)


def ranl_update(params, hdiag, grads, masks, memory, *, mu: float,
                lr: float = 1.0):
    if _on_cpu(grads):
        return ref.ranl_update_ref(params, hdiag, grads, masks, memory,
                                   mu=mu, lr=lr)
    return _k.ranl_update(params, hdiag, grads, masks, memory, mu=mu, lr=lr)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd) in q.dtype."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return with_twin_grad(_fa.flash_attention, ref.flash_attention_ref,
                          q, k, v, causal=causal, window=window)


def rwkv_wkv(r, k, v, w, u, state):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) f32
    -> (y (B, S, H, hd) f32, final state)."""
    if _on_cpu(r):
        return ref.rwkv_wkv_ref(r, k, v, w, u, state)
    return with_twin_grad(_wkv.rwkv_wkv, ref.rwkv_wkv_ref, r, k, v, w, u,
                          state)


def chol_update(L, V, alpha):
    """L (n, n) lower factor; V (r, n); alpha (r,) -> the lower factor of
    L Lᵀ + Σⱼ alpha[j] V[j] V[j]ᵀ, in L's layout (the kernel takes L
    column-major)."""
    if _on_cpu(L):
        return ref.chol_update_ref(L, V, alpha)
    return _chol.chol_update(L, V, alpha)
