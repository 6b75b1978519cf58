"""Dispatch by device: a CUDA tensor launches the hand-written kernel (or
the wrapper raises), a CPU tensor takes the plain version.  Nothing falls
back from one to the other.

flash_attention and rwkv_wkv carry gradients.  When grad mode is on and
an input requires grad, the call goes through a ``torch.autograd.Function``
(``_FlashAttention``, ``_RwkvWkv``): its forward is the kernel (or, on the
CPU, the plain forward, recording no graph) and its backward the
hand-written backward kernel (or the plain backward), from the saved
inputs (and K3's output).  Otherwise the forward runs with no autograd
bookkeeping."""

from __future__ import annotations

import torch

from . import chol_update as _chol
from . import flash_attention as _fa
from . import ref
from . import region_aggregate as _k
from . import rwkv_wkv as _wkv


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


def _wants_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def _attention_fwd(q, k, v, causal, window):
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out = _attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        bwd = (ref.flash_attention_bwd_ref if _on_cpu(q)
               else _fa.flash_attention_bwd)
        grads = bwd(q, k, v, out, do, causal=ctx.causal, window=ctx.window)
        return (*(g if n else None
                  for g, n in zip(grads, ctx.needs_input_grad)), None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd) in q.dtype."""
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window)
    return _attention_fwd(q, k, v, causal, window)


def _wkv_fwd(*inputs):
    if _on_cpu(inputs[0]):
        return ref.rwkv_wkv_ref(*inputs)
    return _wkv.rwkv_wkv(*inputs)


class _RwkvWkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return _wkv_fwd(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, ds):
        inputs = ctx.saved_tensors
        bwd = (ref.rwkv_wkv_bwd_ref if _on_cpu(inputs[0])
               else _wkv.rwkv_wkv_bwd)
        grads = bwd(*inputs, dy, ds)
        return tuple(g if n else None
                     for g, n in zip(grads, ctx.needs_input_grad))


def rwkv_wkv(r, k, v, w, u, state):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) f32
    -> (y (B, S, H, hd) f32, final state)."""
    if _wants_grad(r, k, v, w, u, state):
        return _RwkvWkv.apply(r, k, v, w, u, state)
    return _wkv_fwd(r, k, v, w, u, state)


def chol_update(L, V, alpha):
    """L (n, n) lower factor; V (r, n); alpha (r,) -> the lower factor of
    L Lᵀ + Σⱼ alpha[j] V[j] V[j]ᵀ, in L's layout (the kernel takes L
    column-major)."""
    if _on_cpu(L):
        return ref.chol_update_ref(L, V, alpha)
    return _chol.chol_update(L, V, alpha)
