"""Dispatch by device: a CUDA tensor launches the hand-written kernel (or
the wrapper raises), a CPU tensor takes the plain version.  Nothing falls
back from one to the other.

flash_attention, rwkv_wkv and grouped_matmul carry gradients.  When grad
mode is on and an input requires grad, the call goes through a
``torch.autograd.Function`` (``_FlashAttention``, ``_RwkvWkv``,
``_GroupedMatmul``): its forward is the kernel (or, on the
CPU, the plain forward, recording no graph) and its backward the
hand-written backward kernel (or the plain backward), from the saved
inputs (and K3's output).  Otherwise the forward runs with no autograd
bookkeeping."""

from __future__ import annotations

import torch

from . import chol_update as _chol
from . import flash_attention as _fa
from . import grouped_matmul as _gmm
from . import masked_aggregate as _ma
from . import newton_step as _ns
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


def masked_aggregate(G, mask, C):
    """G (N, *leaf); mask (N,) bool; C the stored memory, (N, *leaf) in
    its own type -> (g shaped like the leaf, C_new in C's type).  The
    kernel takes G in f32 and C in bf16, f16 or f32."""
    if _on_cpu(G):
        return ref.masked_aggregate_ref(G, mask, C)
    return _ma.masked_aggregate(G, mask, C)



def newton_step(ps, gs, hs, *, lr, mu, mu_rel, trust, hsum=None, pn2=None,
                between=None):
    """RANL's diagonal Newton step over groups of leaves (a per-layer leaf
    of every layer that holds it, or one glue leaf) -> (the new leaves as
    groups, stats (G, 4): floor, ‖Δ‖², ‖p‖², ‖g‖² a group); arguments as
    ``ref.newton_step_ref``.  The kernels take f32 leaves."""
    if _on_cpu(ps[0][0]):
        return ref.newton_step_ref(ps, gs, hs, lr=lr, mu=mu, mu_rel=mu_rel,
                                   trust=trust, hsum=hsum, pn2=pn2,
                                   between=between)
    return _ns.newton_step(ps, gs, hs, lr=lr, mu=mu, mu_rel=mu_rel,
                           trust=trust, hsum=hsum, pn2=pn2, between=between)

def _wants_grad(*inputs) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in inputs)


def _attention_fwd(q, k, v, causal, window, return_lse=False):
    fwd = ref.flash_attention_ref if _on_cpu(q) else _fa.flash_attention
    return fwd(q, k, v, causal=causal, window=window, return_lse=return_lse)


class _FlashAttention(torch.autograd.Function):
    """Saves the inputs, the output and each row's log-sum-exp, so the
    backward needs only D = rowsum(dO ⊙ O) besides its products."""
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _attention_fwd(q, k, v, causal, window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (ref.flash_attention_bwd_ref if _on_cpu(q)
               else _fa.flash_attention_bwd)
        grads = bwd(q, k, v, out, do, causal=ctx.causal, window=ctx.window,
                    lse=lse)
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


class _GroupedMatmul(torch.autograd.Function):
    """Saves x, w and the offsets; the backward is the dx product and the
    weights' product, each one launch on the card."""
    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w, offsets)
        if _on_cpu(x):
            return ref.grouped_matmul_ref(x, w, offsets)
        return _gmm.grouped_matmul(x, w, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, w, offsets = ctx.saved_tensors
        cpu = _on_cpu(x)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (ref.grouped_matmul_ref(dy, w.transpose(1, 2), offsets)
                  if cpu else _gmm.grouped_matmul_dx(dy, w, offsets))
        if ctx.needs_input_grad[1]:
            dw = (ref.grouped_matmul_wgrad_ref(x, dy, offsets, w.shape[0])
                  if cpu else _gmm.grouped_matmul_wgrad(x, dy, offsets,
                                                        w.shape[0]))
        return dx, dw, None


def grouped_matmul(x, w, offsets):
    """x (M, K), w (G, K, N), offsets (G+1,) int32 on x's device -> y
    (M, N): rows [offsets[g], offsets[g+1]) of y are those rows of x
    times w[g], a row outside every group 0 (``ref.grouped_matmul_ref``).
    The kernel takes f32."""
    if _wants_grad(x, w):
        return _GroupedMatmul.apply(x, w, offsets)
    if _on_cpu(x):
        return ref.grouped_matmul_ref(x, w, offsets)
    return _gmm.grouped_matmul(x, w, offsets)
