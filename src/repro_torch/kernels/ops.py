"""Dispatch by device: a CUDA tensor launches the hand-written kernel (or
the wrapper raises), a CPU tensor takes the plain version.  Nothing falls
back from one to the other."""

from __future__ import annotations

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd) in q.dtype."""
    if _on_cpu(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def rwkv_wkv(r, k, v, w, u, state):
    """r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) f32
    -> (y (B, S, H, hd) f32, final state)."""
    if _on_cpu(r):
        return ref.rwkv_wkv_ref(r, k, v, w, u, state)
    return _wkv.rwkv_wkv(r, k, v, w, u, state)
