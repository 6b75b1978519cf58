"""Plain PyTorch versions of the hand-written kernels.

They define what each kernel computes: the tests hold the kernels (and
the reference's Pallas kernels) against them, and the dispatch in
``ops.py`` runs them for tensors on the CPU.
"""

from __future__ import annotations

import torch


def region_aggregate_ref(grads, masks, memory):
    """Algorithm 1 lines 15–22 (see ``core.aggregation``).

    grads, memory: (N, D) f32, or (B, N, D) for B seeds; masks: bool, the
    same shape.  Returns (global_grad (D,) or (B, D), new_memory)."""
    m = masks.to(grads.dtype)
    count = m.sum(dim=-2)
    fresh = (grads * m).sum(dim=-2) / torch.clamp_min(count, 1.0)
    stale = memory.sum(dim=-2) / memory.shape[-2]
    g = torch.where(count > 0, fresh, stale)
    new_memory = torch.where(masks, grads, memory)
    return g, new_memory


def ranl_update_ref(params, hdiag, grads, masks, memory, *, mu: float,
                    lr: float):
    """Fused aggregate + diagonal projected-Newton step.

    params, hdiag: (D,) with grads/memory/masks (N, D), or (B, D) with
    (B, N, D).  Returns (new_params, new_memory)."""
    g, new_memory = region_aggregate_ref(grads, masks, memory)
    h_mu = torch.clamp_min(hdiag, float(mu))
    new_params = params - float(lr) * g / h_mu
    return new_params, new_memory


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """Full-softmax attention: the plain version of ``flash_attention``.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0.
    Sliding ``window`` (0 = unbounded) measured in absolute positions,
    q positions = arange(Skv - Sq, Skv) (suffix alignment), k = arange(Skv).
    Returns (B, Sq, H, hd) in q.dtype."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    groups = H // KV
    scale = hd ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(groups, dim=2).float()
    vr = v.repeat_interleave(groups, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    qpos = torch.arange(Skv - Sq, Skv, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    s = torch.where(valid[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    return out.to(q.dtype)


def rwkv_wkv_ref(r, k, v, w, u, state):
    """RWKV-6 wkv recurrence, a sequential loop over time: the plain
    version of ``rwkv_wkv``.

        y_t = r_t · (S + u ⊙ k_t v_tᵀ),   S ← diag(w_t) S + k_t v_tᵀ

    r, k, v, w: (B, S, H, hd); u: (H, hd); state: (B, H, hd, hd) f32.
    Returns (y (B, S, H, hd) f32, final state)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    u = u.float()[None, :, :, None]
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, hd, hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], S + u * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def chol_rank1_update(L, u, alpha):
    """Lower Cholesky factor of ``L Lᵀ + alpha u uᵀ`` (alpha clamped at 0),
    O(d²): the rotation sweep over columns, one column a step, as the
    reference's ``lax.scan`` (``repro/core/compression.py``)."""
    L = L.clone()
    n = L.shape[0]
    w = torch.sqrt(torch.clamp_min(torch.as_tensor(
        alpha, dtype=L.dtype, device=L.device), 0.0)) * u
    for k in range(n):
        lkk, wk = L[k, k], w[k]
        r = torch.sqrt(lkk * lkk + wk * wk)
        c = r / lkk
        s = wk / lkk
        col = (L[k + 1:, k] + s * w[k + 1:]) / c
        w[k + 1:] = c * w[k + 1:] - s * col
        L[k + 1:, k] = col
        L[k, k] = r
    return L


def chol_update_ref(L, V, alpha):
    """Lower Cholesky factor of ``L Lᵀ + Σⱼ alpha_j v_j v_jᵀ``: the plain
    version of ``chol_update``, one rank-1 sweep per row of ``V`` (r, n)
    in order.  L (n, n) in any layout; the result keeps L's."""
    for j in range(V.shape[0]):
        L = chol_rank1_update(L, V[j], alpha[j])
    return L
